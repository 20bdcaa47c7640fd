"""Grid-state save and resume, run budgets and cache clears of the port's
sampler (modelled on ``tests/test_resume.py``); the setup is
``tests/torch_port_resume_setup.py``, the state files crossing between the
two packages are ``tests/test_torch_port_resume_jax.py``.

Every interrupted port run -- stopped at a round end, within a round, on
``task_budget`` or on ``time_budget_s``, or resumed from a legacy ``.npz``
-- must equal the uninterrupted one bit for bit: grid latents, timestep
indices and JPEG bytes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- an autouse fixture
from tests.torch_port_resume_setup import (  # noqa: F401 -- env is a fixture
    IMAGE,
    SAMPLER,
    _jpegs,
    _meta,
    _port,
    _run_tasks,
    env,
)


@pytest.fixture(scope="module")
def ref(env):
    """The port's uninterrupted run."""
    s = _port(env, env.root / "ref")
    s.execute_tasks()
    return s


def _assert_same_run(ref, got):
    assert torch.equal(got.grid_latents, ref.grid_latents)
    np.testing.assert_array_equal(got.grid_t_idx, ref.grid_t_idx)
    want = _jpegs(ref.output_dir)
    assert len(want) == 24  # 6 cameras x 4 frames
    assert _jpegs(got.output_dir) == want


def test_uninterrupted_run_writes_a_final_state(ref):
    assert _meta(ref) == (3, 0)
    steps = ref.pipeline.sliding.total_steps
    assert sorted(set(ref.grid_t_idx.ravel().tolist())) == [0, steps]


def test_resume_after_round(env, ref, tmp_path):
    part = _port(env, tmp_path)
    _run_tasks(part, 1, 0)
    del part
    resumed = _port(env, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 0)
    resumed.execute_tasks()
    _assert_same_run(ref, resumed)


def test_mismatched_state_is_ignored(env, tmp_path):
    s = _port(env, tmp_path)
    s._completed_rounds = 1
    s.save_state(tasks_done=2)
    other_seed = _port(env, tmp_path, seed=99)
    assert (other_seed._completed_rounds, other_seed._resume_tasks_done) == (0, 0)
    fresh = _port(env, tmp_path / "fresh", seed=99)
    assert torch.equal(other_seed.grid_latents, fresh.grid_latents)
    other_shape = _port(env, tmp_path, tem_label_range=(0, 2, 1))
    assert (other_shape._completed_rounds, other_shape._resume_tasks_done) == (0, 0)
    assert _port(env, tmp_path)._completed_rounds == 1  # the state itself is intact


@pytest.mark.parametrize("rounds,tasks", [(0, 1), (1, 2)], ids=["spatial", "temporal"])
def test_intra_round_resume(env, ref, tmp_path, rounds, tasks):
    part = _port(env, tmp_path)
    _run_tasks(part, rounds, tasks)
    del part
    resumed = _port(env, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (rounds, tasks)
    resumed.execute_tasks()
    _assert_same_run(ref, resumed)


def test_task_budget_chain(env, ref, tmp_path):
    """A chain of budgeted calls: mid-round stops, a stop at a round end,
    then the rest of the schedule."""
    total = sum(len(r) for r in ref.all_tasks)
    assert total == 12
    runs, states = [], []
    for budget in (1, 2, 1, total):
        s = _port(env, tmp_path, task_budget=budget)
        s.execute_tasks()
        runs.append(s._tasks_run)
        states.append(_meta(s))
    assert runs == [1, 2, 1, 8]
    assert states == [(0, 1), (0, 3), (1, 0), (3, 0)]
    _assert_same_run(ref, s)


def test_time_budget_zero_stops_after_one_task(env, ref, tmp_path):
    s = _port(env, tmp_path, time_budget_s=0.0)
    s.execute_tasks()
    assert s._tasks_run == 1 and _meta(s) == (0, 1)
    s = _port(env, tmp_path)
    s.execute_tasks()
    _assert_same_run(ref, s)


def test_one_cache_clear_per_domain_switch(env, tmp_path, monkeypatch):
    calls = []
    clear = env.pipe.clear_condition_caches
    monkeypatch.setattr(env.pipe, "clear_condition_caches", lambda: (calls.append(1), clear()))
    _port(env, tmp_path / "full").execute_tasks()
    assert len(calls) == 2  # spatial -> temporal -> spatial
    calls.clear()
    s = _port(env, tmp_path / "part", task_budget=6)  # round 1 and 2 temporal tasks
    s.execute_tasks()
    assert len(calls) == 1
    calls.clear()
    _port(env, tmp_path / "part").execute_tasks()
    assert len(calls) == 1  # the temporal -> spatial switch only


def test_legacy_npz_state_resumes(env, ref, tmp_path):
    part = _port(env, tmp_path)
    part.execute_one_task(part.all_tasks[0][0])
    (tmp_path / "state").mkdir()
    np.savez(tmp_path / "state" / "grid_state.npz", latents=part.grid_latents.numpy(),
             t_idx=part.grid_t_idx, seed=np.int64(0), completed_rounds=np.int64(0),
             tasks_done_in_round=np.int64(1))
    del part
    resumed = _port(env, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (0, 1)
    resumed.execute_tasks()
    _assert_same_run(ref, resumed)
    assert _meta(resumed) == (3, 0)  # the next states are .d4d files


def test_crop_params_and_debug_grid_needs(env, tmp_path):
    """The sampler writes no crop parameters (the JAX sampler's
    ``save_crop_params`` is not ported: no entry point sets it) and takes
    no such option; ``save_debug_grids`` refuses a dataset without target
    pixels."""
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

    s = _port(env, tmp_path, task_budget=1)
    s.execute_tasks()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["images", "state"]
    with pytest.raises(TypeError, match="save_crop_params"):
        _port(env, tmp_path / "y", save_crop_params=True)
    no_targets = SpaTemDataset(data_dir=str(env.root / "data"), scene_label="scene0",
                               height=IMAGE, width=IMAGE, target_pixels=False)
    with pytest.raises(ValueError, match="target pixels"):
        SlidingIterativeSampler(no_targets, env.pipe, output_dir=str(tmp_path / "x"),
                                save_debug_grids=True, **SAMPLER)
