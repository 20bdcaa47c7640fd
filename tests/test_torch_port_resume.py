"""Grid-state save and resume, run budgets and cache clears of the port's
sampler (modelled on ``tests/test_resume.py``), and state files crossing
between the two packages.

One tiny synthetic scene (6 cameras x 4 frames at 64^2, inputs [0, 3]),
window 2, stride 2, three alternation rounds (spatial, temporal, spatial;
CFG 2.0, split on the temporal domain), fp32 on the CPU, the JAX package's
tiny weights carried into the port. Every interrupted port run -- stopped
at a round end, within a round, on ``task_budget`` or on ``time_budget_s``,
or resumed from a legacy ``.npz`` -- must equal the uninterrupted one bit
for bit: grid latents, timestep indices and JPEG bytes. Across packages the
port resumes a JAX-written state and the JAX package a port-written one,
both with the JAX package's noise, within the slice test's tolerance."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import TINY_UNET, TINY_VAE, jax_unet, jax_vae, port_unet, port_vae

IMAGE = 64
LATENT = IMAGE // 8
SCENE = dict(num_cams=6, num_frames=4, image_size=IMAGE)
SAMPLER = dict(spa_label_range=(0, 6, 1), tem_label_range=(0, 4, 1), input_spa_labels=[0, 3])
SLIDING = dict(window_size=2, sliding_stride=2, alternation_rounds=3, guidance_scale=2.0,
               split_cfg_domains=("temporal",))
# the slice test's bound: fp32 on both sides, summation order only
LATENT_ATOL = 2e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from diffuman4d_tpu.data.dataset import SpaTemDataset as JDataset
    from diffuman4d_tpu.data.synthetic import make_synthetic_scene
    from diffuman4d_tpu.io import native as jnative
    from diffuman4d_tpu.sampling import pipeline as jp
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.schedulers import diffusion as pd

    root = tmp_path_factory.mktemp("resume")
    make_synthetic_scene(str(root / "data"), "scene0", **SCENE)
    jnative.available()  # settles its decoder lookup before any threaded load
    jmod, jparams = jax_unet(TINY_UNET)
    vmod, vparams = jax_vae(TINY_VAE)
    jpipe = jp.Diffuman4DPipeline(
        jmod, vmod, jd.Scheduler(jd.SchedulerConfig(kind="ddim")),
        {"unet": jparams, "vae": vparams}, sliding=jp.SlidingConfig(**SLIDING),
        image_size=IMAGE, vae_batch=4)
    pipe = pp.Diffuman4DPipeline(port_unet(TINY_UNET, jparams), port_vae(TINY_VAE, vparams),
                                 pd.Scheduler(pd.SchedulerConfig(kind="ddim")),
                                 pp.SlidingConfig(**SLIDING), image_size=IMAGE, vae_batch=4)
    # the JAX package's noise for the port (its own draws differ by design)
    jnoise = SimpleNamespace(
        init_noise=lambda spa, tem, seed: torch.from_numpy(
            np.array(jpipe.init_noise(spa, tem, seed))),
        posterior_noise=lambda labels: torch.stack([
            torch.from_numpy(np.array(jax.random.normal(
                jpipe._frame_key(lb), (LATENT, LATENT, 4)))) for lb in labels]))
    # the cross-package runs share one load per task (the JAX dataset's
    # first load in a process is not bit-stable, tests/test_torch_port_slice.py)
    jdataset = JDataset(data_dir=str(root / "data"), scene_label="scene0", height=IMAGE,
                        width=IMAGE)
    # the cross-package runs' port pipeline: the same modules, the JAX
    # posterior noise, caches of its own
    xpipe = pp.Diffuman4DPipeline(pipe.unet, pipe.vae,
                                  pd.Scheduler(pd.SchedulerConfig(kind="ddim")),
                                  pp.SlidingConfig(**SLIDING), image_size=IMAGE, vae_batch=4)
    xpipe.posterior_noise = jnoise.posterior_noise
    return SimpleNamespace(root=root, jpipe=jpipe, pipe=pipe, xpipe=xpipe, jnoise=jnoise,
                           jdataset=jdataset, samples={})


def _port(env, out, pipe=None, **kw):
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

    dataset = SpaTemDataset(data_dir=str(env.root / "data"), scene_label="scene0",
                            height=IMAGE, width=IMAGE)
    return SlidingIterativeSampler(dataset, pipe or env.pipe, output_dir=str(out),
                                   **{**SAMPLER, **kw})


def _shared_loads(env, sampler):
    load = sampler.load_sample
    sampler.load_sample = lambda task: env.samples.setdefault((task.domain, task.domain_label),
                                                              load(task))
    return sampler


def _jax(env, out, **kw):
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler

    return _shared_loads(env, JSampler(env.jdataset, env.jpipe, output_dir=str(out),
                                       **{**SAMPLER, **kw}))


@pytest.fixture(scope="module")
def ref(env):
    """The port's uninterrupted run."""
    s = _port(env, env.root / "ref")
    s.execute_tasks()
    return s


@pytest.fixture(scope="module")
def jref(env):
    """The JAX package's uninterrupted run."""
    s = _jax(env, env.root / "jref")
    s.execute_tasks()
    return s


def _jpegs(root) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("images/*/*.jpg"))}


def _assert_same_run(ref, got):
    assert torch.equal(got.grid_latents, ref.grid_latents)
    np.testing.assert_array_equal(got.grid_t_idx, ref.grid_t_idx)
    want = _jpegs(ref.output_dir)
    assert len(want) == 24  # 6 cameras x 4 frames
    assert _jpegs(got.output_dir) == want


def _meta(sampler) -> tuple[int, int]:
    from diffuman4d_torch.io.gridstate import read_state

    meta, _ = read_state(sampler._state_path)
    return meta["completed_rounds"], meta["tasks_done_in_round"]


def _run_tasks(sampler, n_rounds: int, n_tasks: int) -> None:
    """Rounds ``0..n_rounds-1`` and then ``n_tasks`` tasks of the next,
    task by task, then a state claiming exactly that."""
    for r in range(n_rounds):
        for task in sampler.all_tasks[r]:
            sampler.execute_one_task(task)
    for task in sampler.all_tasks[n_rounds][:n_tasks]:
        sampler.execute_one_task(task)
    sampler._completed_rounds = n_rounds
    sampler.save_state(tasks_done=n_tasks)


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


# ------------------------------------------------------------- across packages
def _port_jax_noise(env, out, **kw):
    """A port sampler on the cross-package pipeline, its grid noise drawn
    from the JAX keys, served the shared loads."""
    from diffuman4d_torch.sampling import pipeline as pp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp.Diffuman4DPipeline, "init_noise",
                   lambda self, spa, tem, seed: env.jnoise.init_noise(spa, tem, seed))
        return _shared_loads(env, _port(env, out, pipe=env.xpipe, **kw))


def _assert_close_to_jax(jref, got):
    np.testing.assert_array_equal(got.grid_t_idx, np.asarray(jref.grid_t_idx))
    np.testing.assert_allclose(np.asarray(got.grid_latents, np.float32),
                               np.asarray(jref.grid_latents), rtol=0, atol=LATENT_ATOL)
    names = lambda s: sorted(_jpegs(s.output_dir))  # noqa: E731
    assert names(got) == names(jref) and len(names(got)) == 24


def test_fresh_states_are_byte_equal_across_packages(env, tmp_path):
    port = _port_jax_noise(env, tmp_path / "port")
    jax_s = _jax(env, tmp_path / "jax")
    port.save_state(tasks_done=2)
    jax_s.save_state(tasks_done=2)
    assert Path(port._state_path).read_bytes() == Path(jax_s._state_path).read_bytes()


def test_jax_state_resumes_in_the_port(env, jref, tmp_path):
    jpart = _jax(env, tmp_path)
    for i, task in enumerate(jpart.all_tasks[0]):
        jpart.execute_one_task(task, jpart._task_key(0, i))
    jpart.execute_one_task(jpart.all_tasks[1][0], jpart._task_key(1, 0))
    jpart._completed_rounds = 1
    jpart.save_state(tasks_done=1)
    written = Path(jpart._state_path).read_bytes()
    del jpart
    port = _port_jax_noise(env, tmp_path)
    assert (port._completed_rounds, port._resume_tasks_done) == (1, 1)
    port.save_state(tasks_done=1)  # read and written back: the same bytes
    assert Path(port._state_path).read_bytes() == written
    port.execute_tasks()
    _assert_close_to_jax(jref, port)


def test_port_state_resumes_in_jax(env, jref, tmp_path):
    from diffuman4d_tpu.io.gridstate import read_state

    _run_tasks(_port_jax_noise(env, tmp_path), 1, 1)
    resumed = _jax(env, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 1)
    resumed.execute_tasks()
    _assert_close_to_jax(jref, resumed)
    meta, _ = read_state(resumed._state_path)
    assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == (3, 0)
