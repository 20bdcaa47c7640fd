"""DPM-Solver++ (2M) through the port's window loop, grid and grid state,
against the JAX package: the skeleton-latent UNet's two-round run with the
per-latent history, budgeted runs resumed from ``.d4d`` and legacy ``.npz``
states bit for bit, the JAX sampler's history rule, state files crossing
between the packages, and streamed pose features against materialised
ones under DPM++. The setup is ``tests/torch_port_variants_setup.py``."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- an autouse fixture
from tests.torch_port_helpers import TINY_UNET, TINY_VAE
from tests.torch_port_variants_setup import (  # noqa: F401 -- env is a fixture
    IMAGE,
    LATENT,
    LATENT_ATOL,
    TWO_ROUNDS,
    _jax,
    _jpegs,
    _jpipe,
    _port,
    _ppipe,
    env,
)


# ------------------------------------------------- DPM++ through the grid
@pytest.fixture(scope="module")
def dpm(env):
    """The JAX DPM++ pipeline and the port's with its noise, and each
    package's uninterrupted two-round run of the skeleton-latent UNet."""
    jpipe = _jpipe(env, "dpm++", TWO_ROUNDS)
    jref = _jax(env, jpipe, env.root / "jref")
    jref.execute_tasks()
    ppipe = _ppipe(env, jpipe, "dpm++", TWO_ROUNDS)
    ref = _port(env, ppipe, env.root / "ref")
    ref.execute_tasks()
    return SimpleNamespace(jpipe=jpipe, ppipe=ppipe, jref=jref, ref=ref)


def _assert_history_marks_stepped_latents(sampler):
    has = sampler.grid_aux["has_prev"].numpy()
    np.testing.assert_array_equal(has, sampler.grid_t_idx > 0)
    assert sampler.grid_aux["prev_x0"].dtype == torch.float32 and has.dtype == bool


def _assert_close_to_jax(jref, got):
    np.testing.assert_array_equal(got.grid_t_idx, np.asarray(jref.grid_t_idx))
    np.testing.assert_allclose(got.grid_latents.numpy(), np.asarray(jref.grid_latents),
                               rtol=0, atol=LATENT_ATOL)
    np.testing.assert_array_equal(np.asarray(got.grid_aux["has_prev"]),
                                  np.asarray(jref.grid_aux["has_prev"]))
    np.testing.assert_allclose(np.asarray(got.grid_aux["prev_x0"]),
                               np.asarray(jref.grid_aux["prev_x0"]), rtol=0, atol=LATENT_ATOL)
    assert sorted(_jpegs(got.output_dir)) == sorted(_jpegs(jref.output_dir))
    assert len(_jpegs(got.output_dir)) == 24


def test_two_round_dpmpp_run_matches_jax(dpm):
    """Spatial then temporal, DPM++ (first order at a latent's first step,
    second order after), the skeleton-latent UNet: grid, history and files
    against the JAX package's."""
    steps = dpm.ref.pipeline.sliding.total_steps
    assert sorted(set(dpm.ref.grid_t_idx.ravel().tolist())) == [0, steps]
    _assert_history_marks_stepped_latents(dpm.ref)
    _assert_close_to_jax(dpm.jref, dpm.ref)


def _assert_same_run(ref, got):
    assert torch.equal(got.grid_latents, ref.grid_latents)
    np.testing.assert_array_equal(got.grid_t_idx, ref.grid_t_idx)
    for k in ("prev_x0", "has_prev"):
        assert torch.equal(got.grid_aux[k], ref.grid_aux[k]), k
    assert _jpegs(got.output_dir) == _jpegs(ref.output_dir)


@pytest.mark.parametrize("legacy", [False, True], ids=["d4d", "legacy_npz"])
def test_dpmpp_resume_equals_the_uninterrupted_run(env, dpm, tmp_path, legacy):
    """Stopped by ``task_budget`` within each round and resumed (from the
    ``.d4d`` state, or from a legacy ``.npz`` holding the same arrays):
    bit for bit the uninterrupted run, history included; at each stop the
    state's history is the grid's and marks exactly the stepped latents."""
    from diffuman4d_torch.io.gridstate import read_state
    from diffuman4d_torch.sampling.sampler import _to_host_bits

    for budget, at in ((3, (0, 3)), (3, (1, 2))):
        s = _port(env, dpm.ppipe, tmp_path, task_budget=budget)
        s.execute_tasks()
        meta, data = read_state(s._state_path)
        assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == at
        for k, v in s.grid_aux.items():
            np.testing.assert_array_equal(np.asarray(data[f"aux_{k}"]), _to_host_bits(v))
        _assert_history_marks_stepped_latents(s)
        if legacy:
            state = Path(s._state_path)
            arrays = {k: np.array(v) for k, v in data.items()}
            del data
            np.savez(state.with_suffix(".npz"), seed=np.int64(0),
                     completed_rounds=np.int64(at[0]), tasks_done_in_round=np.int64(at[1]),
                     **arrays)
            state.unlink()
    resumed = _port(env, dpm.ppipe, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 2)
    for k in ("prev_x0", "has_prev"):
        np.testing.assert_array_equal(resumed.grid_aux[k].numpy(), s.grid_aux[k].numpy())
    resumed.execute_tasks()
    _assert_same_run(dpm.ref, resumed)


def test_state_history_rule(env, dpm, tmp_path):
    """A grid without history resumes a DPM++ state and ignores its
    history; a DPM++ grid ignores a state without history and starts
    afresh (the JAX sampler's ``_restore_aux``)."""
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.schedulers import diffusion as pd

    ddim = pp.Diffuman4DPipeline(env.unet, env.vae, pd.Scheduler(pd.SchedulerConfig()),
                                 pp.SlidingConfig(**TWO_ROUNDS), image_size=IMAGE)
    s = _port(env, dpm.ppipe, tmp_path / "dpm")
    s._completed_rounds = 1
    s.save_state()
    plain = _port(env, ddim, tmp_path / "dpm")
    assert plain.grid_aux is None and plain._completed_rounds == 1
    d = _port(env, ddim, tmp_path / "ddim")
    d._completed_rounds = 1
    d.save_state()
    fresh = _port(env, dpm.ppipe, tmp_path / "ddim")
    assert fresh._completed_rounds == 0 and not fresh.grid_aux["has_prev"].any()


# ---------------------------------------------------- states across packages
def test_fresh_dpmpp_states_are_byte_equal_across_packages(env, dpm, tmp_path):
    port = _port(env, dpm.ppipe, tmp_path / "port")
    jax_s = _jax(env, dpm.jpipe, tmp_path / "jax")
    port.save_state(tasks_done=2)
    jax_s.save_state(tasks_done=2)
    assert Path(port._state_path).read_bytes() == Path(jax_s._state_path).read_bytes()


def test_jax_dpmpp_state_resumes_in_the_port(env, dpm, tmp_path):
    from diffuman4d_torch.io.gridstate import read_state

    jpart = _jax(env, dpm.jpipe, tmp_path)
    for i, task in enumerate(jpart.all_tasks[0]):
        jpart.execute_one_task(task, jpart._task_key(0, i))
    jpart.execute_one_task(jpart.all_tasks[1][0], jpart._task_key(1, 0))
    jpart._completed_rounds = 1
    jpart.save_state(tasks_done=1)
    written = Path(jpart._state_path).read_bytes()
    del jpart
    port = _port(env, dpm.ppipe, tmp_path)
    assert (port._completed_rounds, port._resume_tasks_done) == (1, 1)
    _, data = read_state(port._state_path)
    for k, v in port.grid_aux.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(data[f"aux_{k}"]))
    del data
    assert port.grid_aux["has_prev"].any()
    port.save_state(tasks_done=1)  # read and written back: the same bytes
    assert Path(port._state_path).read_bytes() == written
    port.execute_tasks()
    _assert_close_to_jax(dpm.jref, port)


def test_port_dpmpp_state_resumes_in_jax(env, dpm, tmp_path):
    part = _port(env, dpm.ppipe, tmp_path, task_budget=5)
    part.execute_tasks()
    resumed = _jax(env, dpm.jpipe, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 1)
    np.testing.assert_array_equal(np.asarray(resumed.grid_aux["prev_x0"]),
                                  part.grid_aux["prev_x0"].numpy())
    np.testing.assert_array_equal(np.asarray(resumed.grid_aux["has_prev"]),
                                  part.grid_aux["has_prev"].numpy())
    resumed.execute_tasks()
    np.testing.assert_array_equal(np.asarray(resumed.grid_t_idx), np.asarray(dpm.jref.grid_t_idx))
    np.testing.assert_allclose(np.asarray(resumed.grid_latents), np.asarray(dpm.jref.grid_latents),
                               rtol=0, atol=LATENT_ATOL)



# ---------------------------------------------------------------- streaming
def test_dpmpp_streamed_equals_materialised():
    """The pose-encoder UNet under DPM++: one temporal task with its pose
    features streamed per window chunk equals the materialised run, history
    included, bit for bit."""
    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler, Task
    from diffuman4d_torch.schedulers import diffusion as pd
    import tempfile

    unet, vae = build_models(UNetConfig(**TINY_UNET), VAEConfig(**TINY_VAE), device="cpu",
                             dtype=torch.float32, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_scene(tmp, "scene0", num_cams=6, num_frames=8, image_size=IMAGE)

        def pipe(**kw):
            return pp.Diffuman4DPipeline(unet, vae, pd.Scheduler(pd.SchedulerConfig(kind="dpm++")),
                                         pp.SlidingConfig(**TWO_ROUNDS), image_size=IMAGE,
                                         window_chunk=2, **kw)

        mat, streamed = pipe(), pipe(pose_cache_mb=0)
        sampler = SlidingIterativeSampler(
            SpaTemDataset(data_dir=tmp, scene_label="scene0", height=IMAGE, width=IMAGE), mat,
            output_dir=tmp + "/out", spa_label_range=(0, 6, 1), tem_label_range=(0, 8, 1),
            input_spa_labels=[0, 3])
        task = Task(2, "temporal", "01")
        sample = sampler.load_sample(task)
    windows = sampler._windows_for(task, len(sample.labels))
    nrows = len(sample.labels)
    r = np.random.default_rng(5)
    latents = torch.from_numpy(r.standard_normal((nrows, LATENT, LATENT, 4), np.float32))
    aux = {"prev_x0": torch.from_numpy(r.standard_normal((nrows, LATENT, LATENT, 4),
                                                         np.float32)),
           "has_prev": torch.from_numpy(np.arange(nrows) % 3 == 0)}
    t_idx = np.zeros(nrows, np.int32)
    t_idx[nrows // 2:] = 1
    cond = mat.prepare_conditions(sample)
    scond = streamed.prepare_conditions(sample)
    assert "pose_features" in cond and "skel_rows" in scond
    want = mat.sliding_denoise(cond, latents, t_idx, windows, "temporal", aux=aux)
    got = streamed.sliding_denoise(scond, latents, t_idx, windows, "temporal", aux=aux)
    assert len(windows) // mat._window_chunk_size(len(windows)) > 1
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for k in ("prev_x0", "has_prev"):
        assert torch.equal(got[2][k], want[2][k]), k
    # the targets were stepped: their history is now set; the inputs' stays
    assert bool(got[2]["has_prev"][nrows // 2:].all())
    assert torch.equal(got[2]["has_prev"][: nrows // 2], aux["has_prev"][: nrows // 2])
