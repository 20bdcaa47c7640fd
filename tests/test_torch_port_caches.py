"""The port's condition caches and streamed pose features
(``diffuman4d_torch/sampling/pipeline.py``, ``utils/arrays.py``).

``ByteLRU`` is held to the JAX package's class on a seeded sequence of
operations. ``prepare_conditions`` with the caches on, off, warm and after
evictions, and ``sliding_denoise`` on streamed and on materialised pose
features, must agree bit for bit on the CPU (fp32, tiny widths, the JAX
package's tiny weights carried into the port). The port's streamed run of a
temporal task is held to the JAX package's streamed run within the slice
test's tolerance."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import TINY_UNET, TINY_VAE, jax_unet, jax_vae, port_unet, port_vae

IMAGE = 64
LATENT = IMAGE // 8
SCENE = dict(num_cams=6, num_frames=8, image_size=IMAGE)
SAMPLER = dict(spa_label_range=(0, 6, 1), tem_label_range=(0, 8, 1), input_spa_labels=[0, 3])
SLIDING = dict(window_size=2, sliding_stride=2, alternation_rounds=2, guidance_scale=2.0,
               split_cfg_domains=("temporal",))
# windows per chunk: a temporal task's 4 windows run as two chunks of 2
WINDOW_CHUNK = 3
LATENT_ATOL = 2e-4  # the slice test's bound: fp32, summation order only


def test_byte_lru_matches_the_jax_package():
    from diffuman4d_tpu.utils.arrays import ByteLRU as JLRU
    from diffuman4d_torch.utils.arrays import ByteLRU as PLRU

    r = np.random.default_rng(0)
    want, got = JLRU(1000), PLRU(1000)
    for step in range(2000):
        op, key = r.integers(0, 10), int(r.integers(0, 24))
        if op < 5:
            size = int(r.choice([50, 120, 300, 999, 1001]))
            want.put(key, (key, step), size)
            got.put(key, (key, step), size)
        elif op < 7:
            assert got.get(key) == want.get(key)
        elif op < 9:
            assert got.value(key) == want.value(key)
        elif r.random() < 0.05:
            want.clear()
            got.clear()
        assert (key in got) == (key in want)
        assert list(got._d.items()) == list(want._d.items()), step
        assert (got.nbytes, len(got)) == (want.nbytes, len(want))
        assert got.nbytes <= got.budget
    assert got.value(10**6) is None and got.get(10**6) is None


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_unet(TINY_UNET)
    vmod, vparams = jax_vae(TINY_VAE)
    return jmod, jparams, vmod, vparams, port_unet(TINY_UNET, jparams), port_vae(TINY_VAE, vparams)


@pytest.fixture(scope="module")
def samples(models, tmp_path_factory):
    """Two spatial tasks' and one temporal task's (task, sample, windows),
    loaded through the port's dataset."""
    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

    root = tmp_path_factory.mktemp("caches")
    make_synthetic_scene(str(root), "scene0", **SCENE)
    sampler = SlidingIterativeSampler(
        SpaTemDataset(data_dir=str(root), scene_label="scene0", height=IMAGE, width=IMAGE),
        _pipe(models), output_dir=str(root / "out"), **SAMPLER)
    out = {}
    tasks = {"spatial": sampler.all_tasks[0][0], "spatial_b": sampler.all_tasks[0][1],
             "temporal": sampler.all_tasks[1][0]}
    for name, task in tasks.items():
        sample = sampler.load_sample(task)
        out[name] = (task, sample, sampler._windows_for(task, len(sample.labels)))
    return out


def _pipe(models, **kw):
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.schedulers import diffusion as pd

    *_, unet, vae = models
    return pp.Diffuman4DPipeline(unet, vae, pd.Scheduler(pd.SchedulerConfig(kind="ddim")),
                                 pp.SlidingConfig(**SLIDING), image_size=IMAGE, vae_batch=4,
                                 window_chunk=WINDOW_CHUNK, **kw)


def _assert_conds_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert len(got[k]) == len(v) and all(torch.equal(a, b) for a, b in zip(got[k], v)), k
        else:
            assert torch.equal(got[k], v), k


def _row_bytes(pipe) -> dict[str, int]:
    return {"pix": LATENT * LATENT * 4 * 4, "skel": IMAGE * IMAGE * 3,
            "pose": pipe._pose_feature_bytes()}


def test_prepare_conditions_cached_uncached_warm_and_evicted_are_equal(models, samples):
    off = _pipe(models, cond_cache=False)
    on = _pipe(models)
    small = _pipe(models)
    rows = _row_bytes(small)
    # each cache holds fewer rows than two tasks need; the pose cache holds
    # the temporal task's 16 rows, so every task still materialises
    small._pix_cache.budget = 3 * rows["pix"]
    small._skel_cache.budget = 4 * rows["skel"]
    small._pose_cache.budget = 16 * rows["pose"]
    order = ["spatial", "spatial_b", "temporal", "spatial", "temporal", "spatial_b"]
    want = {name: off.prepare_conditions(samples[name][1]) for name in set(order)}
    assert {k for k in want["spatial"]} >= {"pose_features", "pix_latents"}
    seen = set()
    for name in order:
        sample = samples[name][1]
        hits = len(on._pix_cache)
        _assert_conds_equal(on.prepare_conditions(sample), want[name])
        if name in seen:  # warm: every conditional row and pose row was a hit
            assert len(on._pix_cache) == hits
        _assert_conds_equal(small.prepare_conditions(sample), want[name])
        for cache in (small._pix_cache, small._skel_cache, small._pose_cache):
            assert 0 < cache.nbytes <= cache.budget
        seen.add(name)
    labels = {lb for name in order for lb in samples[name][1].labels}
    assert len(labels) == 6 + 6 + 16 - 4  # the temporal task shares 2 rows with each frame
    assert len(on._pose_cache) == len(labels) and len(small._pose_cache) == 16
    # the parts of a warm-cache task: a subset cached first, the rest computed
    # in other micro-batches
    sample = samples["temporal"][1]
    cond_rows = list(np.nonzero(sample.cond_masks == 0.0)[0])
    mixed = _pipe(models)
    with torch.no_grad():
        mixed._cond_latents_cached(sample, cond_rows[1::3])
        assert torch.equal(mixed._cond_latents_cached(sample, cond_rows),
                           want["temporal"]["pix_latents"][cond_rows])
    on.clear_condition_caches()
    assert len(on._pix_cache) == len(on._skel_cache) == len(on._pose_cache) == 0
    assert on._neg_pose is None


@pytest.mark.parametrize("name", ["spatial", "temporal"])
def test_streamed_and_materialised_sliding_denoise_are_equal(models, samples, name):
    task, sample, windows = samples[name]
    mat = _pipe(models)
    streamed = _pipe(models, pose_cache_mb=0)  # every task streams
    streamed_off = _pipe(models, pose_cache_mb=0, cond_cache=False)
    cond = mat.prepare_conditions(sample)
    assert "pose_features" in cond and "skel_rows" not in cond
    r = np.random.default_rng(3)
    n = len(sample.labels)
    latents = torch.from_numpy(r.standard_normal((n, LATENT, LATENT, 4), np.float32))
    t_idx = np.zeros(n, np.int32)
    want = mat.sliding_denoise(cond, latents, t_idx, windows, task.domain)
    c = mat._window_chunk_size(len(windows))
    assert len(windows) // c == {"spatial": 1, "temporal": 2}[name]  # chunks of the task
    for pipe in (streamed, streamed_off):
        scond = pipe.prepare_conditions(sample)
        assert "skel_rows" in scond and "pose_features" not in scond
        assert len(scond["skel_rows"]) == n and scond["skel_rows"][0].dtype == torch.uint8
        got = pipe.sliding_denoise(scond, latents, t_idx, windows, task.domain)
        assert torch.equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # each chunk's pose features are the materialised rows of its row union,
    # also where the union is padded (by repeating its last row)
    pad_u = streamed._chunk_pad_u(windows, c)
    for pad in (pad_u, pad_u + 3):
        for i in range(0, len(windows), c):
            with torch.no_grad():
                chunk, wc = streamed._chunk_cond(scond, windows[i : i + c], pad)
            U, _ = streamed._chunk_rows(windows[i : i + c], pad)
            assert chunk["pose_features"].shape[0] == len(U) == pad
            assert torch.equal(chunk["pose_features"],
                               cond["pose_features"][torch.from_numpy(U.astype(np.int64))])
            np.testing.assert_array_equal(U[wc], windows[i : i + c])


def test_streamed_temporal_task_matches_jax(models, samples):
    """One temporal task with streamed pose features through both packages:
    the same sample, weights, latents and posterior noise."""
    from diffuman4d_tpu.sampling import pipeline as jp
    from diffuman4d_tpu.schedulers import diffusion as jd

    jmod, jparams, vmod, vparams, _, _ = models
    task, sample, windows = samples["temporal"]
    jpipe = jp.Diffuman4DPipeline(
        jmod, vmod, jd.Scheduler(jd.SchedulerConfig(kind="ddim")),
        {"unet": jparams, "vae": vparams}, sliding=jp.SlidingConfig(**SLIDING),
        image_size=IMAGE, vae_batch=4, window_chunk=WINDOW_CHUNK, pose_cache_mb=0)
    jcond = jpipe.prepare_conditions(sample, jax.random.PRNGKey(0))
    assert "skel_rows" in jcond
    pipe = _pipe(models, pose_cache_mb=0)
    pipe.posterior_noise = lambda labels: torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jpipe._frame_key(lb), (LATENT, LATENT, 4)))) for lb in labels])
    cond = pipe.prepare_conditions(sample)
    assert "skel_rows" in cond
    n = len(sample.labels)
    latents = np.random.default_rng(4).standard_normal((n, LATENT, LATENT, 4)).astype(np.float32)
    t_idx = np.zeros(n, np.int32)
    jlat, jt, _ = jpipe.sliding_denoise(jcond, jax.numpy.asarray(latents), t_idx, windows,
                                        task.domain)
    lat, t, _ = pipe.sliding_denoise(cond, torch.from_numpy(latents), t_idx, windows,
                                     task.domain)
    np.testing.assert_array_equal(t, np.asarray(jt))
    assert sorted(set(t.tolist())) == [0, pipe.sliding.steps_per_alt]
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=0, atol=LATENT_ATOL)
