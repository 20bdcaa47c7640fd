"""Shared setup of the checkpoint-variant tests
(``tests/test_torch_port_variants.py``: FreeU, the skeleton-latent UNet,
Euler, the refusals and the diffusers directories;
``tests/test_torch_port_variants_dpm.py``: DPM++ through the grid and the
grid state).

fp32 on the CPU, the JAX package's tiny weights of the skeleton-latent UNet
carried into the port, one synthetic scene (6 cameras x 4 frames at 64^2,
inputs [0, 3]). Cross-package runs draw the JAX package's noise: grid
noise, pixel posterior noise per frame and the skeleton posterior noise,
which the JAX package splits from each task's key. Each task's skeleton
latents are held to the JAX package's, and the sampling then goes on from
the JAX package's: its fp32 VAE encoder is 3e-4 off a float64 run of the
same weights on the synthetic scene's skeletons (near-constant images, on
which flax's one-pass GroupNorm variance rounds), the port's 2e-5, and a
few CFG steps of the random tiny UNet would carry that gap past the slice
test's bound."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    TINY_UNET,
    TINY_VAE,
    jax_unet,
    jax_vae,
    n,
    port_unet,
    port_vae,
)

IMAGE = 64
LATENT = IMAGE // 8
VAE_BATCH = 4
# the reference UNet's other configuration: conv_in takes latents 4 +
# Plücker 6 + skeleton latent 4 + cond mask 1
SKEL_UNET = dict(TINY_UNET, in_channels=15, enable_pose_encoder=False)
SCENE = dict(num_cams=6, num_frames=4, image_size=IMAGE)
GRID = dict(spa_label_range=(0, 6, 1), tem_label_range=(0, 4, 1), input_spa_labels=[0, 3])
# demo_4d's alternation at the tiny grid: a spatial round, then a temporal
# one with split CFG
TWO_ROUNDS = dict(window_size=2, sliding_stride=2, alternation_rounds=2, guidance_scale=2.0,
                  split_cfg_domains=("temporal",))
# one demo_3d task: frame 0, window 2 at stride 1
ONE_TASK = dict(spa_label_range=(0, 6, 1), tem_label_range=(0, 1, 1), input_spa_labels=[0, 3])
# the slice test's bound: fp32 on both sides, summation order only
LATENT_ATOL = 2e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from diffuman4d_tpu.data.dataset import SpaTemDataset as JDataset
    from diffuman4d_tpu.data.synthetic import make_synthetic_scene
    from diffuman4d_tpu.io import native as jnative

    root = tmp_path_factory.mktemp("variants")
    make_synthetic_scene(str(root / "data"), "scene0", **SCENE)
    jnative.available()  # settles its decoder lookup before any threaded load
    jmod, jparams = jax_unet(SKEL_UNET)
    vmod, vparams = jax_vae(TINY_VAE)
    return SimpleNamespace(
        root=root, jmod=jmod, jparams=jparams, vmod=vmod, vparams=vparams,
        unet=port_unet(SKEL_UNET, jparams), vae=port_vae(TINY_VAE, vparams),
        jdataset=JDataset(data_dir=str(root / "data"), scene_label="scene0", height=IMAGE,
                          width=IMAGE),
        # one load per task, shared by every run (the JAX dataset's first
        # load in a process is not bit-stable, tests/test_torch_port_slice.py)
        samples={},
        # the JAX task key and skeleton latents of each task's rows,
        # recorded by the JAX runs
        task_keys={}, skeleton_latents={})


def _jpipe(env, kind: str, sliding: dict, **sched):
    from diffuman4d_tpu.sampling import pipeline as jp
    from diffuman4d_tpu.schedulers import diffusion as jd

    pipe = jp.Diffuman4DPipeline(
        env.jmod, env.vmod, jd.Scheduler(jd.SchedulerConfig(kind=kind, **sched)),
        {"unet": env.jparams, "vae": env.vparams}, sliding=jp.SlidingConfig(**sliding),
        image_size=IMAGE, vae_batch=VAE_BATCH)
    prepare = pipe.prepare_conditions

    def recording(sample, key, *a, **k):
        env.task_keys[tuple(sample.labels)] = key
        cond = prepare(sample, key, *a, **k)
        if "skeleton_latents" in cond:
            env.skeleton_latents[tuple(sample.labels)] = np.array(cond["skeleton_latents"])
        return cond

    pipe.prepare_conditions = recording
    return pipe


def _jax_skeleton_noise(key, rows: int) -> torch.Tensor:
    """The JAX package's skeleton posterior draw for a task: ``k_sk`` is the
    second split of the task key, split again per VAE micro-batch, and each
    micro-batch draws for its padded rows."""
    _, rest = jax.random.split(key)
    k_sk, _ = jax.random.split(rest)
    keys = jax.random.split(k_sk, -(-rows // VAE_BATCH))
    draws = [np.array(jax.random.normal(k, (VAE_BATCH, LATENT, LATENT, 4), jnp.float32))
             for k in keys]
    return torch.from_numpy(np.concatenate(draws)[:rows])


def _ppipe(env, jpipe, kind: str, sliding: dict, unet=None, **sched):
    """The port's pipeline with the JAX package's noise."""
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.schedulers import diffusion as pd

    pipe = pp.Diffuman4DPipeline(unet or env.unet, env.vae,
                                 pd.Scheduler(pd.SchedulerConfig(kind=kind, **sched)),
                                 pp.SlidingConfig(**sliding), image_size=IMAGE,
                                 vae_batch=VAE_BATCH)
    pipe.init_noise = lambda spa, tem, seed: torch.from_numpy(
        np.array(jpipe.init_noise(spa, tem, seed)))
    pipe.posterior_noise = lambda labels: torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jpipe._frame_key(lb), (LATENT, LATENT, 4)))) for lb in labels])
    pipe.skeleton_noise = lambda labels: _jax_skeleton_noise(env.task_keys[tuple(labels)],
                                                             len(labels))
    prepare = pipe.prepare_conditions

    def jax_skeletons(sample):
        cond = prepare(sample)
        if "skeleton_latents" in cond:
            want = env.skeleton_latents[tuple(sample.labels)]
            np.testing.assert_allclose(n(cond["skeleton_latents"]), want, rtol=0,
                                       atol=LATENT_ATOL)
            cond["skeleton_latents"] = torch.from_numpy(want.copy())
        return cond

    pipe.prepare_conditions = jax_skeletons
    return pipe


def _shared_loads(env, sampler):
    load = sampler.load_sample
    sampler.load_sample = lambda task: env.samples.setdefault((task.domain, task.domain_label),
                                                              load(task))
    return sampler


def _jax(env, pipe, out, **kw):
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler

    return _shared_loads(env, JSampler(env.jdataset, pipe, output_dir=str(out),
                                       **{**GRID, **kw}))


def _port(env, pipe, out, **kw):
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

    dataset = SpaTemDataset(data_dir=str(env.root / "data"), scene_label="scene0",
                            height=IMAGE, width=IMAGE)
    return _shared_loads(env, SlidingIterativeSampler(dataset, pipe, output_dir=str(out),
                                                      **{**GRID, **kw}))


def _jpegs(root) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("images/*/*.jpg"))}
