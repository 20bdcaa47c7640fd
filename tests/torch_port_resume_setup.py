"""Shared setup of the grid-state tests of the port's sampler
(``tests/test_torch_port_resume.py``, within the port, and
``tests/test_torch_port_resume_jax.py``, across the two packages).

One tiny synthetic scene (6 cameras x 4 frames at 64^2, inputs [0, 3]),
window 2, stride 2, three alternation rounds (spatial, temporal, spatial;
CFG 2.0, split on the temporal domain), fp32 on the CPU, the JAX package's
tiny weights carried into the port."""

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


def _jpegs(root) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("images/*/*.jpg"))}


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
