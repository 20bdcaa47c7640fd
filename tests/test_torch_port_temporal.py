"""The temporal round held to the JAX package: two alternation rounds,
spatial then temporal, through the JAX package's ``SlidingIterativeSampler``
and the port's on the same synthetic scene, with the same weights (carried
through the port's weight carry) and the same noise (the JAX keys' draws
handed to the port). CFG is split on the temporal domain (the presets'
default) and the stride is 2 (``sliding_fast``, demo_4d's sampler preset).
fp32 on the CPU; the port's attention and conv run their plain versions."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import TINY_UNET, TINY_VAE, jax_unet, jax_vae, port_unet, port_vae

IMAGE = 64
LATENT = IMAGE // 8
SCENE = dict(num_cams=6, num_frames=4, image_size=IMAGE)
SAMPLER = dict(spa_label_range=(0, 6, 1), tem_label_range=(0, 4, 1), input_spa_labels=[0, 3])
SLIDING = dict(window_size=2, sliding_stride=2, alternation_rounds=2, guidance_scale=2.0,
               split_cfg_domains=("temporal",))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from diffuman4d_tpu.data.synthetic import make_synthetic_scene

    root = tmp_path_factory.mktemp("scene")
    make_synthetic_scene(str(root), "scene0", **SCENE)
    return str(root)


def _recording(pipe, sink: list):
    decode = pipe.decode
    pipe.decode = lambda latents: sink.append(np.asarray(decode(latents))) or sink[-1]


def test_spatial_then_temporal_rounds_match_jax(scene, tmp_path):
    from diffuman4d_tpu.data.dataset import SpaTemDataset
    from diffuman4d_tpu.sampling import pipeline as jp
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers import diffusion as pd

    jmod, jparams = jax_unet(TINY_UNET)
    vmod, vparams = jax_vae(TINY_VAE)

    def dataset():
        return SpaTemDataset(data_dir=scene, scene_label="scene0", height=IMAGE, width=IMAGE)

    jpipe = jp.Diffuman4DPipeline(
        jmod, vmod, jd.Scheduler(jd.SchedulerConfig(kind="ddim")),
        {"unet": jparams, "vae": vparams}, sliding=jp.SlidingConfig(**SLIDING),
        image_size=IMAGE, vae_batch=4)
    jimages: list = []
    _recording(jpipe, jimages)
    jsampler = JSampler(dataset(), jpipe, output_dir=str(tmp_path / "jax"), **SAMPLER)
    # the port is served the JAX run's loads (SpaTemDataset's loads are not
    # bit-stable within a process, tests/test_torch_port_slice.py)
    samples = {}
    load = jsampler.load_sample
    jsampler.load_sample = lambda task: samples.setdefault(
        (task.domain, task.domain_label), load(task))
    jsampler.execute_tasks()

    ppipe = pp.Diffuman4DPipeline(port_unet(TINY_UNET, jparams), port_vae(TINY_VAE, vparams),
                                  pd.Scheduler(pd.SchedulerConfig(kind="ddim")),
                                  pp.SlidingConfig(**SLIDING), image_size=IMAGE, vae_batch=4)
    ppipe.init_noise = lambda spa, tem, seed: torch.from_numpy(
        np.array(jpipe.init_noise(spa, tem, seed)))
    ppipe.posterior_noise = lambda labels: torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jpipe._frame_key(lb), (LATENT, LATENT, 4)))) for lb in labels])
    pimages: list = []
    _recording(ppipe, pimages)
    sampler = SlidingIterativeSampler(dataset(), ppipe, output_dir=str(tmp_path / "port"),
                                      **SAMPLER)
    tasks = []
    sampler.load_sample = lambda task: tasks.append(task) or samples[(task.domain,
                                                                      task.domain_label)]
    sampler.execute_tasks()

    # 4 spatial tasks (one per frame), then 4 temporal (one per target camera)
    assert [(tk.alt, tk.domain) for tk in tasks] == [(1, "spatial")] * 4 + [(2, "temporal")] * 4
    assert [tk.domain_label for tk in tasks[4:]] == ["01", "02", "04", "05"]
    np.testing.assert_array_equal(sampler.grid_t_idx, np.asarray(jsampler.grid_t_idx))
    steps = jpipe.sliding.total_steps
    assert steps > jpipe.sliding.steps_per_alt > 0
    assert sorted(set(sampler.grid_t_idx.ravel().tolist())) == [0, steps]
    # fp32 on both sides: summation order only, through two rounds of CFG
    # DDIM steps (as the one-round slice test's bound)
    np.testing.assert_allclose(sampler.grid_latents.numpy(), np.asarray(jsampler.grid_latents),
                               rtol=0, atol=2e-4)
    # only the temporal round finishes targets: 4 tasks x 4 frames decoded
    assert len(pimages) == len(jimages) == 4
    got, want = np.concatenate(pimages).astype(int), np.concatenate(jimages).astype(int)
    assert got.shape == want.shape == (16, IMAGE, IMAGE, 3)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got == want) > 0.99
    names = lambda root: sorted(p.relative_to(root).as_posix()  # noqa: E731
                                for p in root.rglob("images/*/*.jpg"))
    assert names(tmp_path / "port") == names(tmp_path / "jax")
    assert len(names(tmp_path / "port")) == 24
