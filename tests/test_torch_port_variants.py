"""The checkpoint variants the port samples on one card, against the JAX
package: FreeU's filter, the skeleton-latent UNet (``enable_pose_encoder``
off: skeletons VAE-encoded into the UNet's input channels) with DDIM and
with Euler at fractional timesteps, the JAX package's refusal to sample
DDPM and DDIM with eta > 0 (kept), and diffusers directories naming each
scheduler class. DPM++ is ``tests/test_torch_port_variants_dpm.py``; the
setup both share is ``tests/torch_port_variants_setup.py``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- an autouse fixture
from tests.torch_port_helpers import j, n, randn, rng, t
from tests.torch_port_variants_setup import (  # noqa: F401 -- env is a fixture
    IMAGE,
    LATENT_ATOL,
    ONE_TASK,
    _jax,
    _jpegs,
    _jpipe,
    _port,
    _ppipe,
    env,
)


# ------------------------------------------------------------------- FreeU
@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (1, 5, 7, 4), (3, 16, 16, 8)])
def test_freeu_filter_and_scaling_match_jax(shape):
    from diffuman4d_tpu.models import freeu as jf
    from diffuman4d_torch.models import freeu as pf

    r = rng(sum(shape))
    hidden, skip = randn(r, *shape), randn(r, *shape[:3], shape[3] + 2)
    np.testing.assert_allclose(n(pf.fourier_filter(t(skip), 1, 0.2)),
                               np.asarray(jf.fourier_filter(j(skip), 1, 0.2)), rtol=0, atol=1e-5)
    assert tuple(pf.FreeUConfig()) == tuple(jf.FreeUConfig()) == (1.5, 1.6, 0.9, 0.2)
    cfg = pf.FreeUConfig(1.3, 1.4, 0.7, 0.3)
    for idx in (0, 1, 2):
        ph, ps = pf.apply_freeu(idx, t(hidden), t(skip), cfg)
        jh, js = jf.apply_freeu(idx, j(hidden), j(skip), jf.FreeUConfig(*cfg))
        np.testing.assert_array_equal(n(ph), np.asarray(jh))
        np.testing.assert_allclose(n(ps), np.asarray(js), rtol=0, atol=1e-5)
    bf16 = pf.fourier_filter(t(skip).bfloat16(), 1, 0.9)
    assert bf16.dtype == torch.bfloat16  # fp32 inside, the input's dtype out


# ------------------------------------------- the skeleton-latent UNet, Euler
@pytest.mark.parametrize("kind,sched,split", [
    ("ddim", {}, ()),
    ("euler", {"timestep_spacing": "linspace"}, ("spatial",)),
], ids=["ddim-fused_cfg", "euler_linspace-split_cfg"])
def test_skeleton_latent_task_matches_jax(env, tmp_path, kind, sched, split):
    """One demo_3d task of the skeleton-latent UNet: every row's skeleton
    VAE-encoded with the JAX package's posterior draw, the negative CFG half
    fed -1 skeleton latents (fused and split). Under Euler with linspace
    spacing the timesteps are fractional and reach the UNet unrounded."""
    # windows of 3 at stride 1: 3 steps a target, so linspace spacing puts
    # Euler's middle timestep at 499.5
    sliding = dict(window_size=3, sliding_stride=1, alternation_rounds=1, guidance_scale=2.0,
                   split_cfg_domains=split)
    jpipe = _jpipe(env, kind, sliding, **sched)
    jsampler = _jax(env, jpipe, tmp_path / "jax", **ONE_TASK)
    jsampler.execute_tasks()
    ppipe = _ppipe(env, jpipe, kind, sliding, **sched)
    if kind == "euler":
        assert ppipe.scheduler.init_noise_sigma > 1.0
        assert (ppipe.scheduler.timesteps != ppipe.scheduler.timesteps.round()).any()
    sampler = _port(env, ppipe, tmp_path / "port", **ONE_TASK)
    sampler.execute_tasks()
    np.testing.assert_array_equal(sampler.grid_t_idx, np.asarray(jsampler.grid_t_idx))
    assert sorted(set(sampler.grid_t_idx.ravel().tolist())) == [0, 3]
    np.testing.assert_allclose(sampler.grid_latents.numpy(), np.asarray(jsampler.grid_latents),
                               rtol=0, atol=LATENT_ATOL)
    assert sorted(_jpegs(tmp_path / "port")) == sorted(_jpegs(tmp_path / "jax"))


def test_skeleton_latents_match_jax_with_the_caches_on_and_off(env):
    """The conditions of one task: skeleton latents against the JAX
    package's with the same posterior draw, the same with the caches off,
    and the skeleton stream apart from the pixels' stream."""
    sliding = dict(window_size=2, alternation_rounds=1)
    jpipe = _jpipe(env, "ddim", sliding)
    sampler = _jax(env, jpipe, env.root / "cond", **ONE_TASK)
    task = sampler.all_tasks[0][0]
    sample = sampler.load_sample(task)
    key = jax.random.PRNGKey(7)
    jcond = jpipe.prepare_conditions(sample, key)
    assert "skeleton_latents" in jcond and "pose_features" not in jcond
    ppipe = _ppipe(env, jpipe, "ddim", sliding)
    port_conditions = type(ppipe).prepare_conditions  # the port's own values
    cond = port_conditions(ppipe, sample)
    np.testing.assert_allclose(n(cond["skeleton_latents"]), np.asarray(jcond["skeleton_latents"]),
                               rtol=0, atol=LATENT_ATOL)
    assert "pose_features" not in cond and "neg_pose_feature" not in cond
    # without the caches the rows go to the VAE as the dataset gives them
    # (fp32 here, not re-quantised to uint8), in both packages
    jpipe.cond_cache = ppipe.cond_cache = False
    want = np.asarray(jpipe.prepare_conditions(sample, key)["skeleton_latents"])
    np.testing.assert_allclose(n(port_conditions(ppipe, sample)["skeleton_latents"]), want,
                               rtol=0, atol=LATENT_ATOL)
    from diffuman4d_torch.sampling import pipeline as pp
    from diffuman4d_torch.schedulers import diffusion as pd

    own = pp.Diffuman4DPipeline(env.unet, env.vae, pd.Scheduler(pd.SchedulerConfig()),
                                pp.SlidingConfig(**sliding), image_size=IMAGE)
    labels = sample.labels[:2]
    assert not torch.equal(own.skeleton_noise(labels), own.posterior_noise(labels))
    assert torch.equal(own.skeleton_noise(labels), own.skeleton_noise(labels))


@pytest.mark.parametrize("kind,sched", [("ddpm", {}), ("ddim", {"ddim_eta": 0.5})],
                         ids=["ddpm", "ddim_eta"])
def test_noise_drawing_sampling_raises_in_both_packages(env, tmp_path, kind, sched):
    """The JAX window step hands the scheduler no key, so DDPM and DDIM with
    eta > 0 raise ``ValueError`` in its sampling; the port keeps that
    (``ROADMAP.md`` C)."""
    sliding = dict(window_size=2, alternation_rounds=1)
    jpipe = _jpipe(env, kind, sliding, **sched)
    with pytest.raises(ValueError, match="requires a key"):
        _jax(env, jpipe, tmp_path / "jax", **ONE_TASK).execute_tasks()
    ppipe = _ppipe(env, jpipe, kind, sliding, **sched)
    with pytest.raises(ValueError, match="requires a key"):
        _port(env, ppipe, tmp_path / "port", **ONE_TASK).execute_tasks()


@pytest.mark.parametrize("class_name,kind", [
    ("DDIMScheduler", "ddim"), ("EulerDiscreteScheduler", "euler"),
    ("DPMSolverMultistepScheduler", "dpm++"),
])
def test_skeleton_latent_checkpoint_loads_in_both_packages(env, tmp_path, class_name, kind):
    """A diffusers directory the port writes for the skeleton-latent UNet
    with a scheduler class loads in both packages with the same configs,
    and the port's CLI samples from it (DPM++ here, the two others
    through the tests above)."""
    import dataclasses

    from diffuman4d_tpu.io.checkpoints import load_hf_checkpoint as jload
    from diffuman4d_torch.io.checkpoints import save_hf_checkpoint
    from diffuman4d_torch.sampling import loader

    sched = {"_class_name": class_name, "beta_schedule": "scaled_linear",
             "beta_start": 0.00085, "beta_end": 0.012, "timestep_spacing": "leading",
             "steps_offset": 1}
    model = tmp_path / "model"
    save_hf_checkpoint(str(model), env.unet, env.vae, scheduler_config=sched)
    ucfg, vcfg, jsched, _ = jload(str(model), dtype=jnp.float32)
    assert dataclasses.asdict(ucfg) == dataclasses.asdict(env.unet.config)
    assert (ucfg.in_channels, ucfg.enable_pose_encoder) == (15, False)
    assert jsched == sched
    from diffuman4d_torch.configs.presets import build_config

    args = ["exp=demo_3d", f"data.data_dir={env.root / 'data'}", "data.scene_label=scene0",
            f"data.height={IMAGE}", f"data.width={IMAGE}", f"model.model_dir={model}",
            "model.dtype=fp32", "model.param_dtype=fp32", "sampler.spa_label_range=[0,6,1]",
            "sampler.input_spa_labels=[0,3]", "sampler.window_size=2",
            f"sampler.output_dir={tmp_path / 'out'}"]
    cfg = build_config(args)
    pipe = loader.load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cpu")
    assert pipe.scheduler.config.kind == kind and not pipe.unet.config.enable_pose_encoder
    assert all(torch.equal(v, pipe.unet.state_dict()[k])
               for k, v in env.unet.state_dict().items())
    if kind == "dpm++":
        from diffuman4d_torch import cli

        assert cli.main(args + ["device=cpu"]) == 0
        assert len(_jpegs(tmp_path / "out")) == 6
