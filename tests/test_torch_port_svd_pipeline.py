"""SVD image-to-video through the port's own sampling path, on the CPU at
tiny widths and 64^2 frames:

* one job of the benchmark's ``svdxt-orbit-clip`` cell (from a copy of
  the benchmark's files, ``benchmark/tests/svd_checkout.py``), its mix
  cut to a 5-camera ring (input camera 0, its 4 others one clip, 3 Euler steps), through
  ``SlidingIterativeSampler.execute_tasks`` and held by the benchmark's
  output check to the plain reference (``benchmark/reference/svd.py``):
  the starting grid and the chain of steps bit for bit, a step and two
  decoded frames against the fp32 reference within the limits below;
* ``loader.load_pipeline`` -> ``cli.build_sampler`` -> ``execute_tasks``
  from ``model.arch=svd-tiny`` and from a diffusers directory written by
  ``save_hf_checkpoint``;
* the decode's runs of consecutive rows, each a clip of its own;
* the new modules imported with ``import jax`` failing.

Limits of the tiny run: the program computes in bf16 (the cell's dtype), the
reference in fp32. Its readings on seeds 7 and 8 were step 0.031 / 0.027
and decode 0.76 / 0.69 levels; the float8 control read step 0.26 and decode
6.1 levels. ``step`` 0.15 and ``decode`` 2.0 lie between, with room on both
sides."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark.tests.svd_checkout import checkout
from tests.torch_port_svd_setup import TINY_UNET, TINY_VAE, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LIMITS = {"start": 0.0, "chain": 0, "step": 0.15, "decode": 2.0}
TINY = {"unet": TINY_UNET, "vae": TINY_VAE}


RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from benchmark.harness import runner
out = runner.run("svdxt-orbit-clip", {seed}, 0.5, False, time.perf_counter(), device="cpu",
                 image_size=64, overrides={tiny!r}, cache={cache!r}, limits={limits!r},
                 root=Path({checkout!r}))
print(json.dumps({{"result": out["result"], "tasks": out["report"]["tasks"],
                  "latent_steps": out["report"]["latent_steps"]}}))
"""


def test_a_job_through_the_sampler_holds_to_the_reference(tmp_path):
    """In a process of its own: the harness refuses to run where JAX is
    loaded, and this test process has it (``tests/conftest.py``)."""
    checkout(tmp_path / "checkout")
    script = RUN.format(root=str(ROOT), seed=7, tiny=TINY, cache=str(tmp_path / "cache"),
                        limits=LIMITS, checkout=str(tmp_path / "checkout"))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["checks"]["start"]["value"] == 0.0 and res["checks"]["chain"]["value"] == 0
    assert set(res["checks"]) == set(LIMITS)
    assert out["tasks"] == 1 and out["latent_steps"] == 4 * 3


def test_load_pipeline_build_sampler_execute_tasks(tmp_path):
    from diffuman4d_torch.cli import build_sampler
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.io.checkpoints import save_hf_checkpoint
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.sampling.svd_pipeline import SVD_SCHEDULER_CONFIG, SVDPipeline
    from diffuman4d_torch.utils.tracing import counters, report

    make_synthetic_scene(str(tmp_path / "data"), "s", num_cams=5, num_frames=1, image_size=64,
                         seed=3, unique_frames=1)

    def cfg(out, *extra):
        return build_config([
            "exp=demo_3d", f"data.data_dir={tmp_path / 'data'}", "data.scene_label=s",
            "data.height=64", "data.width=64", "sampler.spa_label_range=[0, 5, 1]",
            "sampler.input_spa_labels=[0]", "sampler.tem_label_range=[0, 1, 1]",
            "sampler.window_size=4", "sampler.sliding_stride=4", "sampler.num_denoising_steps=2",
            "sampler.alternation_rounds=1", "sampler.guidance_scale=3.0",
            f"sampler.output_dir={tmp_path / out}", *extra])

    c = cfg("out_a", "model.arch=svd-tiny", "model.dtype=fp32", "model.param_dtype=fp32",
            f"model.model_dir={tmp_path / 'none'}")
    pipe = load_pipeline(c.model, c.sampler, c.data, device="cpu")
    assert isinstance(pipe, SVDPipeline)
    assert pipe.scheduler.config.use_karras_sigmas and pipe.scheduler.init_noise_sigma == 1.0
    sampler = build_sampler(c, pipe, checkpoint_every_tasks=0)
    counters(reset=True)
    report(reset=True)
    sampler.execute_tasks()
    assert {k: v for k, v in counters().items() if k.startswith("svd/")} == {
        "svd/clips": 1, "svd/clip_frames": 4}
    assert report()["cond/image_latent"]["count"] == 1
    assert (sampler.grid_t_idx[1:] == 2).all() and (sampler.grid_t_idx[0] == 0).all()
    assert len(list((tmp_path / "out_a" / "images").rglob("*.jpg"))) == 5

    model_dir = tmp_path / "ckpt"
    save_hf_checkpoint(str(model_dir), pipe.unet, pipe.vae, SVD_SCHEDULER_CONFIG)
    ucfg = json.loads((model_dir / "unet" / "config.json").read_text())
    assert ucfg["_class_name"] == "UNetSpatioTemporalConditionModel"
    c2 = cfg("out_b", f"model.model_dir={model_dir}", "model.dtype=fp32",
             "model.param_dtype=fp32")
    pipe2 = load_pipeline(c2.model, c2.sampler, c2.data, device="cpu")
    assert isinstance(pipe2, SVDPipeline) and pipe2.unet.config == pipe.unet.config
    for a, b in zip(pipe.unet.state_dict().values(), pipe2.unet.state_dict().values()):
        assert torch.equal(a, b)
    s2 = build_sampler(c2, pipe2, checkpoint_every_tasks=0)
    s2.execute_tasks()
    assert torch.equal(s2.grid_latents, sampler.grid_latents)


def test_decode_runs_are_clips_of_their_own():
    from diffuman4d_torch.sampling.loader import SVD_ARCHS, build_svd_models
    from diffuman4d_torch.models.unet_spatiotemporal import SVDUNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.pipeline import SlidingConfig
    from diffuman4d_torch.sampling.svd_pipeline import (
        SVD_SCHEDULER_CONFIG,
        SVDConditioning,
        SVDPipeline,
    )
    from diffuman4d_torch.schedulers.diffusion import from_config

    unet, vae = build_svd_models(SVDUNetConfig(**SVD_ARCHS["svd-tiny"]),
                                 VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                                 "cpu", torch.float32, seed=1)
    pipe = SVDPipeline(unet, vae, from_config(SVD_SCHEDULER_CONFIG),
                       SlidingConfig(window_size=4, sliding_stride=4, alternation_rounds=1),
                       image_size=64, conditioning=SVDConditioning(decode_chunk_size=4),
                       device="cpu")
    z = torch.randn(7, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    images = pipe.decode(z)
    assert images.shape == (7, 64, 64, 3) and images.dtype == np.uint8
    assert np.array_equal(images[:4], pipe.decode(z[:4]))
    assert np.array_equal(images[4:], pipe.decode(z[4:]))


def test_the_svd_modules_import_and_run_without_jax(tmp_path):
    script = """
import sys
for blocked in ("jax", "jaxlib", "flax", "optax", "orbax"):
    sys.modules[blocked] = None
import torch
from diffuman4d_torch.models.unet_spatiotemporal import SVDUNetConfig
from diffuman4d_torch.models.vae import VAEConfig
from diffuman4d_torch.sampling.loader import SVD_ARCHS, build_svd_models, load_pipeline
from diffuman4d_torch.sampling.svd_pipeline import SVDPipeline
import diffuman4d_torch.models.vae_temporal, diffuman4d_torch.ops.attention
import benchmark.reference.svd
unet, vae = build_svd_models(SVDUNetConfig(**SVD_ARCHS["svd-tiny"]),
                             VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                             "cpu", torch.float32)
with torch.no_grad():
    unet(torch.zeros(4, 8, 8, 8), torch.zeros(4), torch.zeros(1, 1, 16),
         torch.zeros(1, 3), 4)
    vae.decode(torch.zeros(4, 8, 8, 4), 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffuman4d_tpu", "flax")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-2000:]
