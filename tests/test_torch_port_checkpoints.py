"""Diffusers checkpoint directories between the JAX package and the port
(``io/checkpoints.py`` ``save_hf_checkpoint`` / ``load_hf_checkpoint``),
the port's numpy safetensors reader and writer against the ``safetensors``
package, the scheduler's ``from_config`` and ``load_pipeline``'s
branches. fp32 on the CPU; tiny models with perturbed weights, inputs from
numpy with a seed."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    TINY_UNET,
    TINY_VAE,
    j,
    jax_unet,
    jax_vae,
    jit_apply,
    n,
    randn,
    rng,
    t,
)

# fp32 on both sides: summation order only (as tests/test_torch_port_models.py)
UNET_ATOL = 2e-4
VAE_ATOL = 2e-4


# ------------------------------------------------------------- safetensors
def _tensors(seed: int = 0) -> dict[str, np.ndarray]:
    r = rng(seed)
    return {"a.weight": randn(r, 3, 5, 2, 2), "b": randn(r, 7), "scalar": np.array(randn(r)),
            "conv.bias": randn(r, 1, 4)}


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file

    from diffuman4d_torch.io.checkpoints import read_safetensors, write_safetensors

    want = _tensors()
    path = str(tmp_path / "w.safetensors")
    write_safetensors(path, {k: v.astype(np.float64) for k, v in want.items()})  # cast to F32
    got = load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v)
    with safe_open(path, framework="np") as f:
        assert sorted(f.keys()) == sorted(want)
    mine = read_safetensors(path)
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k], v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["F32", "F16", "BF16"])
def test_safetensors_reader_reads_the_package(tmp_path, dtype):
    from safetensors.torch import save_file

    from diffuman4d_torch.io.checkpoints import read_safetensors

    want = {k: torch.from_numpy(v).to(dtype) for k, v in _tensors(1).items()}
    path = str(tmp_path / "p.safetensors")
    save_file(want, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == tuple(v.shape)
        np.testing.assert_array_equal(got[k], v.float().numpy())  # widening is exact


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    from safetensors.numpy import save_file

    from diffuman4d_torch.io.checkpoints import read_safetensors

    path = str(tmp_path / "i.safetensors")
    save_file({"ids": np.arange(4, dtype=np.int64)}, path)
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(path)


# ---------------------------------------------------- checkpoint directories
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A diffusers directory written by the JAX package from perturbed tiny
    params, with the modules and params."""
    from diffuman4d_tpu.io.checkpoints import save_hf_checkpoint
    from diffuman4d_tpu.models.unet import UNetConfig
    from diffuman4d_tpu.models.vae import VAEConfig

    umod, uparams = jax_unet(TINY_UNET)
    vmod, vparams = jax_vae(TINY_VAE)
    model_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    save_hf_checkpoint(model_dir, {"unet": uparams, "vae": vparams}, UNetConfig(**TINY_UNET),
                       VAEConfig(**TINY_VAE))
    return model_dir, umod, vmod


def _port_pipeline(model_dir: str, param_dtype: str):
    from diffuman4d_torch.configs.presets import DataConfig, ModelConfig, SamplerConfig
    from diffuman4d_torch.sampling.loader import load_pipeline

    return load_pipeline(ModelConfig(model_dir=model_dir, dtype="fp32", param_dtype=param_dtype),
                         SamplerConfig(), DataConfig(height=64, width=64), device="cpu")


@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
def test_jax_written_checkpoint_runs_in_the_port(jax_checkpoint, param_dtype):
    """The port loads a JAX-written directory to the weights the JAX
    package loads (bit for bit, at either storage dtype), and its UNet and
    VAE give the JAX modules' outputs on them at fp32 compute."""
    from diffuman4d_tpu.io.checkpoints import load_hf_checkpoint
    from diffuman4d_torch.io.checkpoints import state_dicts_from_flax

    model_dir, umod, vmod = jax_checkpoint
    pipe = _port_pipeline(model_dir, param_dtype)
    ucfg, vcfg, sched, params = load_hf_checkpoint(
        model_dir, dtype={"fp32": jnp.float32, "bf16": jnp.bfloat16}[param_dtype])
    assert dataclasses.asdict(pipe.unet.config) == dataclasses.asdict(ucfg)
    assert dataclasses.asdict(pipe.vae.config) == dataclasses.asdict(vcfg)
    assert pipe.unet.conv_in.weight.dtype == torch.float32
    want_u, want_v = state_dicts_from_flax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params["unet"]["params"]),
        jax.tree.map(lambda x: np.asarray(x, np.float32), params["vae"]["params"]))
    for module, want in ((pipe.unet, want_u), (pipe.vae, want_v)):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    L, r = 4, rng(3)
    x = randn(r, L, 8, 8, 11)
    sk = np.clip(randn(r, L, 64, 64, 3), -1, 1)
    ts = np.array([0, 981, 500, 21], np.int32)
    tem = np.tile(np.arange(L // 2), 2).astype(np.int32)
    want = jit_apply(umod, num_frames=L)(jparams["unet"], j(x), jnp.asarray(ts), j(sk),
                                         jnp.asarray(tem))
    z = randn(r, 2, 8, 8, 4)
    want_img = jit_apply(vmod, method="decode")(jparams["vae"], j(z))
    with torch.no_grad():
        got = pipe.unet(t(x), torch.from_numpy(ts), t(sk), torch.from_numpy(tem), num_frames=L)
        got_img = pipe.vae.decode(t(z))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=UNET_ATOL)
    np.testing.assert_allclose(n(got_img), n(want_img), rtol=0, atol=VAE_ATOL)
    assert pipe.scheduler.config.kind == "ddim" and sched == {"_class_name": "DDIMScheduler"}


def test_port_written_checkpoint_loads_bit_equal_in_jax(tmp_path):
    from diffuman4d_tpu.io.checkpoints import load_hf_checkpoint
    from diffuman4d_torch.io.checkpoints import save_hf_checkpoint, state_dicts_from_flax
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models

    unet, vae = build_models(UNetConfig(**TINY_UNET), VAEConfig(**TINY_VAE), device="cpu",
                             dtype=torch.float32, seed=3)
    with torch.no_grad():  # no zero / one initialisations left to hide a misplaced weight
        for p in list(unet.parameters()) + list(vae.parameters()):
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    save_hf_checkpoint(str(tmp_path), unet, vae)
    ucfg, vcfg, sched_cfg, params = load_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    assert sched_cfg == {"_class_name": "DDIMScheduler"}
    assert ucfg.num_attention_heads == tuple(TINY_UNET["num_attention_heads"])
    assert dataclasses.asdict(ucfg) == dataclasses.asdict(unet.config)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(vae.config)
    # diffusers' naming: attention_head_dim holds the head counts
    written = json.loads((tmp_path / "unet" / "config.json").read_text())
    assert written["attention_head_dim"] == list(TINY_UNET["num_attention_heads"])
    assert "num_attention_heads" not in written
    got_u, got_v = state_dicts_from_flax(
        jax.tree.map(np.asarray, params["unet"]["params"]),
        jax.tree.map(np.asarray, params["vae"]["params"]))
    for module, got in ((unet, got_u), (vae, got_v)):
        want = module.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ----------------------------------------------------- scheduler and loader
def test_scheduler_from_config_matches_jax():
    from diffuman4d_tpu.schedulers.diffusion import from_config as jfrom
    from diffuman4d_torch.schedulers.diffusion import from_config

    cfg = {"_class_name": "DDIMScheduler", "beta_schedule": "linear", "steps_offset": 0,
           "timestep_spacing": "trailing", "trained_betas": None, "clip_sample": True}
    got, want = from_config(cfg), jfrom(cfg)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    np.testing.assert_allclose(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod),
                               rtol=1e-6)
    for other in ("DDPMScheduler", "EulerDiscreteScheduler", "DPMSolverMultistepScheduler"):
        got, want = from_config({**cfg, "_class_name": other}), jfrom({**cfg, "_class_name": other})
        assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    for pkg_from in (from_config, jfrom):  # a class neither package maps
        with pytest.raises(NotImplementedError):
            pkg_from({"_class_name": "PNDMScheduler"})


def test_load_pipeline_random_branch_matches_jax_configs(monkeypatch):
    """Without a checkpoint: the tiny shape is the JAX loader's, the dtypes
    follow dtype / param_dtype, and the JAX package's ``xla`` attention
    means the port's ``math``."""
    from diffuman4d_tpu.configs import presets as jpresets
    from diffuman4d_tpu.sampling import loader as jloader
    from diffuman4d_tpu.sampling.loader import load_pipeline as jload
    from diffuman4d_torch.configs.presets import DataConfig, ModelConfig, SamplerConfig
    from diffuman4d_torch.sampling.loader import load_pipeline

    kw = dict(model_dir="/nonexistent", arch="tiny", dtype="fp32", attn_implementation="xla")
    # only the JAX loader's configs are compared: its random draw is skipped
    monkeypatch.setattr(jloader, "init_random_params", lambda *a, **k: {})
    jpipe = jload(jpresets.ModelConfig(**kw), jpresets.SamplerConfig(),
                  jpresets.DataConfig(height=64, width=64))
    pipe = load_pipeline(ModelConfig(**kw), SamplerConfig(), DataConfig(height=64, width=64),
                         device="cpu")
    assert dataclasses.asdict(pipe.unet.config) == dataclasses.asdict(jpipe.unet.config)
    assert dataclasses.asdict(pipe.vae.config) == dataclasses.asdict(jpipe.vae.config)
    assert dataclasses.asdict(pipe.sliding) == dataclasses.asdict(jpipe.sliding)
    assert pipe.unet.attn_implementation == "math"
    assert pipe.unet.conv_in.weight.dtype == torch.float32

    # bf16 compute, fp32 storage: weights rounded to fp32 (a no-op), held bf16
    half = load_pipeline(ModelConfig(**{**kw, "dtype": "bf16", "param_dtype": "fp32"}),
                         SamplerConfig(), DataConfig(height=64, width=64), device="cpu")
    assert half.unet.conv_in.weight.dtype == torch.bfloat16
    torch.testing.assert_close(half.unet.conv_in.weight,
                               pipe.unet.conv_in.weight.to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError, match="attn_implementation"):
        load_pipeline(ModelConfig(**{**kw, "attn_implementation": "flash"}), SamplerConfig(),
                      DataConfig(height=64, width=64), device="cpu")
