"""The port's per-unit measurement tools (``profile_units``,
``profile_unet_units``, ``profile_vae``, ``profile_vae_conv``,
``profile_window``, ``attn_ceiling``, ``bench_flash_backward``) against the
JAX package's scripts on the CPU.

Each tool's units at full width -- record names, shapes and FLOP / byte
counts -- equal the script's, restated here from the script's lines (the
scripts need a TPU to run). On ``--device cpu --arch tiny --iters 1`` each
tool runs through the plain versions and writes its JSON. The units that
wrap a model module give the JAX module's output on the same weights, at
fp32, within the tolerances of ``tests/test_torch_port_layers.py``."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (  # noqa: F401 -- one_torch_thread: autouse fixture
    j, jit_apply, load_block, n, one_torch_thread, perturb_params, randn, rng, t)


def _names(units):
    return [(u["name"], tuple(u["shape"]), u.get("flops", 0.0), u.get("nbytes", 0.0))
            for u in units]


def test_profile_units_plan_is_the_scripts():
    """scripts/profile_units.py:68-162."""
    from diffuman4d_torch.profile_units import plan

    want = []
    for b, hw, c in [(32, 128, 320), (32, 64, 640), (32, 32, 1280), (32, 16, 1280)]:
        want += [(f"conv3x3_{hw}x{c}", (b, hw, hw, c), 2 * b * hw * hw * c * c * 9, 0.0),
                 (f"gn_silu_{hw}x{c}", (b, hw, hw, c), 0.0, 2 * b * hw * hw * c * 2),
                 (f"resnet_{hw}x{c}", (b, hw, hw, c), 2 * (2 * b * hw * hw * c * c * 9), 0.0)]
    for hw, c, heads, nf in ((128, 320, 5, 1), (64, 640, 10, 16), (32, 1280, 20, 16)):
        tokens = hw * hw
        s3d = nf * tokens
        flops = (4 * (32 // nf) * s3d * s3d * c + 32 * 4 * tokens * tokens * c
                 + 32 * tokens * (8 * c * c + 16 * c * c))
        want.append((f"mvblock_{hw}x{c}", (32, tokens, c), flops, 0.0))
    want += [("vae_encode_b2", (2, 1024, 1024, 3), 2 * 560e9 * 2, 0.0),
             ("vae_decode_b2", (2, 128, 128, 4), 2 * 2.5e12, 0.0)]
    for hw, c in ((256, 512), (512, 512), (512, 256), (1024, 128)):
        want += [(f"vae_conv3x3_{hw}x{c}", (2, hw, hw, c), 2 * 2 * hw * hw * c * c * 9, 0.0),
                 (f"vae_gn_silu_{hw}x{c}", (2, hw, hw, c), 0.0, 2 * 2 * hw * hw * c * 2)]
    assert _names(plan("full")) == want


def test_profile_unet_units_plan_is_the_scripts():
    """scripts/profile_unet_units.py:78-156 (bytes: x.size * 2 per activation)."""
    from diffuman4d_torch.profile_unet_units import plan

    B, want = 32, []
    for res, ch in [(128, 320), (64, 640), (32, 1280), (16, 1280)]:
        act, cflops = B * res * res * ch * 2, 2.0 * B * res * res * 9 * ch * ch
        want += [(f"conv3x3 {res}^2x{ch}", (B, res, res, ch), cflops, 3 * act),
                 (f"resnet {res}^2x{ch}", (B, res, res, ch), 2 * cflops, 10 * act),
                 (f"groupnorm {res}^2x{ch}", (B, res, res, ch), 0.0, 2 * act)]
    for res, ch in [(128, 320), (64, 640), (32, 1280)]:
        tok = B * res * res
        want.append((f"ff_updown {tok}x{ch}x{4 * ch}", (tok, ch), 2.0 * tok * ch * 4 * ch * 2,
                     (tok * ch * 2 + ch * 4 * ch + 4 * ch * ch + tok * 4 * ch) * 2))
    vb = 4
    for res, ch in [(128, 512), (256, 512), (512, 256), (1024, 128)]:
        act, cflops = vb * res * res * ch * 2, 2.0 * vb * res * res * 9 * ch * ch
        want += [(f"vae_conv3x3 {res}^2x{ch}", (vb, res, res, ch), cflops, 3 * act),
                 (f"vae_resnet {res}^2x{ch}", (vb, res, res, ch), 2 * cflops, 10 * act),
                 (f"vae_groupnorm {res}^2x{ch}", (vb, res, res, ch), 0.0, 2 * act)]
    want.append(("vae_upsample 512->1024x256", (vb, 512, 512, 256),
                 2.0 * vb * 1024 * 1024 * 9 * 256 * 256, 18 * vb * 512 * 512 * 256 * 2))
    assert _names(plan("full")) == want


@pytest.mark.parametrize("b", [1, 2])
def test_profile_vae_plan_is_the_scripts(b):
    """scripts/profile_vae.py:91-155 (and its conv_flops / resnet_flops)."""
    from diffuman4d_torch.profile_vae import plan

    def conv_flops(b, h, w, cin, cout):
        return 2 * 9 * cin * cout * b * h * w

    def resnet_flops(b, h, w, cin, cout):
        f = conv_flops(b, h, w, cin, cout) + conv_flops(b, h, w, cout, cout)
        return f + (2 * cin * cout * b * h * w if cin != cout else 0)

    stages = [
        ("mid(512)@128^2", (b, 128, 128, 512), 2 * resnet_flops(b, 128, 128, 512, 512)
         + 4 * 128**4 * 512 * b + 4 * 2 * 512 * 512 * b * 128**2, 1),
        ("res512@128^2 x3", (b, 128, 128, 512), resnet_flops(b, 128, 128, 512, 512), 3),
        ("up512@128->256", (b, 128, 128, 512), conv_flops(b, 256, 256, 512, 512), 1),
        ("res512@256^2 x3", (b, 256, 256, 512), resnet_flops(b, 256, 256, 512, 512), 3),
        ("up512@256->512", (b, 256, 256, 512), conv_flops(b, 512, 512, 512, 512), 1),
        ("res512->256@512^2", (b, 512, 512, 512), resnet_flops(b, 512, 512, 512, 256), 1),
        ("res256@512^2 x2", (b, 512, 512, 256), resnet_flops(b, 512, 512, 256, 256), 2),
        ("up256@512->1024", (b, 512, 512, 256), conv_flops(b, 1024, 1024, 256, 256), 1),
        ("res256->128@1024^2", (b, 1024, 1024, 256), resnet_flops(b, 1024, 1024, 256, 128), 1),
        ("res128@1024^2 x2", (b, 1024, 1024, 128), resnet_flops(b, 1024, 1024, 128, 128), 2),
        ("out: norm+silu+conv@1024^2", (b, 1024, 1024, 128),
         conv_flops(b, 1024, 1024, 128, 3), 1),
    ]
    refs = [(f"conv3x3 {ch}ch@{hw}^2", (b, hw, hw, ch), conv_flops(b, hw, hw, ch, ch), 1)
            for ch, hw in [(512, 128), (512, 256), (256, 512), (128, 1024), (256, 1024)]]
    refs += [(f"GN+silu {ch}ch@{hw}^2", (b, hw, hw, ch), 0, 1)
             for ch, hw in [(512, 256), (256, 512), (128, 1024)]]
    refs += [(f"upsample2x {ch}ch@{hw}^2", (b, hw, hw, ch), conv_flops(b, 2 * hw, 2 * hw, ch, ch),
              1) for ch, hw in [(512, 128), (512, 256), (256, 512)]]
    got_stages, got_refs = plan("full", b)
    assert [(u["name"], u["shape"], u["flops"], u["repeat"]) for u in got_stages] == stages
    assert [(u["name"], u["shape"], u["flops"], u["repeat"]) for u in got_refs] == refs


def test_profile_vae_conv_window_ceiling_backward_plans_are_the_scripts():
    """scripts/profile_vae_conv.py:55-90, profile_window.py:63-69,
    attn_ceiling_4k.py:50-55 and :108-112, bench_flash_backward.py:36-41
    and :114."""
    from diffuman4d_torch import attn_ceiling, bench_flash_backward, profile_vae_conv
    from diffuman4d_torch.profile_window import attention_shapes

    rows = [(p["name"], p["shape"], p["flops"]) for p in profile_vae_conv.plan("full")
            if not p["row"].startswith("plain")]
    want = []
    for res, ch in [(1024, 128), (512, 256), (256, 512), (128, 512)]:
        cflops = 2.0 * 4 * res * res * 9 * ch * ch
        want += [(f"{r} {res}^2x{ch}", (4, res, res, ch), f) for r, f in (
            ("xla_conv", cflops), ("pallas_conv", cflops), ("xla_resnet", 2 * cflops),
            ("fused_resnet", 2 * cflops))]
    assert rows == want
    for domain, L in (("spatial", 16), ("temporal", 24)):
        assert attention_shapes(domain, 128, 12) == [
            ("3d@64^2", 2, L * 64 ** 2, 10, 64), ("3d@32^2", 2, L * 32 ** 2, 20, 64),
            ("2d@64^2", 2 * L, 64 ** 2, 10, 64)]
    assert attn_ceiling.CASES["full"] == [
        ("2d@64sq", 32, 4096, 10, 64), ("3d@16sq_mid", 2, 4096, 20, 64),
        ("2d@32sq", 32, 1024, 20, 64), ("3d_spatial@64sq", 2, 65536, 10, 64)]
    for _, b, s, h, _ in attn_ceiling.CASES["full"]:
        assert attn_ceiling.proxy_batch(b, s, h) == max(1, min(b * h, (2 << 30) // (s * s * 4)))
    assert bench_flash_backward.SHAPES["full"] == [
        ("train_3d@64sq_f12", 1, 49152, 10, 64), ("train_3d@32sq_f12", 1, 12288, 20, 64),
        ("train_2d@128sq_f12", 12, 16384, 5, 64), ("train_2d@64sq_f12", 12, 4096, 10, 64)]
    assert bench_flash_backward.flops(1, 49152, 10, 64) == 3.5 * 4 * 1 * 10 * 49152**2 * 64


TOOLS = ["profile_units", "profile_unet_units", "profile_vae", "profile_vae_conv",
         "profile_window", "attn_ceiling", "bench_flash_backward"]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_on_the_cpu_at_the_tiny_shape(name, tmp_path):
    import importlib

    tool = importlib.import_module(f"diffuman4d_torch.{name}")
    out = tmp_path / f"{name}.json"
    assert tool.main(["--device", "cpu", "--arch", "tiny", "--iters", "1", "--windows", "1",
                      "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["card"]["name"] == "cpu" and rep["device"] == "cpu" and rep["results"]
    for rec in rep["results"].values():  # host times only: no share of the card's bound
        assert "pct_of_bound" not in rec and "flash_pct_of_bound" not in rec


# (kind, tolerance): the units that wrap a model module
UNITS = [("resnet", 1e-4), ("mvblock_3d", 2e-4), ("mvblock_2d", 2e-4), ("mid", 2e-4),
         ("upsample", 1e-4)]


@pytest.mark.parametrize("kind,atol", UNITS)
def test_model_units_match_the_jax_modules(kind, atol):
    """The tools' units that wrap ``ResnetBlock2D`` (profile_units, with its
    time embedding), ``MultiviewTransformerBlock`` (3D and per-frame),
    ``MidBlock`` and ``Upsample2D`` (profile_vae) against the JAX modules
    on the same (perturbed) weights at fp32."""
    from diffuman4d_tpu.models import layers as jl
    from diffuman4d_tpu.models.transformer import MultiviewTransformerBlock as JBlock
    from diffuman4d_tpu.models.vae import MidBlock as JMid
    from diffuman4d_torch import profile_units, profile_vae
    from diffuman4d_torch.io.checkpoints import load_numpy_state_dict, vae_state_dict_from_flax

    r = rng(11)
    extra = ()
    if kind == "resnet":
        x, e = randn(r, 2, 8, 8, 32), randn(r, 2, 16)
        mod, extra = jl.ResnetBlock2D(32, dtype=jnp.float32), (e,)
        port = profile_units.build({"kind": "resnet", "shape": x.shape}, temb=16)
    elif kind.startswith("mvblock"):
        nf = 2 if kind.endswith("3d") else 1
        x = randn(r, 4, 16, 128)
        mod = JBlock(2, 64, dtype=jnp.float32, attn_implementation="xla")
        port = profile_units.build({"kind": "mvblock", "shape": x.shape, "heads": 2,
                                    "frames": nf}, temb=0)
    elif kind == "mid":
        x = randn(r, 1, 8, 8, 64)
        mod = JMid(64, dtype=jnp.float32)
        port = profile_vae.build("mid", 64, 64)
    else:
        x = randn(r, 2, 8, 8, 32)
        mod = jl.Upsample2D(32, dtype=jnp.float32)
        port = profile_vae.build("upsample", 32, 32)
    kw = {"num_frames": nf} if kind.startswith("mvblock") else {}
    params = perturb_params(jax.jit(lambda k: mod.init(k, j(x), *map(j, extra), **kw))(
        jax.random.PRNGKey(0)), 1, scale=0.1)
    if kind == "mid":  # carried as the decoder's mid block
        sd = vae_state_dict_from_flax({"decoder": {"mid_block": params["params"]}})
        load_numpy_state_dict(port, {k[len("decoder.mid_block."):]: v for k, v in sd.items()})
    else:
        load_block(port, params["params"])
    want = jit_apply(mod, **kw)(params, j(x), *map(j, extra))
    with torch.no_grad():
        got = port.eval()(t(x), *map(t, extra), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=atol)
