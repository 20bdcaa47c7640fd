"""The port's kernel modules on the CPU: the plain versions of flash
attention (d=64, d=512) and of the fused conv3x3 against the JAX package,
the device dispatch of their wrappers, the conv gate and the resizes.

The CUDA kernels themselves run only on the card: ``test_torch_port_cuda.py``
(marked ``cuda``) compares each kernel with its plain version there, and
``chip_smoke.py`` does the same at the slice's full shapes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import j, n, randn, rng, t


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("shape", [(2, 33, 3, 64), (1, 70, 1, 512), (2, 16, 2, 8)])
def test_attention_plain_matches_xla(shape):
    from diffuman4d_tpu.ops.attention import _xla_attention
    from diffuman4d_torch.ops.attention import dot_product_attention

    r = rng(0)
    q, k, v = (randn(r, *shape) for _ in range(3))
    want = _xla_attention(j(q), j(k), j(v))
    for impl in ("math", "auto"):
        got = dot_product_attention(t(q), t(k), t(v), implementation=impl)
        # fp32 scores and softmax on both sides: only summation order differs
        np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-6)


# softmax of logits ~1e2 from fp32 dot products of length d whose terms sum
# to ~1e2 * sqrt(d): the logits carry ~1e-7 * 1e2 * d of rounding, which the
# exp turns into that relative error of the probabilities
@pytest.mark.parametrize("d,atol", [(64, 2e-5), (512, 5e-4)])
def test_attention_large_logits_stable(d, atol):
    """Logits of order 100 (the large-logit case of test_flash_interpret):
    the fp32 softmax must stay finite and equal to the reference."""
    from diffuman4d_tpu.ops.attention import _xla_attention
    from diffuman4d_torch.ops.attention import dot_product_attention

    r = rng(1)
    q = randn(r, 1, 128, 1, d, scale=10.0)
    k = randn(r, 1, 128, 1, d, scale=10.0)
    v = randn(r, 1, 128, 1, d)
    want = _xla_attention(j(q), j(k), j(v))
    got = dot_product_attention(t(q), t(k), t(v))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=atol)


def test_attention_bf16_rounds_probs_like_jax():
    """In bf16 both sides round P to bf16 before the PV product."""
    from diffuman4d_tpu.ops.attention import _xla_attention
    from diffuman4d_torch.ops.attention import dot_product_attention

    r = rng(2)
    q, k, v = (randn(r, 2, 40, 2, 64) for _ in range(3))
    want = _xla_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    got = dot_product_attention(*(t(x).bfloat16() for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the output (values within +-4): 2**-8 * 4
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2 ** -6)


def test_cpu_tensors_take_plain_versions_without_counting():
    from diffuman4d_torch.ops import conv, flash_attention as fa

    def records():
        return [(fn.launches, set(fn.shapes)) for fn in
                (fa.flash_attention_d64, fa.flash_attention_d512, conv.conv3x3)]

    before = records()
    r = rng(3)
    q = t(randn(r, 1, 9, 1, 64))
    torch.testing.assert_close(fa.flash_attention_d64(q, q, q), fa.attention_plain(q, q, q))
    q5 = t(randn(r, 1, 9, 1, 512))
    torch.testing.assert_close(fa.flash_attention_d512(q5, q5, q5),
                               fa.attention_plain(q5, q5, q5))
    x, w, b = t(randn(r, 1, 5, 6, 8)), t(randn(r, 8, 8, 3, 3)), t(randn(r, 8))
    torch.testing.assert_close(conv.conv3x3(x, w, b), conv.conv3x3_plain(x, w, b))
    assert records() == before


def test_unknown_attention_implementation_raises():
    from diffuman4d_torch.ops.attention import dot_product_attention

    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        dot_product_attention(q, q, q, implementation="sdpa")


# ------------------------------------------------------------------- conv3x3
def _conv_inputs(seed, B, H, W, cin, cout, affine, res):
    r = rng(seed)
    x = randn(r, B, H, W, cin)
    w_hwio = randn(r, 3, 3, cin, cout, scale=0.2)
    bias = randn(r, cout)
    scale = (1.0 + 0.3 * randn(r, B, cin)) if affine else None
    shift = 0.3 * randn(r, B, cin) if affine else None
    residual = randn(r, B, H, W, cout) if res else None
    return x, w_hwio, bias, scale, shift, residual


def _port_conv(x, w_hwio, bias, scale, shift, residual, silu):
    from diffuman4d_torch.ops.conv import conv3x3

    w_oihw = np.transpose(w_hwio, (3, 2, 0, 1))
    return conv3x3(
        t(x).bfloat16(), t(w_oihw), t(bias),
        None if scale is None else t(scale), None if shift is None else t(shift),
        None if residual is None else t(residual).bfloat16(), silu=silu,
    )


@pytest.mark.parametrize(
    "B,H,W,cin,cout,affine,silu,res",
    [
        (2, 16, 8, 8, 8, False, False, False),  # plain conv
        (2, 16, 8, 16, 8, True, True, False),  # affine + SiLU, Cin != Cout
        (2, 24, 8, 8, 16, True, True, True),  # + residual, three row tiles
    ],
)
def test_conv3x3_plain_matches_pallas_interpret(B, H, W, cin, cout, affine, silu, res):
    """Plain version vs the JAX kernel run in interpret mode (tile_rows=8,
    so the top / bottom halo rows and interior tiles are all exercised) and
    vs its XLA restatement ``_conv3x3_ref``."""
    from diffuman4d_tpu.ops.conv import _conv3x3_ref, conv3x3

    x, w, bias, scale, shift, residual = _conv_inputs(4, B, H, W, cin, cout, affine, res)
    xb = jnp.asarray(x, jnp.bfloat16)
    rb = None if residual is None else jnp.asarray(residual, jnp.bfloat16)
    want = conv3x3(xb, j(w), j(bias), None if scale is None else j(scale),
                   None if shift is None else j(shift), rb, silu=silu, tile_rows=8,
                   interpret=True)
    ones, zeros = jnp.ones((B, cin)), jnp.zeros((B, cin))
    want_ref = _conv3x3_ref(
        xb, j(w), j(bias), ones if scale is None else j(scale),
        zeros if shift is None else j(shift),
        jnp.zeros((B, 1, 1, cout), jnp.bfloat16) if rb is None else rb,
        silu, scale is not None, rb is not None,
    )
    got = _port_conv(x, w, bias, scale, shift, residual, silu)
    assert got.dtype == torch.bfloat16
    # same bf16 operands and fp32 accumulation; the outputs are bf16, so
    # they agree to one bf16 rounding of values up to ~16 (2**-8 * 16)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=0.0625)
    np.testing.assert_allclose(n(got), n(want_ref), rtol=0, atol=0.0625)
    # most elements round identically
    assert np.mean(n(got) == n(want_ref)) > 0.95


def test_conv3x3_fp32_input_keeps_dtype():
    from diffuman4d_tpu.ops.conv import conv3x3 as jconv
    from diffuman4d_torch.ops.conv import conv3x3

    x, w, bias, *_ = _conv_inputs(5, 1, 16, 8, 8, 8, False, False)
    want = jconv(j(x), j(w), j(bias), tile_rows=8, interpret=True)
    got = conv3x3(t(x), t(np.transpose(w, (3, 2, 0, 1))), t(bias))
    assert got.dtype == torch.float32
    # fp32 in and out around bf16-rounded operands and fp32 accumulation:
    # only summation order differs
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("groups", [4, 2])
def test_groupnorm_affine_matches_jax(groups):
    from diffuman4d_tpu.ops.conv import groupnorm_affine as jga
    from diffuman4d_torch.ops.groupnorm import groupnorm_affine

    r = rng(6)
    x = randn(r, 2, 6, 5, 8) * 3 + 1
    gamma, beta = 1 + 0.2 * randn(r, 8), randn(r, 8)
    ws, wsh = jga(j(x), j(gamma), j(beta), groups, 1e-6)
    gs, gsh = groupnorm_affine(t(x), t(gamma), t(beta), groups, 1e-6)
    # fp32 moments over 30 elements: relative 1e-5
    np.testing.assert_allclose(n(gs), n(ws), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(gsh), n(wsh), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape,cout",
    [((4, 1024, 1024, 128), 128), ((4, 512, 512, 256), 256), ((4, 256, 256, 512), 512),
     ((4, 128, 128, 512), 512), ((32, 128, 128, 640), 640), ((32, 128, 128, 320), 320),
     ((32, 128, 128, 128), 128), ((4, 1024, 1024, 128), 129), ((32, 64, 64, 1280), 1280),
     ((4, 512, 512, 512), 256), ((1, 256, 256, 128), 128)],
)
def test_conv_gate_admits_the_jax_gates_shapes(shape, cout):
    from diffuman4d_tpu.ops.conv import pallas_conv3x3_ok
    from diffuman4d_torch.ops.conv import conv3x3_ok

    assert conv3x3_ok(shape, cout) == pallas_conv3x3_ok(shape, cout)


# -------------------------------------------------------------------- resize
@pytest.mark.parametrize("out_hw", [(5, 7), (16, 12), (9, 9)])
def test_resizes_match_jax(out_hw):
    from diffuman4d_tpu.ops import resize as jr
    from diffuman4d_torch.ops import resize as pr

    x = randn(rng(7), 2, 9, 9, 3)
    np.testing.assert_allclose(n(pr.resize_bilinear(t(x), *out_hw)),
                               n(jr.resize_bilinear(j(x), *out_hw)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(n(pr.resize_nearest(t(x), *out_hw)),
                                  n(jr.resize_nearest(j(x), *out_hw)))
    np.testing.assert_array_equal(n(pr.upsample_nearest_2x(t(x))),
                                  n(jr.upsample_nearest_2x(j(x))))
