"""The differentiable ops of the port's train path against the JAX package:
``flash_attention_train`` (forward with logsumexp + hand-written backward),
the gradient of the fused ``conv3x3`` and the scheduler's ``add_noise`` /
``velocity``. CPU, inputs from numpy with a seed; the JAX Pallas kernels run
in interpret mode, the port's wrappers take their plain versions (what the
CUDA kernels are held against on the card)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import j, n, randn, rng, t


# ------------------------------------------------------------ flash backward
def _qkvw(seed, b, sq, sk, h, peak=1.0):
    r = rng(seed)
    return (randn(r, b, sq, h, 64, scale=peak), randn(r, b, sk, h, 64), randn(r, b, sk, h, 64),
            randn(r, b, sq, h, 64))


def _port_grads(fn, q, k, v, w, dtype=torch.float32):
    xs = [t(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    (out.float() * t(w)).sum().backward()
    return out, [x.grad for x in xs]


def _jax_grads(q, k, v, w, bq, bk, dtype=jnp.float32):
    from diffuman4d_tpu.ops.flash_backward import flash_attention_train

    xs = [jnp.asarray(x, dtype) for x in (q, k, v)]

    def loss(q, k, v):
        return jnp.sum(flash_attention_train(q, k, v, bq, bk, True).astype(jnp.float32) * j(w))

    return flash_attention_train(*xs, bq, bk, True), jax.grad(loss, argnums=(0, 1, 2))(*xs)


@pytest.mark.parametrize("s,bq,bk", [(128, 64, 64), (256, 128, 64), (256, 256, 128),
                                     (192, 64, 64)])
def test_flash_train_plain_matches_jax_interpret_fp32(s, bq, bk):
    """Output, dq, dk, dv of the plain version vs the JAX kernels in
    interpret mode and vs autograd through plain attention, at the shapes of
    tests/test_flash_backward.py."""
    from diffuman4d_torch.ops.flash_attention import attention_plain
    from diffuman4d_torch.ops.flash_backward import flash_attention_train_plain

    q, k, v, w = _qkvw(0, 2, s, s, 3)
    out, grads = _port_grads(flash_attention_train_plain, q, k, v, w)
    ref, ref_grads = _port_grads(attention_plain, q, k, v, w)
    jout, jgrads = _jax_grads(q, k, v, w, bq, bk)
    # fp32 on every side; only the summation order and exp vs exp2 differ
    np.testing.assert_allclose(n(out), n(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(n(out), n(ref), atol=2e-5, rtol=2e-5)
    for g, gj, gr, name in zip(grads, jgrads, ref_grads, "qkv"):
        np.testing.assert_allclose(n(g), n(gj), atol=3e-4, rtol=3e-4, err_msg=f"d{name} vs jax")
        np.testing.assert_allclose(n(g), n(gr), atol=3e-4, rtol=3e-4, err_msg=f"d{name} vs ref")


def test_flash_train_cross_lengths_match_jax():
    """Sq != Sk (the context-parallel shapes): 128 queries on 192 keys."""
    from diffuman4d_torch.ops.attention import dot_product_attention

    q, k, v, w = _qkvw(1, 2, 128, 192, 2)
    out, grads = _port_grads(
        lambda *a: dot_product_attention(*a, implementation="train"), q, k, v, w)
    jout, jgrads = _jax_grads(q, k, v, w, 64, 64)
    np.testing.assert_allclose(n(out), n(jout), atol=2e-5, rtol=2e-5)
    for g, gj, name in zip(grads, jgrads, "qkv"):
        assert g.shape == gj.shape
        np.testing.assert_allclose(n(g), n(gj), atol=3e-4, rtol=3e-4, err_msg=f"d{name}")


def test_flash_train_bf16_matches_jax_interpret():
    """bf16, the training dtype: Qs, P and dS round at the same places on
    both sides, sums differ in order: each gradient within 2**-6 of its
    largest entry (two bf16 ulps)."""
    from diffuman4d_torch.ops.flash_backward import flash_attention_train

    q, k, v, w = _qkvw(2, 1, 256, 256, 2, peak=2.0)
    out, grads = _port_grads(flash_attention_train, q, k, v, w, torch.bfloat16)
    jout, jgrads = _jax_grads(q, k, v, w, 128, 128, jnp.bfloat16)
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    for got, want, name in zip([out, *grads], [jout, *jgrads], ["out", "dq", "dk", "dv"]):
        want = n(want)
        assert np.abs(n(got) - want).max() <= 2 ** -6 * np.abs(want).max(), name


def test_train_implementation_other_head_dims_take_plain_autograd_on_cpu():
    from diffuman4d_torch.ops.attention import dot_product_attention
    from diffuman4d_torch.ops.flash_attention import attention_plain

    r = rng(3)
    q, k, v = (t(randn(r, 1, 10, 2, 8)).requires_grad_(True) for _ in range(3))
    out = dot_product_attention(q, k, v, implementation="train")
    torch.testing.assert_close(out, attention_plain(q, k, v))
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_flash_train_wrappers_take_plain_on_cpu_without_counting():
    from diffuman4d_torch.ops import flash_backward as fb

    wrappers = (fb.flash_fwd_lse, fb.flash_bwd)
    before = [(f.launches, set(f.shapes)) for f in wrappers]
    q, k, v, w = (t(x) for x in _qkvw(4, 1, 20, 30, 2))
    qs = fb.scale_q(q)
    out, l2 = fb.flash_fwd_lse(qs, k, v)
    assert l2.shape == (1, 2, 20) and l2.dtype == torch.float32
    # L2 is the base-2 logsumexp of the scaled scores
    s2 = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    torch.testing.assert_close(l2, torch.logsumexp(s2 * np.log(2.0), -1) / np.log(2.0))
    delta = fb.attention_delta(out, w)
    got = fb.flash_bwd(qs, k, v, w, l2, delta)
    assert [x.shape for x in got] == [qs.shape, k.shape, v.shape]
    for g, want in zip(got, fb.flash_bwd_plain(qs, k, v, w, l2, delta)):
        torch.testing.assert_close(g, want)
    assert [(f.launches, set(f.shapes)) for f in wrappers] == before


def _bwd_inputs(seed, b, sq, sk, h, dtype=torch.float32):
    """qs, k, v, dO and the forward's L2 and delta, as the backward gets them."""
    from diffuman4d_torch.ops import flash_backward as fb

    q, k, v, w = (t(x).to(dtype) for x in _qkvw(seed, b, sq, sk, h, peak=2.0))
    qs = fb.scale_q(q)
    out, l2 = fb.flash_fwd_lse_plain(qs, k, v)
    return qs, k, v, w, l2, fb.attention_delta(out, w)


@pytest.mark.parametrize("b,sq,sk,h,bq,bk", [(2, 128, 128, 2, 64, 64), (1, 256, 256, 3, 128, 64),
                                             (2, 128, 192, 2, 64, 64), (1, 192, 64, 2, 64, 64)])
def test_flash_bwd_plain_matches_jax_bwd_impl_fp32(b, sq, sk, h, bq, bk):
    """The fused backward's plain version (dQ, dK, dV from the same Qs, dO,
    L2 and delta) against both Pallas kernels of ``_bwd_impl`` in interpret
    mode, fp32, at block sizes that tile S, Sq = Sk and Sq != Sk."""
    from diffuman4d_tpu.ops.flash_backward import _bwd_impl
    from diffuman4d_torch.ops import flash_backward as fb

    qs, k, v, w, l2, delta = _bwd_inputs(5, b, sq, sk, h)
    got = fb.flash_bwd_plain(qs, k, v, w, l2, delta)

    def heads(x):  # (B, S, H, D) -> (B H, S, D)
        return jnp.asarray(n(x).transpose(0, 2, 1, 3).reshape(b * h, x.shape[1], 64))

    def rows8(x):  # (B, H, Sq) -> (B H, 8, Sq), the kernels' row layout
        return jnp.broadcast_to(jnp.asarray(n(x).reshape(b * h, 1, sq)), (b * h, 8, sq))

    want = _bwd_impl(heads(qs), heads(k), heads(v), heads(w), rows8(l2), rows8(delta), bq, bk,
                     1.0 / 8.0, True)
    for g, wnt, name in zip(got, want, ("dq", "dk", "dv")):
        wnt = n(wnt).reshape(b, h, -1, 64).transpose(0, 2, 1, 3)
        assert g.shape == wnt.shape, name
        # fp32 on both sides; only the summation order differs
        np.testing.assert_allclose(n(g), wnt, atol=3e-4, rtol=3e-4, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plain_is_the_two_plain_functions_bit_for_bit(dtype):
    """The fused plain version changes no rounding: it is the dK/dV and dQ
    plain versions composed, bit for bit (bf16 included)."""
    from diffuman4d_torch.ops import flash_backward as fb

    args = _bwd_inputs(6, 2, 70, 90, 3, dtype)
    dq, dk, dv = fb.flash_bwd_plain(*args)
    dk_ref, dv_ref = fb.flash_bwd_dkdv_plain(*args)
    for got, want in ((dq, fb.flash_bwd_dq_plain(*args)), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == dtype and torch.equal(got, want)


# ------------------------------------------------------------- conv3x3 grads
CONV_VARIANTS = {"plain": (False, False, False), "affine_silu": (True, True, False),
                 "affine_silu_res": (True, True, True)}


@pytest.mark.parametrize("variant", list(CONV_VARIANTS))
def test_conv3x3_gradients_match_jax(variant):
    """The port's restatement of ``_conv3x3_p_bwd`` (the CUDA path's
    backward) and autograd through the plain version (the CPU path) vs
    ``jax.grad`` of the JAX op with its kernel in interpret mode."""
    from diffuman4d_tpu.ops.conv import conv3x3 as jconv
    from diffuman4d_torch.ops import conv as pconv

    affine, silu, res = CONV_VARIANTS[variant]
    B, H, W, cin, cout = 2, 16, 8, 8, 16
    r = rng(5)
    x, w = randn(r, B, H, W, cin), randn(r, 3, 3, cin, cout, scale=0.2)
    bias, g = randn(r, cout), randn(r, B, H, W, cout)
    scale = 1.0 + 0.3 * randn(r, B, cin) if affine else None
    shift = 0.3 * randn(r, B, cin) if affine else None
    resid = randn(r, B, H, W, cout) if res else None
    names = ["x", "w", "bias"] + (["scale", "shift"] if affine else []) + (["res"] if res else [])

    def jloss(*args):
        a = dict(zip(names, args))
        y = jconv(a["x"], a["w"], a["bias"], a.get("scale"), a.get("shift"), a.get("res"),
                  silu=silu, tile_rows=8, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * j(g))

    jargs = {"x": jnp.asarray(x, jnp.bfloat16), "w": j(w), "bias": j(bias)}
    if affine:
        jargs.update(scale=j(scale), shift=j(shift))
    if res:
        jargs["res"] = jnp.asarray(resid, jnp.bfloat16)
    want = dict(zip(names, jax.grad(jloss, argnums=tuple(range(len(names))))(*jargs.values())))
    want["w"] = np.transpose(n(want["w"]), (3, 2, 0, 1))

    pargs = {"x": t(x).bfloat16(), "w": t(np.transpose(w, (3, 2, 0, 1))), "bias": t(bias)}
    if affine:
        pargs.update(scale=t(scale), shift=t(shift))
    if res:
        pargs["res"] = t(resid).bfloat16()
    # the cotangent of a bf16 output arrives in bf16, as autograd delivers it
    restated = pconv.conv3x3_backward(
        pargs["x"], pargs["w"], pargs.get("scale"), pargs.get("shift"), t(g).bfloat16(), silu,
        torch.float32, torch.bfloat16 if res else None)
    restated = dict(zip(["x", "w", "bias", "scale", "shift", "res"], restated))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pargs.items()}
    y = pconv.conv3x3(leaves["x"], leaves["w"], leaves["bias"], leaves.get("scale"),
                      leaves.get("shift"), leaves.get("res"), silu=silu)
    (y.float() * t(g)).sum().backward()
    for name in names:
        ref = n(want[name])
        big = np.abs(ref).max()
        # the same bf16 operands and fp32 accumulation as the JAX backward;
        # torch's bf16 convolution gradients come back rounded to bf16 (dw,
        # and dh under dx / dscale / dshift) where XLA's stay fp32, and
        # dx / dres are bf16 on both sides: one bf16 rounding
        tol = 1e-4 if name == "bias" else 2 ** -7
        assert np.abs(n(restated[name]) - ref).max() <= tol * big, (name, "restated")
        # autograd through the plain version keeps the cotangent in fp32
        # where the JAX backward rounds it to bf16: bf16 resolution
        assert np.abs(n(leaves[name].grad) - ref).max() <= 2 ** -6 * big, (name, "autograd")


def test_groupnorm_affine_is_differentiable():
    from diffuman4d_torch.ops.groupnorm import groupnorm_affine

    r = rng(6)
    x = t(randn(r, 2, 6, 5, 8)).requires_grad_(True)
    gamma, beta = t(1 + 0.2 * randn(r, 8)).requires_grad_(True), t(randn(r, 8)).requires_grad_(True)
    scale, shift = groupnorm_affine(x, gamma, beta, 4, 1e-6)
    (scale.sum() + shift.square().sum()).backward()
    assert all(torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0 for p in (x, gamma, beta))


# ------------------------------------------------------------------ scheduler
@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_add_noise_and_velocity_match_jax(schedule):
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_torch.schedulers import diffusion as pd

    r = rng(7)
    x, eps = randn(r, 5, 4, 4, 4), randn(r, 5, 4, 4, 4)
    ts = np.array([0, 1, 500, 998, 999])
    js = jd.Scheduler(jd.SchedulerConfig(beta_schedule=schedule))
    ps = pd.Scheduler(pd.SchedulerConfig(beta_schedule=schedule))
    # fp32 tables from the same float64 cumprod; one fp32 rounding apart
    np.testing.assert_allclose(n(ps.add_noise(t(x), t(eps), torch.from_numpy(ts))),
                               n(js.add_noise(j(x), j(eps), jnp.asarray(ts))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(n(ps.velocity(t(x), t(eps), torch.from_numpy(ts))),
                               n(js.velocity(j(x), j(eps), jnp.asarray(ts))), atol=1e-6, rtol=1e-6)
    assert ps.add_noise(t(x).bfloat16(), t(eps), torch.from_numpy(ts)).dtype == torch.bfloat16
