"""The blocking of the port's two VAE kernels, restated in torch on the CPU
and held to the JAX package.

The CUDA kernels run only on the card (``test_torch_port_cuda.py``). What
their layouts and tilings compute is checked here, at tiny shapes, by
torch restatements that walk the same tiles in the same order:

* ``csrc/conv3x3_hopper.cu``: the wrapper's tap-major weights
  (:func:`diffuman4d_torch.ops.conv.tap_major_weights`), 4 x 32-pixel
  output tiles, 64-channel chunks whose (4 + 2) x (32 + 2) halo window is
  transformed once (affine + SiLU, bf16) and zeroed outside the image, three
  dx-shifted copies of it, and nine tap products per chunk. Held to the JAX
  package's ``conv3x3`` run in interpret mode (or its XLA restatement where
  H is below the Pallas kernel's row tile).
* ``csrc/flash_attn_d512.cu``: 64-row query tiles, 64-key tiles whose
  scores are the sum of two half-depth partials, each consumer owning the
  keys of one half, one shared running maximum, P in the input dtype, two
  256-column output halves and the two halves of the normaliser added at
  the end. Held to the JAX package's Pallas kernel ``_flash_kernel`` in
  interpret mode where its blocks divide S, and to its XLA attention at
  ragged lengths.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_helpers import j, n, randn, rng, t

TH, TW, BK = 4, 32, 64  # conv3x3_hopper.cu's output tile and channel chunk
BM, BN, HALF = 64, 64, 256  # flash_attn_d512.cu's query tile, key tile, depth half


def conv_tiles(x, w, bias, scale, shift, residual, silu):
    """conv3x3_hopper.cu's order of work on (B, H, W, Cin) bf16 ``x`` and
    (Cout, Cin, 3, 3) ``w``: fp32 products of bf16 operands."""
    from diffuman4d_torch.ops.conv import tap_major_weights

    B, H, W, cin = x.shape
    wt = tap_major_weights(w).float()  # (Cout, 9, Cin)
    cout = wt.shape[0]
    out = torch.zeros((B, H, W, cout))
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            acc = torch.zeros((B, TH, TW, cout))
            for c0 in range(0, cin, BK):
                # the TMA box: zeros outside the image and past Cin
                win = torch.zeros((B, TH + 2, TW + 2, BK), dtype=torch.bfloat16)
                inside = torch.zeros((TH + 2, TW + 2), dtype=torch.bool)
                ys = range(max(y0 - 1, 0), min(y0 + TH + 1, H))
                xs = range(max(x0 - 1, 0), min(x0 + TW + 1, W))
                cs = slice(c0, min(c0 + BK, cin))
                nc = cs.stop - c0
                if len(ys) and len(xs):
                    iy = slice(ys[0] - y0 + 1, ys[-1] - y0 + 2)
                    ix = slice(xs[0] - x0 + 1, xs[-1] - x0 + 2)
                    win[:, iy, ix, :nc] = x[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1, cs]
                    inside[iy, ix] = True
                # the prologue, once per element, then zero outside the image
                h = win.float()
                if scale is not None:
                    a = torch.zeros((B, BK))
                    s = torch.zeros((B, BK))
                    a[:, :nc], s[:, :nc] = scale[:, cs], shift[:, cs]
                    h = h * a[:, None, None, :] + s[:, None, None, :]
                if silu:
                    h = F.silu(h)
                h = torch.where(inside[None, :, :, None], h, 0.0).to(torch.bfloat16).float()
                copies = [h[:, :, dx:dx + TW] for dx in range(3)]
                wk = torch.zeros((cout, 9, BK))
                wk[:, :, :nc] = wt[:, :, cs]
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    acc += torch.einsum("byxk,nk->byxn", copies[dx][:, dy:dy + TH], wk[:, tap])
            ys, xs = slice(y0, min(y0 + TH, H)), slice(x0, min(x0 + TW, W))
            out[:, ys, xs] = acc[:, : ys.stop - y0, : xs.stop - x0]
    out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("B,H,W,cin,cout,affine,silu,res,shift0", [
    (2, 16, 40, 72, 16, True, True, True, 0.0),  # two chunks, the second ragged; two column tiles
    (1, 16, 24, 8, 24, False, False, False, 0.0),  # plain conv, one ragged chunk
    (2, 16, 40, 16, 8, True, True, False, 2.0),  # silu(shift) far from 0 at the padding
    # below the Pallas kernel's tiles (the XLA restatement): W = 37 and 45
    # not multiples of 32, H = 1 and 2 within one 4-row tile
    (2, 2, 37, 16, 8, True, True, True, 2.0),
    (1, 1, 33, 64, 8, False, True, True, 0.0),  # SiLU without affine
    (2, 5, 45, 8, 16, True, True, False, 2.0),
])
def test_conv_tiles_match_jax(B, H, W, cin, cout, affine, silu, res, shift0):
    """The kernel's tiles, chunks, halo windows, shifted copies and tap-major
    weights, restated in torch, against the JAX package's conv3x3 in
    interpret mode (8-row tiles), or its XLA restatement ``_conv3x3_ref``
    at sizes the Pallas kernel does not tile. The shift of about 2 makes silu(shift) ~ 1.8:
    a window whose padding were transformed instead of zeroed after the
    prologue would miss by O(1) along every edge."""
    from diffuman4d_tpu.ops.conv import _conv3x3_ref, conv3x3

    r = rng(11)
    x = randn(r, B, H, W, cin)
    w = randn(r, 3, 3, cin, cout, scale=0.2)  # HWIO, the JAX package's layout
    bias = randn(r, cout)
    scale = (1.0 + 0.3 * randn(r, B, cin)) if affine else None
    shift = (shift0 + 0.3 * randn(r, B, cin)) if affine else None
    residual = randn(r, B, H, W, cout) if res else None
    xb = jnp.asarray(x, jnp.bfloat16)
    rb = None if residual is None else jnp.asarray(residual, jnp.bfloat16)
    if H >= 16 and H % 8 == 0 and W % 8 == 0:
        want = conv3x3(xb, j(w), j(bias), None if scale is None else j(scale),
                       None if shift is None else j(shift), rb, silu=silu, tile_rows=8,
                       interpret=True)
    else:
        want = _conv3x3_ref(
            xb, j(w), j(bias), jnp.ones((B, cin)) if scale is None else j(scale),
            jnp.zeros((B, cin)) if shift is None else j(shift),
            jnp.zeros((B, 1, 1, cout), jnp.bfloat16) if rb is None else rb,
            silu, scale is not None, rb is not None)
    got = conv_tiles(t(x).bfloat16(), t(np.transpose(w, (3, 2, 0, 1))), t(bias),
                     None if scale is None else t(scale), None if shift is None else t(shift),
                     None if residual is None else t(residual).bfloat16(), silu)
    # the same bf16 operands and fp32 sums in another order; bf16 outputs
    # up to ~16 agree to one bf16 rounding (2**-8 * 16)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=0.0625)
    assert np.mean(n(got) == n(want)) > 0.95


def test_tap_major_weights_is_the_kernel_layout():
    """Tap 3 dy + dx of output channel o holds w[o, :, dy, dx]."""
    from diffuman4d_torch.ops.conv import tap_major_weights

    w = torch.randn(5, 16, 3, 3)
    wt = tap_major_weights(w)
    assert wt.shape == (5, 9, 16) and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        assert torch.equal(wt[:, tap], w[:, :, dy, dx].bfloat16())


def attention_tiles(q, k, v):
    """flash_attn_d512.cu's order of work on (B, S, H, 512) tensors in
    fp32, P rounded to the input dtype (bf16 on the card)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = np.log2(np.e) / np.sqrt(D)
    out = torch.empty_like(q)
    qf, kf, vf = q.float(), k.float(), v.float()
    for b in range(B):
        for h in range(H):
            for q0 in range(0, Sq, BM):
                qt = qf[b, q0:q0 + BM, h]
                rows = qt.shape[0]
                m = torch.full((rows,), -torch.inf)
                l = [torch.zeros(rows), torch.zeros(rows)]  # each consumer's keys
                # each consumer's output columns
                o = [torch.zeros((rows, HALF)), torch.zeros((rows, HALF))]
                for k0 in range(0, Sk, BN):
                    kt = torch.zeros((BN, D))
                    vt = torch.zeros((BN, D))
                    kt[: min(BN, Sk - k0)] = kf[b, k0:k0 + BN, h]
                    vt[: min(BN, Sk - k0)] = vf[b, k0:k0 + BN, h]
                    # two half-depth partials of all 64 keys, added
                    s = qt[:, :HALF] @ kt[:, :HALF].T + qt[:, HALF:] @ kt[:, HALF:].T
                    s[:, Sk - k0:] = -torch.inf
                    halves = (s[:, :BN // 2], s[:, BN // 2:])
                    mx = torch.maximum(halves[0].amax(1), halves[1].amax(1))
                    mn = torch.maximum(m, mx * scale)
                    alpha = torch.exp2(m - mn)
                    m = mn
                    p = []
                    for c in range(2):
                        e = torch.exp2(halves[c] * scale - m[:, None])
                        l[c] = l[c] * alpha + e.sum(1)
                        p.append(e.to(q.dtype).float())
                    pt = torch.cat(p, 1)
                    for c in range(2):
                        o[c] = o[c] * alpha[:, None] + pt @ vt[:, HALF * c:HALF * (c + 1)]
                out[b, q0:q0 + BM, h] = (torch.cat(o, 1) / (l[0] + l[1])[:, None]).to(q.dtype)
    return out


@pytest.mark.parametrize("Sq,Sk", [(128, 128), (64, 192)])
def test_attention_tiles_match_pallas_interpret(Sq, Sk):
    """At S a multiple of the blocks, against the JAX package's Pallas kernel
    (``_flash_kernel``, the B3 kernel) in interpret mode, fp32."""
    from tests.test_flash_interpret import _interp_flash

    r = rng(12)
    q, k, v = randn(r, 1, Sq, 2, 512), randn(r, 1, Sk, 2, 512), randn(r, 1, Sk, 2, 512)
    q[:, :, 1] *= 4.0  # the second head: peaked logits
    want = _interp_flash(j(q), j(k), j(v), block_q=64, block_k=64)
    got = attention_tiles(t(q), t(k), t(v))
    # fp32 on both sides; scores summed in another order and exponentials
    # in base 2 with the scale applied to the sum
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 70, 100, 1), (1, 130, 33, 2)])
def test_attention_tiles_ragged_match_xla(B, Sq, Sk, H):
    """Ragged S and Sq != Sk (a key tile whose second half lies wholly past
    Sk included), against the JAX package's XLA attention, fp32."""
    from diffuman4d_tpu.ops.attention import _xla_attention

    r = rng(13)
    q, k, v = randn(r, B, Sq, H, 512), randn(r, B, Sk, H, 512), randn(r, B, Sk, H, 512)
    want = _xla_attention(j(q), j(k), j(v))
    got = attention_tiles(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("source,names", [
    ("conv3x3_hopper.cu", {"TH": TH, "TW": TW, "BK": BK}),
    ("flash_attn_d512.cu", {"BM": BM, "BN": BN, "HD": 2 * HALF}),
])
def test_restatements_walk_the_kernels_tiles(source, names):
    """The tile sizes above are the constants the CUDA sources are built with."""
    import re

    from diffuman4d_torch.ops import cuda_build

    src = (cuda_build.CSRC / source).read_text()
    for name, value in names.items():
        m = re.search(r"\b" + name + r" = (\d+)[,;]", src)
        assert m and int(m.group(1)) == value, (source, name)
