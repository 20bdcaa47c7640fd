"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; the CPU tests hold the plain versions against the
JAX package). The file imports neither jax nor the shared test helpers, so
it runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Shapes are small and ragged (not multiples of the kernels' tiles), so the
edge masking is exercised; ``chip_smoke.py`` repeats the comparison at the
full shapes of the demo_3d slice.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 77, 3, 64), (1, 130, 2, 64), (3, 64, 1, 64),
                                   (1, 130, 1, 512), (2, 200, 1, 512)])
def test_flash_attention_matches_plain(gen, shape):
    from diffuman4d_torch.ops import flash_attention as fa

    # batch row 0: logits ~ N(0, 1), a nearly uniform softmax and small
    # outputs; rows 1+: q scaled by 3, a few keys carry each query row
    q = _randn(gen, *shape)
    q[1:] *= 3.0
    q, k, v = q.bfloat16(), _randn(gen, *shape).bfloat16(), _randn(gen, *shape).bfloat16()
    fn = fa.flash_attention_d64 if shape[-1] == 64 else fa.flash_attention_d512
    before = fn.launches
    got = fn(q, k, v).float()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    blocks = fa.SKEW_DEFAULT if shape[-1] == 64 else ()
    assert (shape[0], shape[1], shape[1], shape[2], *blocks) in fn.shapes
    want = fa.attention_plain(q, k, v).float()
    # bf16 output; the kernel rounds the unnormalised P to bf16 where the
    # plain version rounds the normalised one: each batch row within 4 bf16
    # ulps of its largest output
    err = (got - want).abs().amax(dim=(1, 2, 3))
    assert (err <= 2 ** -5 * want.abs().amax(dim=(1, 2, 3))).all()


@pytest.mark.cuda
def test_flash_attention_cross_lengths_and_large_logits(gen):
    from diffuman4d_torch.ops import flash_attention as fa

    q = _randn(gen, 1, 50, 2, 64, scale=6.0).bfloat16()
    k = _randn(gen, 1, 190, 2, 64, scale=6.0).bfloat16()
    v = _randn(gen, 1, 190, 2, 64).bfloat16()
    got = fa.flash_attention_d64(q, k, v).float()
    want = fa.attention_plain(q, k, v).float()
    assert torch.isfinite(got).all()
    # logits of order 100: near-one-hot rows, same bf16 bound
    assert (got - want).abs().max().item() <= 2 ** -5 * want.abs().max().item()


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take(gen):
    from diffuman4d_torch.ops import flash_attention as fa

    q = _randn(gen, 1, 8, 1, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_d64(q, q, q)  # fp32
    qb = q.bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention_d512(qb, qb, qb)  # wrong head dim


def _attn_inputs(gen, B, Sq, Sk, H):
    """q, k, v in bf16; batch row 0 near-uniform, rows 1+ peaked logits."""
    q = _randn(gen, B, Sq, H, 64)
    q[1:] *= 3.0
    return q.bfloat16(), _randn(gen, B, Sk, H, 64).bfloat16(), _randn(gen, B, Sk, H, 64).bfloat16()


def _batch_row_rel_err(got, want):
    """Largest error of each batch row over its largest output."""
    err = (got.float() - want.float()).abs().amax(dim=(1, 2, 3))
    return (err / want.float().abs().amax(dim=(1, 2, 3))).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 77, 77, 3), (2, 130, 200, 2), (3, 256, 256, 1),
                                       (2, 300, 17, 2), (2, 200, 600, 2), (1, 1024, 1024, 2),
                                       (2, 90, 1000, 1), (1, 130, 4096, 2)])
@pytest.mark.parametrize("block_q", [64, 128])
def test_flash_single_pass_matches_plain(gen, B, Sq, Sk, H, block_q):
    """B8 at both block_q, ragged, Sq != Sk, both chunk sizes (128, 256),
    rows resident in shared memory (Sk <= 768) and streamed (Sk > 768)."""
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = _attn_inputs(gen, B, Sq, Sk, H)
    fn = fa.flash_attention_single_pass
    before = fn.launches
    got = fn(q, k, v, block_q=block_q)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and (B, Sq, Sk, H, block_q) in fn.shapes
    # the unnormalised P is rounded to bf16 where the plain version rounds
    # the normalised one: each batch row within 4 bf16 ulps of its largest output
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,block_q,block_b", [
    (2, 50, 256, 3, 64, 2), (2, 50, 256, 3, 128, 3), (2, 100, 90, 3, 64, 6),
    (4, 64, 128, 2, 128, 2), (1, 33, 120, 8, 64, 4), (2, 300, 700, 5, 128, 5),
    (4, 1024, 1024, 2, 128, 8), (2, 257, 1500, 2, 64, 2)])
def test_flash_single_pass_batched_matches_plain(gen, B, Sq, Sk, H, block_q, block_b):
    """B9: block_b rows of (batch, head) per block, block_b dividing only
    B*H; rows resident (the next row's loads under this row's work) and
    streamed."""
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = _attn_inputs(gen, B, Sq, Sk, H)
    fn = fa.flash_attention_single_pass_batched
    got = fn(q, k, v, block_q=block_q, block_b=block_b)
    torch.cuda.synchronize()
    assert (B, Sq, Sk, H, block_q, block_b) in fn.shapes
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(64, 128, 64), (128, 128, 64), (128, 256, 64),
                                    (128, 256, 128), (192, 128, 64), (192, 256, 64)])
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 300, 530, 2), (2, 64, 64, 1), (1, 1000, 1000, 2),
                                       (1, 77, 2100, 2), (2, 500, 40, 1)])
def test_flash_skew_matches_plain(gen, blocks, B, Sq, Sk, H):
    """B1/B2 at every built staging: ragged k-major tiles, Sq != Sk, an odd
    and an even number of score chunks, one chunk only."""
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = _attn_inputs(gen, B, Sq, Sk, H)
    fn = fa.flash_attention_d64
    got = fn(q, k, v, *blocks)
    torch.cuda.synchronize()
    assert (B, Sq, Sk, H, *blocks) in fn.shapes
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,params", [
    ("flash_d64", {"block_q": 128, "block_k_major": 128, "block_k": 64}),
    ("flash_d64", {"block_q": 192, "block_k_major": 256, "block_k": 64}),
    ("single_pass", {"block_q": 64}), ("single_pass_batched", {"block_q": 128, "block_b": 2})])
def test_new_kernels_keep_to_each_batch_with_large_logits(gen, kernel, params):
    """B1/B2 and B8/B9 on B = 4 batches of different scale, K and V followed
    by NaN in memory, Sq != Sk, then on logits of order 100 (q and k scaled
    by 6): finite, each batch within the bound."""
    from diffuman4d_torch.ops import flash_attention as fa

    fn = fa.KERNELS[kernel]
    q, k, v = _per_batch_scaled_inputs(gen, 4, 190, 333, 2)
    got = fn(q, k, v, **params)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5
    q = _randn(gen, 2, 70, 2, 64, scale=6.0).bfloat16()
    k = _randn(gen, 2, 530, 2, 64, scale=6.0).bfloat16()
    v = _randn(gen, 2, 530, 2, 64).bfloat16()
    got = fn(q, k, v, **params).float()
    want = fa.attention_plain(q, k, v).float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2 ** -5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(64, 128, 64), (64, 256, 64), (64, 256, 128),
                                    (128, 128, 64), (128, 256, 64), (128, 256, 128),
                                    (192, 128, 64), (192, 256, 64)])
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 300, 530, 2), (2, 64, 64, 1), (1, 1000, 1000, 2)])
def test_flash_two_level_matches_plain(gen, blocks, B, Sq, Sk, H):
    """B10 at every built staging, with ragged k-major tiles and Sq != Sk."""
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = _attn_inputs(gen, B, Sq, Sk, H)
    fn = fa.flash_attention_two_level
    got = fn(q, k, v, *blocks)
    torch.cuda.synchronize()
    assert (B, Sq, Sk, H, *blocks) in fn.shapes
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


def _per_batch_scaled_inputs(gen, B, Sq, Sk, H):
    """q, k, v in bf16 whose batches differ in scale (k by 0.5 (b + 1), v by
    2^b plus an offset b), so a tile that read another batch's tokens would
    show in that batch's error. K and V are views into buffers that hold
    NaN past their last token: a read past the tensor's end would reach the
    output through the PV product."""
    q, k, v = _attn_inputs(gen, B, Sq, Sk, H)
    scale = torch.arange(B, device="cuda", dtype=torch.float32)
    k = (k.float() * (0.5 * (scale + 1)).view(B, 1, 1, 1)).bfloat16()
    v = (v.float() * (2 ** scale).view(B, 1, 1, 1) + scale.view(B, 1, 1, 1)).bfloat16()
    padded = []
    for x in (k, v):
        buf = torch.full((x.numel() + 8192,), float("nan"), device="cuda", dtype=torch.bfloat16)
        buf[: x.numel()] = x.flatten()
        padded.append(buf[: x.numel()].view(x.shape))
    return (q, *padded)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(64, 128, 64), (64, 256, 64), (64, 256, 128),
                                    (128, 128, 64), (128, 256, 64), (128, 256, 128),
                                    (192, 128, 64), (192, 256, 64)])
def test_flash_two_level_keeps_to_each_batch(gen, blocks):
    """B10 at every staging on B = 4 batches of different scale, Sq != Sk and
    Sk (333) not a multiple of any tile: each batch within the bound."""
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = _per_batch_scaled_inputs(gen, 4, 190, 333, 2)
    got = fa.flash_attention_two_level(q, k, v, *blocks)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.cuda
def test_hopper_wgmma_probe_matches_torch(gen):
    """The TMA and wgmma pieces of csrc/flash_attn_hopper.cu on one tile:
    S = Q K^T from two 128-byte-swizzled K-major shared-memory operands, then
    O = bf16(S) V with P from registers and V as the MN-major operand."""
    from diffuman4d_torch.ops import cuda_build

    q = _randn(gen, 1, 64, 1, 64).bfloat16()
    k, v = (_randn(gen, 1, 128, 1, 64).bfloat16() for _ in range(2))
    s = torch.empty((64, 128), device="cuda")
    o = torch.empty((64, 64), device="cuda")
    fn = cuda_build.entry("flash_attn_hopper", "flash_attn_hopper_probe")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "flash_attn_hopper_probe")
    torch.cuda.synchronize()
    # bf16 products are exact in fp32; the sums run in another order
    want_s = q[0, :, 0].float() @ k[0, :, 0].float().T
    assert (s - want_s).abs().max().item() <= 1e-4 * want_s.abs().max().item()
    want_o = s.bfloat16().float() @ v[0, :, 0].float()
    assert (o - want_o).abs().max().item() <= 1e-4 * want_o.abs().max().item()


@pytest.mark.cuda
def test_flash_fwd_lse_keeps_to_each_batch(gen):
    """B5 on the inputs of test_flash_two_level_keeps_to_each_batch: out and
    L2 of every batch against the plain version."""
    from diffuman4d_torch.ops import flash_backward as fb

    q, k, v = _per_batch_scaled_inputs(gen, 4, 190, 333, 2)
    qs = fb.scale_q(q)
    out, l2 = fb.flash_fwd_lse(qs, k, v)
    out_p, l2_p = fb.flash_fwd_lse_plain(qs, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(l2).all()
    assert _row_rel_err(out, out_p) <= 2 ** -5
    assert (l2 - l2_p).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_single_pass_and_two_level_refuse_what_they_were_not_built_for(gen):
    from diffuman4d_torch.ops import flash_attention as fa

    q = _randn(gen, 1, 300, 2, 64).bfloat16()
    long = _randn(gen, 1, 4100, 1, 64).bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass(long, long, long)  # Sk 4,100 > 4,096
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass(q, q, q, block_q=32)
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass_batched(q[:, :64], q[:, :64], q[:, :64], 64, 3)
    with pytest.raises(ValueError):
        fa.flash_attention_d64(q, q, q, 64, 256, 128)
    with pytest.raises(ValueError):
        fa.flash_attention_two_level(q, q, q, 64, 512, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_two_level(q.float(), q.float(), q.float())


@pytest.mark.cuda
def test_auto_dispatch_follows_the_committed_table(gen):
    """Each hot shape of the table, cut in rows, goes to the kernel that
    route() names, and only there."""
    from diffuman4d_torch.ops import attention as attn, flash_attention as fa

    for e in attn._dispatch_table():
        if e["d"] != 64:
            continue
        b, s, h = 1, min(e["s"], 512), max(1, e["b"] * e["h"] // 64)
        q, k, v = _attn_inputs(gen, b, s, s, h)
        name, params = attn.route(q.shape, k.shape)
        before = {n: f.launches for n, f in fa.KERNELS.items()}
        got = attn.dot_product_attention(q, k, v)
        after = {n: f.launches - before[n] for n, f in fa.KERNELS.items()}
        assert after == {n: int(n == name) for n in fa.KERNELS}, (e["name"], name, after)
        assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


def _train_inputs(gen, B, Sq, Sk, H):
    """q, k, v, dO in bf16; batch row 0 near-uniform, rows 1+ peaked logits."""
    q = _randn(gen, B, Sq, H, 64)
    q[1:] *= 3.0
    return (q.bfloat16(), _randn(gen, B, Sk, H, 64).bfloat16(),
            _randn(gen, B, Sk, H, 64).bfloat16(), _randn(gen, B, Sq, H, 64).bfloat16())


def _row_rel_err(got, want):
    """Largest error of each batch row over its largest reference entry."""
    dims = tuple(range(1, want.dim()))
    return ((got.float() - want.float()).abs().amax(dim=dims)
            / want.float().abs().amax(dim=dims)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 77, 77, 3), (2, 130, 190, 2), (3, 64, 64, 1),
                                       (2, 200, 50, 2), (1, 1, 300, 1), (3, 300, 530, 2)])
def test_flash_train_kernels_match_plain(gen, B, Sq, Sk, H):
    """B5 (out, L2) and the fused backward (dQ, dK, dV; B6 + B7) each against
    its plain version on the same inputs, ragged and Sq != Sk."""
    from diffuman4d_torch.ops import flash_backward as fb

    q, k, v, dout = _train_inputs(gen, B, Sq, Sk, H)
    qs = fb.scale_q(q)
    counts = [f.launches for f in (fb.flash_fwd_lse, fb.flash_bwd)]
    out, l2 = fb.flash_fwd_lse(qs, k, v)
    out_p, l2_p = fb.flash_fwd_lse_plain(qs, k, v)
    # bf16 outputs: 4 ulps of the row's largest entry; L2 is fp32, sums differ in order
    assert _row_rel_err(out, out_p) <= 2 ** -5
    assert (l2 - l2_p).abs().max().item() <= 1e-3
    delta = fb.attention_delta(out_p, dout)
    got = fb.flash_bwd(qs, k, v, dout, l2_p, delta)
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.flash_fwd_lse, fb.flash_bwd)] == [c + 1 for c in counts]
    assert (B, Sq, Sk, H) in fb.flash_bwd.shapes
    # same roundings on both sides (bf16 P and dS, fp32 sums in another
    # order): 4 bf16 ulps of each batch row's largest gradient entry
    for name, g, want in zip(("dq", "dk", "dv"), got, fb.flash_bwd_plain(qs, k, v, dout, l2_p,
                                                                        delta)):
        assert g.shape == want.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g).all(), name
        assert _row_rel_err(g, want) <= 2 ** -5, name


@pytest.mark.cuda
def test_flash_bwd_keeps_to_each_batch(gen):
    """The fused backward on B = 4 batches of different scale whose K and V
    are followed by NaN in memory, Sq != Sk, neither a multiple of a tile:
    every batch within the bound of its plain version."""
    from diffuman4d_torch.ops import flash_backward as fb

    q, k, v = _per_batch_scaled_inputs(gen, 4, 190, 333, 2)
    dout = _randn(gen, 4, 190, 2, 64).bfloat16()
    qs = fb.scale_q(q)
    out, l2 = fb.flash_fwd_lse_plain(qs, k, v)
    delta = fb.attention_delta(out, dout)
    got = fb.flash_bwd(qs, k, v, dout, l2, delta)
    torch.cuda.synchronize()
    for name, g, want in zip(("dq", "dk", "dv"), got, fb.flash_bwd_plain(qs, k, v, dout, l2,
                                                                        delta)):
        assert torch.isfinite(g).all(), name
        assert _row_rel_err(g, want) <= 2 ** -5, name


@pytest.mark.cuda
def test_flash_bwd_is_bit_repeatable_over_many_key_blocks(gen):
    """B1 S4096 H4: 32 key blocks of 128 per head add their dQ partials in
    turn; three launches give the same dQ, dK and dV bit for bit."""
    from diffuman4d_torch.ops import flash_backward as fb

    q, k, v, dout = _train_inputs(gen, 1, 4096, 4096, 4)
    qs = fb.scale_q(q)
    out, l2 = fb.flash_fwd_lse(qs, k, v)
    delta = fb.attention_delta(out, dout)
    runs = [fb.flash_bwd(qs, k, v, dout, l2, delta) for _ in range(3)]
    torch.cuda.synchronize()
    for name, first, *again in zip(("dq", "dk", "dv"), *runs):
        assert torch.isfinite(first).all(), name
        assert all(torch.equal(first, x) for x in again), name


@pytest.fixture
def bwd_probe(gen):
    """The five products of csrc/flash_attn_bwd.cu on one tile (see
    bwd_probe_kernel), with qs, dO (64 rows) and K, V (128 rows)."""
    from diffuman4d_torch.ops import cuda_build

    qs, dout = (_randn(gen, 1, 64, 1, 64).bfloat16() for _ in range(2))
    k, v = (_randn(gen, 1, 128, 1, 64).bfloat16() for _ in range(2))
    out = torch.empty((5, 64, 64), device="cuda")
    fn = cuda_build.entry("flash_attn_bwd", "flash_attn_bwd_probe")
    rc = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "flash_attn_bwd_probe")
    torch.cuda.synchronize()
    return out, *(x[0, :, 0].float() for x in (qs, k, v, dout))


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["s_t", "dp_t", "dv", "dk", "dq_mn_major"])
def test_fused_backward_probe_products_match_torch(bwd_probe, product):
    """Each wgmma form of the fused backward alone: S^T = K Qs^T and
    dP^T = V dO^T (K-major shared-memory operands), bf16(S^T) dO and
    bf16(dP^T) Qs (A from registers, B MN-major), and T^T K with T the
    128 x 64 stack of both, stored by the threads with the 128-byte swizzle
    and read back as an MN-major A operand across 8 swizzle atoms, then
    written out as a dQ partial is: through the swizzled fp32 staging tile
    and two TMA tensor stores."""
    out, qs, k, v, dout = bwd_probe
    bf = out.bfloat16().float()  # the kernel's own products, rounded as it rounds them
    want = {"s_t": k[:64] @ qs.T, "dp_t": v[:64] @ dout.T, "dv": bf[0] @ dout,
            "dk": bf[1] @ qs, "dq_mn_major": torch.cat([bf[0], bf[1]]).T @ k}[product]
    got = out[["s_t", "dp_t", "dv", "dk", "dq_mn_major"].index(product)]
    # bf16 products are exact in fp32; the sums run in another order
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_flash_attention_train_autograd_and_repeatable(gen):
    """The autograd Function end to end (non-contiguous dO included, ragged
    S) against fp32 autograd through plain attention and against the bf16
    plain version of the Function, one fused backward launch per backward,
    and bit-equal across two runs."""
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops import flash_backward as fb
    from diffuman4d_torch.ops.attention import dot_product_attention

    q, k, v, _ = _train_inputs(gen, 2, 150, 150, 3)
    w = _randn(gen, 2, 3, 150, 64)  # (B, H, S, D): the cotangent arrives permuted

    def grads(fn, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        (fn(*xs).float().permute(0, 2, 1, 3) * w).sum().backward()
        return [x.grad for x in xs]

    before = fb.flash_bwd.launches
    got = grads(lambda *a: dot_product_attention(*a, implementation="train"), q, k, v)
    assert fb.flash_bwd.launches == before + 1
    again = grads(lambda *a: dot_product_attention(*a, implementation="train"), q, k, v)
    want = grads(fa.attention_plain, q.float(), k.float(), v.float())
    plain = grads(fb.flash_attention_train_plain, q, k, v)
    for g, g2, r, p in zip(got, again, want, plain):
        assert torch.equal(g, g2)
        # bf16 kernel vs fp32 reference: bf16 resolution of the largest entry,
        # plus the bf16-rounded softmax scale of the base-2 form
        assert _row_rel_err(g, r) <= 2 ** -4
        # vs the same Function's plain version: the same roundings
        assert _row_rel_err(g, p) <= 2 ** -5
    with pytest.raises(ValueError):
        dot_product_attention(q.float(), k.float(), v.float(), implementation="train")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,cin,cout,affine,res", [
    (2, 13, 11, 40, 24, True, True),
    (1, 9, 130, 64, 136, True, False),
    (1, 17, 5, 8, 8, False, False),
    (2, 33, 20, 136, 128, True, True),
])
def test_conv3x3_matches_plain(gen, B, H, W, cin, cout, affine, res):
    from diffuman4d_torch.ops import conv

    x = _randn(gen, B, H, W, cin).bfloat16()
    w = _randn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    b = _randn(gen, cout, scale=0.1)
    kw = {}
    if affine:
        kw = dict(scale=1 + _randn(gen, B, cin, scale=0.1), shift=_randn(gen, B, cin, scale=0.1),
                  silu=True)
    if res:
        kw["residual"] = _randn(gen, B, H, W, cout).bfloat16()
    before = conv.conv3x3.launches
    got = conv.conv3x3(x, w, b, **kw).float()
    torch.cuda.synchronize()
    assert conv.conv3x3.launches == before + 1
    assert (B, H, W, cin, cout, affine, affine, res) in conv.conv3x3.shapes
    want = conv.conv3x3_plain(x, w, b, **kw).float()
    # bf16 outputs of O(1); fp32 sums in another order, and an activation
    # may round to the neighbouring bf16 value: a few bf16 ulps
    assert (got - want).abs().max().item() < 2 ** -6 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_conv3x3_rejects_unaligned_channels(gen):
    from diffuman4d_torch.ops import conv

    x = _randn(gen, 1, 8, 8, 12).bfloat16()
    with pytest.raises(ValueError):
        conv.conv3x3(x, _randn(gen, 8, 12, 3, 3), _randn(gen, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H", [(2, 150, 333, 1), (1, 100, 70, 2), (3, 65, 129, 1)])
def test_flash_d512_ragged_cross_lengths_and_large_logits(gen, B, Sq, Sk, H):
    """B3 with Sq != Sk, neither a multiple of its 64-key tile (a tile whose
    second half of keys is all past Sk included), more than one head, and
    one batch row of logits ~ N(0, 36): each batch row within 4 bf16 ulps of
    its largest output. K and V are followed by NaN in memory."""
    from diffuman4d_torch.ops import flash_attention as fa

    q = _randn(gen, B, Sq, H, 512)
    q[-1] *= 6.0
    q = q.bfloat16()
    kv = []
    for _ in range(2):
        x = _randn(gen, B, Sk, H, 512).bfloat16()
        buf = torch.full((x.numel() + 65536,), float("nan"), device="cuda", dtype=torch.bfloat16)
        buf[: x.numel()] = x.flatten()
        kv.append(buf[: x.numel()].view(x.shape))
    k, v = kv
    got = fa.flash_attention_d512(q, k, v)
    torch.cuda.synchronize()
    assert (B, Sq, Sk, H) in fa.flash_attention_d512.shapes
    assert torch.isfinite(got).all()
    assert _batch_row_rel_err(got, fa.attention_plain(q, k, v)) <= 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(1, 37), (2, 37), (5, 70)])
def test_conv3x3_padding_is_zero_after_the_prologue(gen, H, W):
    """A shift of about 2 makes silu(shift) ~ 1.8, far from 0: a kernel that
    transformed its zero padding instead of zeroing it after the prologue
    would be off by O(1) at every edge pixel. W is not a multiple of the
    kernel's 32-column tile, and H = 1, 2 leave most of its 4-row tile
    outside the image."""
    from diffuman4d_torch.ops import conv

    B, cin, cout = 2, 64, 136
    x = _randn(gen, B, H, W, cin).bfloat16()
    w = _randn(gen, cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    b = _randn(gen, cout, scale=0.1)
    kw = dict(scale=1 + _randn(gen, B, cin, scale=0.1), shift=2 + _randn(gen, B, cin, scale=0.1),
              silu=True, residual=_randn(gen, B, H, W, cout).bfloat16())
    got = conv.conv3x3(x, w, b, **kw).float()
    want = conv.conv3x3_plain(x, w, b, **kw).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 2 ** -6 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_vae_kernels_repeat_bit_for_bit(gen):
    """B3 and B4 are deterministic: two launches on the same inputs give the
    same bits (no atomics, sums in a fixed order)."""
    from diffuman4d_torch.ops import conv
    from diffuman4d_torch.ops import flash_attention as fa

    q, k, v = (_randn(gen, 2, 300, 1, 512).bfloat16() for _ in range(3))
    assert torch.equal(fa.flash_attention_d512(q, k, v), fa.flash_attention_d512(q, k, v))
    x = _randn(gen, 2, 19, 45, 192).bfloat16()
    w = _randn(gen, 256, 192, 3, 3, scale=(9 * 192) ** -0.5)
    b = _randn(gen, 256, scale=0.1)
    kw = dict(scale=1 + _randn(gen, 2, 192, scale=0.1), shift=_randn(gen, 2, 192, scale=0.1),
              silu=True)
    assert torch.equal(conv.conv3x3(x, w, b, **kw), conv.conv3x3(x, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,groups", [
    (2, 13, 11, 320, 32),  # C / G = 10: vectors of 8 channels cross groups
    (3, 9, 7, 960, 32),  # 30 channels a group
    (1, 33, 20, 128, 32),  # the VAE's 4 channels a group
    (2, 5, 3, 12, 4),  # 12 channels: not a whole vector, one channel a thread
    (1, 1, 1, 40, 8),  # one pixel, one chunk
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
def test_groupnorm_matches_plain(gen, B, H, W, C, groups, dtype, silu):
    from diffuman4d_torch.ops import groupnorm as gn
    from diffuman4d_torch.utils.tracing import counters

    x = (_randn(gen, B, H, W, C) * 2 + 0.5).to(dtype)
    w, b = (1 + _randn(gen, C, scale=0.2)).to(dtype), _randn(gen, C, scale=0.2).to(dtype)
    before = (gn.groupnorm_stats.launches, gn.groupnorm_apply.launches,
              counters().get("groupnorm/kernel", 0))
    got = gn.group_norm(x, w, b, groups, 1e-5, silu=silu)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert (gn.groupnorm_stats.launches, gn.groupnorm_apply.launches,
            counters().get("groupnorm/kernel", 0)) == tuple(n + 1 for n in before)
    assert (B, H, W, C, groups) in gn.groupnorm_stats.shapes
    want = gn.group_norm_plain(x, w, b, groups, 1e-5, silu).float()
    # 16-bit: the plain version rounds before SiLU and after it, the kernel
    # once; fp32: statistics summed in another order
    tol = 1e-5 if dtype == torch.float32 else 2 ** -5
    assert ((got.float() - want).abs() <= tol * want.abs().clamp_min(1.0)).all()


@pytest.mark.cuda
def test_groupnorm_affine_matches_plain_and_repeats(gen):
    """The statistics alone (the fused conv's prologue affine): fp32 scale
    and shift close to the plain version's, the same bits on every launch,
    with bf16 or fp32 parameters."""
    from diffuman4d_torch.ops import groupnorm as gn

    x = (_randn(gen, 2, 37, 29, 256) * 3 + 1.0).bfloat16()
    for pdtype in (torch.bfloat16, torch.float32):
        g, b = (1 + _randn(gen, 256, scale=0.2)).to(pdtype), _randn(gen, 256).to(pdtype)
        scale, shift = gn.groupnorm_affine(x, g, b, 32, 1e-6)
        ws, wsh = gn.groupnorm_affine_plain(x, g, b, 32, 1e-6)
        assert scale.dtype == shift.dtype == torch.float32 and scale.shape == (2, 256)
        torch.testing.assert_close(scale, ws, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(shift, wsh, rtol=1e-5, atol=1e-5)
        again = gn.groupnorm_affine(x, g, b, 32, 1e-6)
        assert torch.equal(scale, again[0]) and torch.equal(shift, again[1])


@pytest.mark.cuda
def test_groupnorm_with_grad_takes_the_plain_version(gen):
    """Only an autograd call keeps the eager path: its gradients flow, and no
    kernel launches."""
    from diffuman4d_torch.models.layers import GroupNorm
    from diffuman4d_torch.ops import groupnorm as gn

    norm = GroupNorm(64, 32).cuda()
    x = _randn(gen, 2, 6, 5, 64).requires_grad_()
    before = gn.groupnorm_stats.launches
    norm(x, silu=True).sum().backward()
    assert gn.groupnorm_stats.launches == before
    assert x.grad is not None and norm.weight.grad is not None
    with torch.no_grad():
        norm(x, silu=True)
    assert gn.groupnorm_stats.launches == before + 1
