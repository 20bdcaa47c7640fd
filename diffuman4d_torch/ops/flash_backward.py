"""Differentiable flash attention at head dim 64: forward with logsumexp and
a hand-written backward, on Hopper, with the plain PyTorch version beside it.

Counterpart of ``diffuman4d_tpu/ops/flash_backward.py``. Two kernel
wrappers, each with its plain version:

* :func:`flash_fwd_lse` replaces ``_fwd`` / ``_fwd_kernel`` (TPU kernel B5):
  the output and the per-query base-2 logsumexp ``L2``
  (``csrc/flash_attn_hopper.cu``, the TMA / wgmma forward of B10 with its L2
  output on, at the one staging :data:`FWD_LSE_BLOCKS`);
* :func:`flash_bwd` replaces both kernels of ``_bwd_impl``, ``_dkdv_kernel``
  (B6) and ``_dq_kernel`` (B7): dQ, dK and dV in one fused TMA / wgmma
  kernel (``csrc/flash_attn_bwd.cu``) that adds the dQ partials of its key
  blocks in a fixed order, so its result is bit-repeatable.

:func:`flash_attention_train` ties them into one ``autograd.Function`` on
``(B, S, H, 64)``. As in the JAX package, scores run in base 2: the wrapper
makes ``Qs = round(Q * log2(e)/sqrt(d))`` in the input dtype once and both
kernels score with it, so the backward recomputes exactly the P the
forward normalised; ``dK = ln2 * dS^T Qs`` and ``dQ = dS K / sqrt(d)``. P and
dS are rounded to the input dtype before their products, accumulation is
fp32, and ``delta = rowsum(dO * O)`` is plain torch. ``L2`` and ``delta``
are ``(B, H, Sq)`` fp32.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in ``.launches`` and, per
``(B, Sq, Sk, H)`` it launched at, in the counter ``.shapes``.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from diffuman4d_torch.ops import cuda_build

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
HEAD_DIM = 64
# (block_q, block_k_major, block_k) of the training forward's one staging
# (LSE_BLOCK_* of csrc/flash_attn_hopper.cu), chosen from a sweep of the
# two-level stagings at the train step's attention shapes on the H100
FWD_LSE_BLOCKS = (192, 256, 64)
# queries per streamed block of the fused backward (BQ of csrc/flash_attn_bwd.cu):
# the size of its per-query-block semaphores
BWD_BLOCK_Q = 64


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """``Qs``: Q times log2(e)/sqrt(d), constant and product both rounded to
    Q's dtype (the JAX package's ``_flash_train_fwd``)."""
    c = torch.tensor(_LOG2E / math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
    return q * c


def _scores2(qs: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())


# ------------------------------------------------------------ plain versions
def flash_fwd_lse_plain(qs, k, v):
    """(out (B, Sq, H, D), L2 (B, H, Sq) fp32) from pre-scaled ``qs``."""
    s2 = _scores2(qs, k)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    norm = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(qs.dtype).float(), v.float())
    out = out / norm.permute(0, 2, 1)[..., None]
    return out.to(qs.dtype), m[..., 0] + torch.log2(norm)


def _ds_plain(qs, k, v, dout, l2, delta):
    p = torch.exp2(_scores2(qs, k) - l2[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkdv_plain(qs, k, v, dout, l2, delta):
    """(dK, dV), written out as the kernel computes them."""
    p, ds = _ds_plain(qs, k, v, dout, l2, delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(qs.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(qs.dtype).float(), qs.float()) * _LN2
    return dk.to(qs.dtype), dv.to(qs.dtype)


def flash_bwd_dq_plain(qs, k, v, dout, l2, delta):
    """dQ (with the 1/sqrt(d)), written out as the kernel computes it."""
    _, ds = _ds_plain(qs, k, v, dout, l2, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(qs.dtype).float(), k.float())
    return (dq / math.sqrt(qs.shape[-1])).to(qs.dtype)


def flash_bwd_plain(qs, k, v, dout, l2, delta):
    """(dQ, dK, dV): the two functions above, as the fused kernel computes them."""
    dk, dv = flash_bwd_dkdv_plain(qs, k, v, dout, l2, delta)
    return flash_bwd_dq_plain(qs, k, v, dout, l2, delta), dk, dv


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, Sq, H, D) x 2 -> (B, H, Sq)."""
    return (out.float() * dout.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


# ---------------------------------------------------------- kernel wrappers
def _check(name: str, qs, k, v, dout=None, l2=None, delta=None):
    """Validate, make contiguous; -> ([tensors], (B, H, Sq, Sk))."""
    for nm, t in (("qs", qs), ("k", k), ("v", v), ("dout", dout)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {nm} must be a bf16 CUDA tensor, got {t.dtype} "
                             f"on {t.device}")
        if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name}: {nm} shape {tuple(t.shape)} is not (B, S, H, {HEAD_DIM})")
    B, Sq, H, _ = qs.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H:
        raise ValueError(f"{name}: qs {tuple(qs.shape)} k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"do not match")
    if dout is not None and dout.shape != qs.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} != qs {tuple(qs.shape)}")
    for nm, t in (("l2", l2), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (B, H, Sq)
                              or t.device != qs.device):
            raise ValueError(f"{name}: {nm} must be fp32 (B, H, Sq) on {qs.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit")
    out = [t if t is None else t.contiguous() for t in (qs, k, v, dout, l2, delta)]
    for t in out:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return out, (B, H, Sq, k.shape[1])


def _call(wrapper, lib: str, fn_name: str, ref: torch.Tensor, sizes, *tensors):
    fn = cuda_build.entry(lib, fn_name)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), *sizes, stream)
    cuda_build.check(rc, fn_name)
    B, H, Sq, Sk = sizes
    cuda_build.count_launch(wrapper, (B, Sq, Sk, H))


def flash_fwd_lse(qs, k, v):
    """Forward from pre-scaled ``qs`` (TPU kernel B5 ``_fwd_kernel``):
    (out, L2). bf16 CUDA tensors launch the kernel at
    :data:`FWD_LSE_BLOCKS`."""
    if qs.device.type == "cpu":
        return flash_fwd_lse_plain(qs, k, v)
    (qs, k, v, *_), sizes = _check("flash_fwd_lse", qs, k, v)
    out = torch.empty_like(qs)
    l2 = torch.empty((sizes[0], sizes[1], sizes[2]), dtype=torch.float32, device=qs.device)
    _call(flash_fwd_lse, "flash_attn_hopper", "flash_attn_fwd_lse", qs, sizes, qs, k, v, out, l2)
    return out, l2


def flash_bwd(qs, k, v, dout, l2, delta):
    """(dQ, dK, dV) in one launch (TPU kernels B6 ``_dkdv_kernel`` and B7
    ``_dq_kernel``). The kernel's scratch, the fp32 dQ sums and the
    semaphores that order them, is allocated here per call."""
    if qs.device.type == "cpu":
        return flash_bwd_plain(qs, k, v, dout, l2, delta)
    (qs, k, v, dout, l2, delta), sizes = _check("flash_bwd", qs, k, v, dout, l2, delta)
    B, H, Sq, _ = sizes
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    dq_accum = torch.empty((B * H, Sq, HEAD_DIM), dtype=torch.float32, device=qs.device)
    sems = torch.empty((1 + B * H * -(-Sq // BWD_BLOCK_Q),), dtype=torch.int32, device=qs.device)
    _call(flash_bwd, "flash_attn_bwd", "flash_attn_bwd_fused", qs, sizes,
          qs, k, v, dout, l2, delta, dq, dk, dv, dq_accum, sems)
    return dq, dk, dv


for _wrapper in (flash_fwd_lse, flash_bwd):
    _wrapper.launches = 0
    _wrapper.shapes = Counter()


# ------------------------------------------------------------- the public op
class _FlashTrain(torch.autograd.Function):
    """forward saves qs, k, v, out, L2; backward makes delta in plain torch
    and calls the backward function it was given."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd):
        qs = scale_q(q)
        out, l2 = fwd(qs, k, v)
        ctx.save_for_backward(qs, k, v, out, l2)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, g):
        qs, k, v, out, l2 = ctx.saved_tensors
        dout = g.to(qs.dtype).contiguous()
        delta = attention_delta(out, dout)
        dq, dk, dv = ctx.bwd(qs, k, v, dout, l2, delta)
        return dq, dk, dv, None, None


def flash_attention_train_plain(q, k, v):
    """The plain version of :func:`flash_attention_train`: the same
    Function with forward and backward written out in tensor ops."""
    return _FlashTrain.apply(q, k, v, flash_fwd_lse_plain, flash_bwd_plain)


def flash_attention_train(q, k, v):
    """Differentiable attention, (B, S, H, 64) -> (B, S, H, 64). CPU tensors
    take the plain version; CUDA tensors launch the two kernels."""
    if q.device.type == "cpu":
        return flash_attention_train_plain(q, k, v)
    return _FlashTrain.apply(q, k, v, flash_fwd_lse, flash_bwd)
