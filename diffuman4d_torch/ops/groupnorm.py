"""GroupNorm (+ SiLU) over NHWC with fp32 statistics, and its plain version.

One routine serves both of the port's GroupNorm call sites:
:func:`group_norm` (``models.layers.GroupNorm``: normalised output, SiLU
optional) and :func:`groupnorm_affine` (the statistics alone, folded into
the per-(batch, channel) affine ``x * scale + shift`` that the fused conv's
prologue applies). Both compute mean and ``var = E[x^2] - mean^2`` (clamped
at 0) per (image, group) in fp32, as the JAX package does, and normalise
through that affine.

A CPU tensor takes the plain versions: :func:`groupnorm_affine_plain`, the
statistics and the fold in eager PyTorch, and :func:`group_norm_plain`,
which applies that affine. A
CUDA tensor launches the kernel pair of ``csrc/groupnorm_hopper.cu`` or
raises: :func:`groupnorm_stats` (one read of x, per-channel fp32 partials,
the folded affine) and, for :func:`group_norm`, :func:`groupnorm_apply` (one
read, one write; SiLU before the single rounding to x's dtype). The one
exception is autograd: with grad enabled and any of x, weight or bias
requiring grad, the call takes the plain version on any device (the kernels
have no backward). Every call is a profiler range ``op/groupnorm`` and adds
one to the tracing counter ``groupnorm/kernel`` or ``groupnorm/plain``; each
kernel wrapper counts its launches in ``.launches`` and, per shape, in
``.shapes``.
"""

from __future__ import annotations

import functools
import struct
from collections import Counter

import torch
import torch.nn.functional as F

from diffuman4d_torch.ops import cuda_build
from diffuman4d_torch.utils.tracing import count, ranged

# the kernels' dtype codes (``Dtype`` in the source)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# chunks per image: enough for this many blocks per SM over the batch (a
# whole number of waves matters less with many blocks), each chunk at least
# MIN_CHUNK_PX pixels
BLOCKS_PER_SM = 16
MIN_CHUNK_PX = 16


def groupnorm_affine_plain(x, gamma, beta, groups: int, eps: float):
    """The statistics in eager PyTorch, folded into a per-(batch, channel)
    affine: ``(x - mean) * rstd * gamma + beta == x * scale + shift``, with
    mean and ``var = E[x^2] - mean^2`` (clamped at 0) per (image, group) in
    fp32."""
    B, H, W, C = x.shape
    xf = x.float()
    s1 = xf.mean(dim=(1, 2))  # (B, C)
    s2 = xf.square().mean(dim=(1, 2))
    mean = s1.reshape(B, groups, -1).mean(dim=-1)  # (B, G)
    var = (s2.reshape(B, groups, -1).mean(dim=-1) - mean.square()).clamp(min=0.0)
    rstd = torch.rsqrt(var + eps)
    rep = rstd.repeat_interleave(C // groups, dim=1)  # (B, C)
    mrep = mean.repeat_interleave(C // groups, dim=1)
    scale = rep * gamma.float()[None, :]
    shift = beta.float()[None, :] - mrep * scale
    return scale, shift


def group_norm_plain(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """GroupNorm in eager PyTorch: :func:`groupnorm_affine_plain`'s affine
    applied in fp32, the result cast to x's dtype, then SiLU in that dtype."""
    scale, shift = groupnorm_affine_plain(x, weight, bias, groups, eps)
    y = (x.float() * scale[:, None, None] + shift[:, None, None]).to(x.dtype)
    return F.silu(y) if silu else y


def _plain(x, weight, bias) -> bool:
    """The gate: the plain version on the CPU and wherever autograd needs it."""
    return x.device.type == "cpu" or (torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, weight, bias)))


@ranged("op/groupnorm")  # a profiler range, while one records
def group_norm(x, weight, bias, groups: int, eps: float, *, silu: bool = False):
    """``(silu)(GroupNorm(x) * weight + bias)`` over NHWC ``x`` (B, H, W, C),
    output in x's dtype. On a CUDA tensor the kernel pair, unless grad is
    enabled and x, weight or bias requires grad (then the plain version)."""
    if _plain(x, weight, bias):
        count("groupnorm/plain")
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    count("groupnorm/kernel")
    x = x.contiguous()
    scale, shift = groupnorm_stats(x, weight, bias, groups, eps)
    return groupnorm_apply(x, scale, shift, silu=silu)


@ranged("op/groupnorm")
def groupnorm_affine(x, gamma, beta, groups: int, eps: float):
    """GroupNorm's statistics folded into the fp32 ``(scale, shift)``, each
    (B, C), for the fused conv's prologue. The same gate as
    :func:`group_norm`."""
    if _plain(x, gamma, beta):
        count("groupnorm/plain")
        return groupnorm_affine_plain(x, gamma, beta, groups, eps)
    count("groupnorm/kernel")
    return groupnorm_stats(x.contiguous(), gamma, beta, groups, eps)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_chunks(B: int, HW: int, sms: int) -> int:
    """Pixel chunks per image, one block each in both kernels: about
    ``BLOCKS_PER_SM`` blocks per SM over the batch, no chunk under
    ``MIN_CHUNK_PX`` pixels (one chunk where the image is smaller)."""
    want = -(-BLOCKS_PER_SM * sms // B)
    return max(1, min(want, HW // MIN_CHUNK_PX))


def _check(x, groups: int, *params) -> tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"groupnorm: x must be NHWC, got shape {tuple(x.shape)}")
    B, H, W, C = x.shape
    if groups <= 0 or C % groups:
        raise ValueError(f"groupnorm: {C} channels do not split into {groups} groups")
    if x.dtype not in DTYPES:
        raise ValueError(f"groupnorm kernels take {sorted(map(str, DTYPES))}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm kernels need a contiguous x")
    for p in params:
        if p.device != x.device or not p.is_contiguous():
            raise ValueError("groupnorm: parameters must be contiguous, on x's device")
    return B, H, W, C


def groupnorm_stats(x, weight, bias, groups: int, eps: float):
    """The statistics kernel and its finalize: fp32 ``(scale, shift)``, each
    (B, C), of contiguous CUDA ``x``."""
    B, H, W, C = _check(x, groups, weight, bias)
    if weight.shape != (C,) or bias.shape != (C,) or weight.dtype not in DTYPES \
            or bias.dtype != weight.dtype:
        raise ValueError("groupnorm: weight and bias must be (C,) of one float dtype")
    dev = x.device
    nch = n_chunks(B, H * W, _sm_count(dev.index if dev.index is not None else 0))
    partial = torch.empty((B, nch, 2, C), dtype=torch.float32, device=dev)
    scale = torch.empty((B, C), dtype=torch.float32, device=dev)
    shift = torch.empty_like(scale)
    eps_bits = struct.unpack("<i", struct.pack("<f", eps))[0]
    fn = cuda_build.entry("groupnorm_hopper", "groupnorm_stats")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), partial.data_ptr(),
                scale.data_ptr(), shift.data_ptr(), B, H * W, C, groups, nch, DTYPES[x.dtype],
                DTYPES[weight.dtype], eps_bits, stream)
    cuda_build.check(rc, "groupnorm_stats")
    cuda_build.count_launch(groupnorm_stats, (B, H, W, C, groups))
    return scale, shift


def groupnorm_apply(x, scale, shift, *, silu: bool = False):
    """The apply kernel: ``(silu)(x * scale + shift)`` in fp32, stored in
    x's dtype; ``scale`` and ``shift`` are fp32 (B, C)."""
    B, H, W, C = _check(x, 1, scale, shift)
    if scale.shape != (B, C) or shift.shape != (B, C) or scale.dtype != torch.float32 \
            or shift.dtype != torch.float32:
        raise ValueError("groupnorm: scale and shift must be fp32 (B, C)")
    dev = x.device
    nch = n_chunks(B, H * W, _sm_count(dev.index if dev.index is not None else 0))
    out = torch.empty_like(x)
    fn = cuda_build.entry("groupnorm_hopper", "groupnorm_apply")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), B, H * W, C,
                nch, DTYPES[x.dtype], int(silu), stream)
    cuda_build.check(rc, "groupnorm_apply")
    cuda_build.count_launch(groupnorm_apply, (B, H, W, C, bool(silu)))
    return out


# launch counts, in total and per (B, H, W, C, groups) / (B, H, W, C, silu)
groupnorm_stats.launches = 0
groupnorm_stats.shapes = Counter()
groupnorm_apply.launches = 0
groupnorm_apply.shapes = Counter()
