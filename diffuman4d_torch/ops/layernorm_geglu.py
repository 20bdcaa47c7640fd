"""LayerNorm and the GEGLU gate of the transformer blocks, and their plain
versions.

:func:`layer_norm` is ``LayerNorm32``'s normalisation: statistics over the
last dim in fp32, the weight and bias upcast, the result in x's dtype.
:func:`geglu` is ``GEGLU``'s gate on the projection's output ``proj``
(..., 2I): ``hidden * gelu(gate)`` with the exact erf GELU in fp32, rounded to
the input dtype before the product.

The plain versions (:func:`layer_norm_plain`, :func:`geglu_plain`) are the
expressions the modules have always run. A CUDA tensor launches the kernels
of ``csrc/layernorm_geglu_hopper.cu`` instead (fp32, bf16 or fp16, the
LayerNorm's weight and bias of x's dtype), each one read of its input and
one write in its dtype with every intermediate in registers:
:func:`layernorm_kernel` (within one ulp of the plain version: fp32 sums in
another order) and :func:`geglu_kernel` (the plain version's bits). The gate
sends a call to the plain version on the CPU, with grad enabled and an input
(or the LayerNorm's weight or bias) requiring grad (the kernels have no
backward), and at a width that is not a multiple of 8 (the tiny test
models'); the kernel wrappers raise on what else they do not take. Every
call is a profiler range ``op/layernorm`` or ``op/geglu`` and adds one to
the tracing counter ``layernorm/kernel`` or ``layernorm/plain``
(``geglu/...`` likewise); each kernel wrapper counts its launches in
``.launches`` and, per shape, in ``.shapes``.
"""

from __future__ import annotations

import struct
from collections import Counter

import torch
import torch.nn.functional as F

from diffuman4d_torch.ops import cuda_build
from diffuman4d_torch.utils.tracing import count, ranged

# the kernels' dtype codes (``Dtype`` in the source)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
WIDTH_MULTIPLE = 8  # the widths the kernels take (16 bytes of bf16)
MAX_ROW_BYTES = 8192  # a LayerNorm row in registers: 32 lanes x 16 vectors of 16 bytes


def layer_norm_plain(x, weight, bias, eps: float):
    """LayerNorm over the last dim in eager PyTorch: x, weight and bias in
    fp32, the result cast to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                        eps).to(x.dtype)


def geglu_plain(proj):
    """``hidden * gelu(gate)`` of ``proj`` = [hidden | gate] in eager
    PyTorch: GELU in fp32, cast to the input dtype, then the product."""
    hidden, gate = proj.chunk(2, dim=-1)
    return hidden * F.gelu(gate.float()).to(hidden.dtype)


def _plain(x, width: int, *params) -> bool:
    """The gate: the plain version on the CPU, wherever autograd needs it,
    and at a width the kernels do not take."""
    return x.device.type == "cpu" or width % WIDTH_MULTIPLE != 0 or (
        torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)))


@ranged("op/layernorm")  # a profiler range, while one records
def layer_norm(x, weight, bias, eps: float):
    """LayerNorm of x over its last dim, output in x's dtype: the kernel on
    a CUDA tensor, unless the gate sends it to the plain version."""
    if _plain(x, x.shape[-1], weight, bias):
        count("layernorm/plain")
        return layer_norm_plain(x, weight, bias, eps)
    count("layernorm/kernel")
    return layernorm_kernel(x.contiguous(), weight, bias, eps)


@ranged("op/geglu")
def geglu(proj):
    """``hidden * gelu(gate)`` of ``proj`` (..., 2I): the kernel on a CUDA
    tensor, unless the gate sends it to the plain version (an odd width
    too)."""
    width = proj.shape[-1]
    if width % 2 or _plain(proj, width // 2):
        count("geglu/plain")
        return geglu_plain(proj)
    count("geglu/kernel")
    return geglu_kernel(proj.contiguous())


def _check(x, what: str, width: int) -> None:
    if width <= 0 or width % WIDTH_MULTIPLE:
        raise ValueError(f"{what}: width {width} is not a positive multiple of "
                         f"{WIDTH_MULTIPLE}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: the kernel takes {sorted(map(str, DTYPES))}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous input")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel needs a 16-byte aligned input")


def layernorm_kernel(x, weight, bias, eps: float):
    """The LayerNorm kernel on contiguous CUDA ``x`` (..., C), weight and
    bias (C,) of x's dtype."""
    C = x.shape[-1] if x.dim() else 0
    if C * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"layernorm: a row of {C} {x.dtype} is above the kernel's "
                         f"{MAX_ROW_BYTES} bytes")
    for p in (weight, bias):
        if p.shape != (C,) or p.dtype != x.dtype or p.device != x.device \
                or not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError("layernorm: weight and bias must be contiguous (C,) of x's dtype "
                             "on x's device")
    _check(x, "layernorm", C)
    rows = x.numel() // C
    out = torch.empty_like(x)
    if rows:
        eps_bits = struct.unpack("<i", struct.pack("<f", eps))[0]
        fn = cuda_build.entry("layernorm_geglu_hopper", "layernorm_fwd")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, C,
                    DTYPES[x.dtype], eps_bits, stream)
        cuda_build.check(rc, "layernorm_fwd")
        cuda_build.count_launch(layernorm_kernel, (rows, C))
    return out


def geglu_kernel(proj):
    """The GEGLU kernel on the contiguous CUDA projection ``proj`` (..., 2I):
    the (..., I) product."""
    width = proj.shape[-1] if proj.dim() else 0
    if width % 2:
        raise ValueError(f"geglu: the projection's width {width} is odd")
    I = width // 2
    _check(proj, "geglu", I)
    rows = proj.numel() // width
    out = proj.new_empty((*proj.shape[:-1], I))
    if rows:
        fn = cuda_build.entry("layernorm_geglu_hopper", "geglu_fwd")
        with torch.cuda.device(proj.device):
            stream = torch.cuda.current_stream(proj.device).cuda_stream
            rc = fn(proj.data_ptr(), out.data_ptr(), rows, I, DTYPES[proj.dtype], stream)
        cuda_build.check(rc, "geglu_fwd")
        cuda_build.count_launch(geglu_kernel, (rows, width))
    return out


# launch counts, in total and per (rows, C) / (rows, 2I)
layernorm_kernel.launches = 0
layernorm_kernel.shapes = Counter()
geglu_kernel.launches = 0
geglu_kernel.shapes = Counter()
