"""Fused 3x3 convolution on Hopper, with its plain PyTorch version beside it.

Counterpart of ``diffuman4d_tpu/ops/conv.py``: :func:`conv3x3` computes
``conv3x3(silu(x * scale + shift)) + bias (+ residual)`` -- 3x3, stride 1,
SAME zero padding applied after the prologue, NHWC, operands rounded to
bf16, fp32 prologue / accumulation / bias, output in ``x``'s dtype. It
replaces the Pallas kernel ``_conv_kernel`` (via ``conv3x3`` ->
``_conv3x3_pallas``) with ``csrc/conv3x3_hopper.cu``. A CPU tensor takes
:func:`conv3x3_plain`; a CUDA tensor launches the kernel or raises,
counts the launch in ``conv3x3.launches`` and, per shape and epilogue
variant, in the counter ``conv3x3.shapes``.

The op is differentiable. On the CPU autograd runs through the plain
version. On CUDA the kernel launch sits in an ``autograd.Function`` whose
backward restates the JAX package's ``_conv3x3_p_bwd``: the prologue is
recomputed, the input and weight gradients are stock convolution gradients
on bf16 operands (library convolutions there too, not a kernel), and the
SiLU / affine chain gives ``dx``, ``dscale``, ``dshift``; ``dbias`` and
``dresidual`` come from the cotangent.

Weights are in PyTorch's ``(Cout, Cin, 3, 3)`` layout, as the port's
``nn.Conv2d`` modules hold them.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from diffuman4d_torch.ops import cuda_build
from diffuman4d_torch.utils.tracing import ranged


def conv3x3_ok(shape: tuple[int, ...], cout: int) -> bool:
    """Shape gate of the fused path: the production-VAE shapes that the JAX
    package's ``pallas_conv3x3_ok`` admits (large spatial relative to the
    channels), without its TPU on-chip-memory tile term."""
    if len(shape) != 4:
        return False
    _, H, W, cin = shape
    big_spatial = H * W >= 256 * 256
    mid_spatial = H * W >= 128 * 128 and max(cin, cout) >= 512
    return (
        cin % 128 == 0
        and cout % 128 == 0
        and (big_spatial or mid_spatial)
        and W * max(cin, cout) * 2 <= 2 * 1024 * 1024
    )


def conv3x3_plain(x, w, bias, scale=None, shift=None, residual=None, *, silu=False):
    """Plain version (the JAX package's ``_conv3x3_ref``): bf16-rounded
    prologue output and weights, fp32 convolution, bias and residual."""
    h = x.to(torch.bfloat16)
    if scale is not None or silu:
        t = h.float()
        if scale is not None:
            t = t * scale[:, None, None, :].float() + shift[:, None, None, :].float()
        if silu:
            t = F.silu(t)
        h = t.to(torch.bfloat16)
    y = F.conv2d(
        h.float().permute(0, 3, 1, 2),
        w.to(torch.bfloat16).float(),
        padding=1,
    ).permute(0, 2, 3, 1)
    y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def tap_major_weights(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout: ``(Cout, 9, Cin)`` bf16, contiguous, tap
    ``3 dy + dx`` for the input pixel at offset ``(dy - 1, dx - 1)``. Its
    tensor map reads one tap's 128 output x 64 input channels per box."""
    cout, cin = w.shape[:2]
    return w.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(cout, 9, cin).contiguous()


@ranged("op/conv3x3")  # a profiler range, while one records
def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    scale: torch.Tensor | None = None,
    shift: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    silu: bool = False,
) -> torch.Tensor:
    """Fused ``conv3x3(silu(x*scale+shift)) + bias (+ residual)``.

    x: (B, H, W, Cin) NHWC; w: (Cout, Cin, 3, 3); bias: (Cout,);
    scale/shift: (B, Cin) per-(batch, channel) affine; residual:
    (B, H, W, Cout). CUDA needs Cin and Cout divisible by 8."""
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3: scale and shift go together")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias, scale, shift, residual, silu=silu)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias, scale, shift, residual)):
        return _Conv3x3.apply(x, w, bias, scale, shift, residual, silu)
    B, H, W, cin = x.shape
    cout = w.shape[0]
    if w.shape != (cout, cin, 3, 3) or bias.shape != (cout,):
        raise ValueError(f"conv3x3: weight {tuple(w.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit input channels {cin}")
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3 kernel needs Cin, Cout % 8 == 0, got {cin}, {cout}")
    dev = x.device
    xb = x.to(torch.bfloat16).contiguous()
    wt = tap_major_weights(w)
    bias32 = bias.float().contiguous()
    sc = sh = None
    if scale is not None:
        sc = scale.float().contiguous()
        sh = shift.float().contiguous()
        if sc.shape != (B, cin) or sh.shape != (B, cin):
            raise ValueError("conv3x3: scale/shift must be (B, Cin)")
    res = None
    if residual is not None:
        if residual.shape != (B, H, W, cout):
            raise ValueError(f"conv3x3: residual {tuple(residual.shape)} != output shape")
        res = residual.to(torch.bfloat16).contiguous()
    out = torch.empty((B, H, W, cout), dtype=torch.bfloat16, device=dev)
    tensors = [t for t in (xb, wt, bias32, sc, sh, res, out) if t is not None]
    for t in tensors:
        if t.device != dev:
            raise ValueError("conv3x3: all tensors must be on one device")
        if t.data_ptr() % 16:
            raise ValueError("conv3x3: tensors must be 16-byte aligned")
    fn = cuda_build.entry("conv3x3_hopper", "conv3x3_fwd")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xb.data_ptr(), wt.data_ptr(), bias32.data_ptr(), ptr(sc), ptr(sh), ptr(res),
                out.data_ptr(), B, H, W, cin, cout, int(silu), stream)
    cuda_build.check(rc, "conv3x3_fwd")
    cuda_build.count_launch(conv3x3, (B, H, W, cin, cout, sc is not None, bool(silu),
                                      res is not None))
    return out.to(x.dtype)


# launch count, in total and per (B, H, W, Cin, Cout, affine, silu, residual)
conv3x3.launches = 0
conv3x3.shapes = Counter()


class _Conv3x3(torch.autograd.Function):
    """The kernel launch with the backward of ``_conv3x3_p_bwd``."""

    @staticmethod
    def forward(ctx, x, w, bias, scale, shift, residual, silu):
        ctx.save_for_backward(x, w, scale, shift)
        ctx.silu = silu
        ctx.bias_dtype = bias.dtype
        ctx.res_dtype = None if residual is None else residual.dtype
        with torch.no_grad():
            return conv3x3(x, w, bias, scale, shift, residual, silu=silu)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, shift = ctx.saved_tensors
        needs = ctx.needs_input_grad
        return conv3x3_backward(x, w, scale, shift, g, ctx.silu, ctx.bias_dtype, ctx.res_dtype,
                                needs) + (None,)


def conv3x3_backward(x, w, scale, shift, g, silu: bool, bias_dtype, res_dtype, needs=(True,) * 6):
    """(dx, dw, dbias, dscale, dshift, dresidual) of :func:`conv3x3` for the
    cotangent ``g``: bf16 operands and fp32 accumulation in both convolution
    gradients (their results come back in bf16, as every gradient of a bf16
    tensor does here), fp32 for the SiLU / affine chain."""
    wb = w.to(torch.bfloat16)
    xb32 = x.to(torch.bfloat16).float()
    affine = scale is not None
    pre = xb32 * scale[:, None, None, :].float() + shift[:, None, None, :].float() \
        if affine else xb32
    sig = torch.sigmoid(pre) if silu else None
    h = (pre * sig if silu else pre).to(torch.bfloat16)
    gb = g.to(torch.bfloat16)
    dbias = g.float().sum(dim=(0, 1, 2)).to(bias_dtype) if needs[2] else None
    dres = g.to(res_dtype) if res_dtype is not None and needs[5] else None
    g_nchw = gb.permute(0, 3, 1, 2)
    dw = None
    if needs[1]:
        dw = torch.nn.grad.conv2d_weight(h.permute(0, 3, 1, 2), w.shape, g_nchw,
                                         padding=1).to(w.dtype)
    dx = dscale = dshift = None
    if needs[0] or (affine and (needs[3] or needs[4])):
        dh = torch.nn.grad.conv2d_input(xb32.permute(0, 3, 1, 2).shape, wb, g_nchw,
                                        padding=1).permute(0, 2, 3, 1).float()
        dpre = dh * (sig * (1.0 + pre * (1.0 - sig))) if silu else dh
        if affine:
            dscale = (dpre * xb32).sum(dim=(1, 2)).to(scale.dtype)
            dshift = dpre.sum(dim=(1, 2)).to(shift.dtype)
            dx = (dpre * scale[:, None, None, :].float()).to(x.dtype)
        else:
            dx = dpre.to(x.dtype)
    return dx, dw, dbias, dscale, dshift, dres
