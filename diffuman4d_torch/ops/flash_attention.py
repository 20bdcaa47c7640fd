"""Flash attention on Hopper, with its plain PyTorch version beside it.

Counterpart of ``diffuman4d_tpu/ops/flash_attention.py``. Two wrappers
launch the one CUDA kernel of ``csrc/flash_attn.cu``:

* :func:`flash_attention_d64` replaces ``flash_attention_v4`` (the UNet's
  3D window attention) and ``flash_attention_v3`` (its per-frame
  attention); both compute the same function at head dim 64.
* :func:`flash_attention_d512` replaces ``flash_attention`` (v1), the VAE
  mid-block attention at head dim 512.

Semantics (all three): O = softmax(Q K^T / sqrt(d)) V per (batch, head) on
``(B, S, H, D)``, non-causal, unmasked, fp32 max / normaliser, P rounded to
the input dtype for the PV product, fp32 accumulation. A CPU tensor takes
:func:`attention_plain`; a CUDA tensor launches the kernel or raises.
Each wrapper counts its launches in ``.launches`` and, per
``(B, Sq, Sk, H)`` it launched at, in the counter ``.shapes``.
"""

from __future__ import annotations

from collections import Counter

import torch

from diffuman4d_torch.ops import cuda_build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with fp32 scores and softmax (the JAX package's
    ``_xla_attention``): P is cast to the input dtype for the PV product."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)


def _launch(wrapper, q, k, v, head_dim: int) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"flash attention: {name} must be a bf16 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")
        if t.dim() != 4 or t.shape[-1] != head_dim:
            raise ValueError(f"flash attention: {name} shape {tuple(t.shape)} is not "
                             f"(B, S, H, {head_dim})")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H:
        raise ValueError(f"flash attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if B * H > 65535:
        raise ValueError(f"flash attention: B*H = {B * H} exceeds the grid limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("flash attention: tensors must be 16-byte aligned")
    fn = cuda_build.entry("flash_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Sq, k.shape[1], D, stream)
    cuda_build.check(rc, "flash_attn_fwd")
    wrapper.launches += 1
    wrapper.shapes[(B, Sq, k.shape[1], H)] += 1
    return out


def flash_attention_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head dim 64 (TPU kernels B1 ``_flash_kernel_v4`` and B2
    ``_flash_kernel_v3``). bf16 CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch(flash_attention_d64, q, k, v, 64)


def flash_attention_d512(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head dim 512 (TPU kernel B3 ``_flash_kernel``, the VAE mid-block
    attention). bf16 CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch(flash_attention_d512, q, k, v, 512)


# each wrapper counts its launches, in total and per (B, Sq, Sk, H)
for _wrapper in (flash_attention_d64, flash_attention_d512):
    _wrapper.launches = 0
    _wrapper.shapes = Counter()
