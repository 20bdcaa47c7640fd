"""Attention entry point for the whole port (counterpart of
``diffuman4d_tpu/ops/attention.py``).

Every attention of the model goes through :func:`dot_product_attention` on
``(batch, seq, heads, head_dim)`` tensors: scale 1/sqrt(head_dim), softmax
in fp32, no mask. Head dims 64 and 512 go to their kernel wrappers, where
the tensor's device picks the plain version (CPU) or the hand-written
kernel (CUDA); any other head dim takes the plain version on the CPU and
raises on CUDA. ``implementation="train"`` is the differentiable path:
head dim 64 goes to :func:`flash_attention_train` (forward with logsumexp
plus the hand-written dQ and dK/dV kernels) at any sequence length.
"""

from __future__ import annotations

import torch

from diffuman4d_torch.ops.flash_backward import flash_attention_train
from diffuman4d_torch.ops.flash_attention import (
    attention_plain,
    flash_attention_d64,
    flash_attention_d512,
)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, implementation: str = "auto"
) -> torch.Tensor:
    """Multi-head attention, (B, S, H, D) -> (B, S, H, D).

    implementation:
      * "math" -- the plain version (the JAX package's ``_xla_attention``)
      * "auto" -- plain on CPU; on CUDA the d=64 or d=512 kernel
      * "train" -- differentiable: at d=64 the forward-with-logsumexp and
        backward kernels on CUDA, their plain version on the CPU; any other
        head dim is autograd through the plain version on the CPU and
        raises on CUDA
    """
    if implementation == "math":
        return attention_plain(q, k, v)
    if implementation == "train":
        if q.shape[-1] == 64:
            return flash_attention_train(q, k, v)
        if q.device.type == "cpu":
            return attention_plain(q, k, v)
        raise ValueError(f"no differentiable CUDA attention kernel for head dim "
                         f"{q.shape[-1]} (have 64)")
    if implementation != "auto":
        raise ValueError(f"Unknown attention implementation: {implementation}")
    d = q.shape[-1]
    if d == 64:
        return flash_attention_d64(q, k, v)
    if d == 512:
        return flash_attention_d512(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    raise ValueError(f"no CUDA attention kernel for head dim {d} (have 64 and 512)")
