"""Multiview transformer (counterpart of ``diffuman4d_tpu/models/transformer.py``).

The 3D attention is one regroup: tokens (B*T, HW, C) become (B, T*HW, C)
before attn1 so it spans every frame of the window; attn2 is per-frame
self-attention; then a GEGLU feed-forward. Each sub-layer is pre-norm with
a residual add.

Context parallelism (the JAX module's ``attn_implementation="cp"``): a
block's ``cp`` (set through ``UNetMultiviewCondition.configured``) makes
attn1's 3D path gather K/V over the mesh; the per-frame attn2, and attn1
where it attends one frame, stay local.
"""

from __future__ import annotations

import torch
from torch import nn

from diffuman4d_torch.models.layers import Attention, FeedForward, GroupNorm, conv_nhwc
from diffuman4d_torch.ops.layernorm_geglu import layer_norm


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with fp32 statistics, output in the input dtype
    (``ops.layernorm_geglu.layer_norm``: one kernel on a CUDA tensor)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class MultiviewTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 attn_implementation: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, attn_implementation)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, attn_implementation)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.cp = None  # an ops.context_parallel.ContextParallel for attn1's 3D path

    def forward(self, x: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        bt, hw, c = x.shape
        h = self.norm1(x)
        if num_frames > 1:
            h = h.reshape(bt // num_frames, num_frames * hw, c)
        h = self.attn1(h, cp=self.cp if num_frames > 1 else None)
        x = x + h.reshape(bt, hw, c)
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TransformerMultiview(nn.Module):
    """GroupNorm -> proj_in -> blocks -> proj_out -> + residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, num_layers: int = 1,
                 norm_groups: int = 32, use_linear_projection: bool = True,
                 norm_eps: float = 1e-6, attn_implementation: str = "auto"):
        super().__init__()
        inner = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(channels, norm_groups, norm_eps)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv2d(channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [MultiviewTransformerBlock(inner, num_heads, head_dim, attn_implementation)
             for _ in range(num_layers)]
        )

    def forward(self, x: torch.Tensor, num_frames: int = 1) -> torch.Tensor:
        b, h, w, c = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.reshape(b, h * w, c))
        else:
            x = conv_nhwc(self.proj_in, x).reshape(b, h * w, -1)
        for block in self.transformer_blocks:
            x = block(x, num_frames=num_frames)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c)
        else:
            x = conv_nhwc(self.proj_out, x.reshape(b, h, w, -1))
        return x + residual
