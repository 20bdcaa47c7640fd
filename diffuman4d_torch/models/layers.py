"""Shared building blocks (counterpart of ``diffuman4d_tpu/models/layers.py``):
sinusoidal timestep features, ``TimestepEmbedding``, fp32-statistics
``GroupNorm``, multi-head ``Attention``, GEGLU ``FeedForward``,
``ResnetBlock2D`` (plain and fused paths), ``Downsample2D``, ``Upsample2D``.

Tensors are channels-last (NHWC / (B, S, C)) as in the JAX package;
convolutions run through :func:`conv_nhwc`, whose NCHW view of an NHWC
tensor is PyTorch's ``channels_last`` layout, so no copy is made. Module and
parameter names follow the diffusers checkpoint layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from diffuman4d_torch.ops.attention import dot_product_attention
from diffuman4d_torch.ops.conv import conv3x3, conv3x3_ok
from diffuman4d_torch.ops.groupnorm import group_norm, groupnorm_affine
from diffuman4d_torch.ops.layernorm_geglu import geglu
from diffuman4d_torch.ops.resize import upsample_nearest_2x
from diffuman4d_torch.utils.tracing import profiler_range


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor, returning NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y.permute(0, 2, 3, 1)


def timestep_sinusoidal(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers ``get_timestep_embedding``),
    always fp32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.float()[:, None] * emb[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over sinusoidal features (``out_dim``, default
    ``time_embed_dim``: the width of ``linear_2``'s output)."""

    def __init__(self, in_dim: int, time_embed_dim: int, out_dim: int | None = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class GroupNorm(nn.Module):
    """GroupNorm over NHWC with fp32 statistics, output in the input dtype,
    SiLU optional (``silu=True`` for ``F.silu(norm(x))``), through
    :func:`ops.groupnorm.group_norm`: the kernel pair on a CUDA tensor, the
    plain version on the CPU or where autograd needs it. Groups =
    gcd(num_groups, channels), as in the JAX package (only tiny test configs
    are not multiples of 32)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = math.gcd(num_groups, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, silu=silu)


class Attention(nn.Module):
    """Multi-head attention (diffusers ``Attention``): qkv without bias,
    output projection with bias. Self-attention, or with
    ``cross_attention_dim`` cross-attention: K and V from ``context``
    (B, Sk, cross_attention_dim), or from ``context`` of B / n rows for n
    consecutive query rows each (K and V are projected once per context row
    and repeated). ``op_range``, where set, is a profiler range around the
    attention call alone. With ``cp`` (an
    ``ops.context_parallel.ContextParallel``) the queries are this rank's
    frames and K/V are gathered from the ranks of its mesh axis."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 attn_implementation: str = "auto", cross_attention_dim: int | None = None):
        super().__init__()
        inner = num_heads * head_dim
        kv_dim = cross_attention_dim or query_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.attn_implementation = attn_implementation
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.op_range: str | None = None

    def forward(self, x: torch.Tensor, cp=None, context: torch.Tensor | None = None
                ) -> torch.Tensor:
        b, s, _ = x.shape
        kv = x if context is None else context
        shape = (b, s, self.num_heads, self.head_dim)
        kv_shape = (kv.shape[0], kv.shape[1], self.num_heads, self.head_dim)
        q = self.to_q(x).reshape(shape)
        k = self.to_k(kv).reshape(kv_shape)
        v = self.to_v(kv).reshape(kv_shape)
        if kv.shape[0] != b:
            k = k.repeat_interleave(b // kv.shape[0], dim=0)
            v = v.repeat_interleave(b // kv.shape[0], dim=0)
        if cp is not None:
            out = cp.attend(q, k, v, implementation=self.attn_implementation)
        else:
            with profiler_range(self.op_range):
                out = dot_product_attention(q, k, v, implementation=self.attn_implementation)
        out = out.reshape(b, s, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """The projection, then ``hidden * gelu(gate)`` (``ops.layernorm_geglu.geglu``:
    one kernel on a CUDA tensor)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu(self.proj(x))


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net`` indices follow diffusers (0 = GEGLU,
    1 = dropout, 2 = output projection)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class ResnetBlock2D(nn.Module):
    """GN-SiLU-conv twice, additive time embedding, 1x1 shortcut when the
    channel count changes. At the shapes :func:`conv3x3_ok` admits, both
    GN-SiLU-conv chains run as the fused :func:`conv3x3` (GroupNorm folded
    into its prologue, the skip-add into conv2's epilogue)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int | None = None,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm1 = GroupNorm(in_channels, groups, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, groups, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def _temb(self, h: torch.Tensor, temb: torch.Tensor | None) -> torch.Tensor:
        if temb is None or not hasattr(self, "time_emb_proj"):
            return h
        return h + self.time_emb_proj(F.silu(temb))[:, None, None, :]

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_channels != self.out_channels:
            return conv_nhwc(self.conv_shortcut, x)
        return x

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        if conv3x3_ok(x.shape, self.out_channels) and conv3x3_ok(
            x.shape[:3] + (self.out_channels,), self.out_channels
        ):
            return self._fused(x, temb)
        h = conv_nhwc(self.conv1, self.norm1(x, silu=True))
        h = self._temb(h, temb)
        h = conv_nhwc(self.conv2, self.norm2(h, silu=True))
        return self._shortcut(x) + h

    def _fused(self, x: torch.Tensor, temb: torch.Tensor | None) -> torch.Tensor:
        s1, sh1 = groupnorm_affine(x, self.norm1.weight, self.norm1.bias,
                                   self.norm1.groups, self.norm1.eps)
        h = conv3x3(x, self.conv1.weight, self.conv1.bias, s1, sh1, silu=True)
        h = self._temb(h, temb)
        s2, sh2 = groupnorm_affine(h, self.norm2.weight, self.norm2.bias,
                                   self.norm2.groups, self.norm2.eps)
        return conv3x3(h, self.conv2.weight, self.conv2.bias, s2, sh2,
                       residual=self._shortcut(x), silu=True)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with padding 1."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, x)


class Upsample2D(nn.Module):
    """Nearest 2x + 3x3 conv; the conv is the fused kernel (no prologue) at
    gated shapes."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest_2x(x)
        if conv3x3_ok(x.shape, self.conv.out_channels):
            return conv3x3(x, self.conv.weight, self.conv.bias)
        return conv_nhwc(self.conv, x)
