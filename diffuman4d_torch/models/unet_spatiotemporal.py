"""Stable Video Diffusion's spatio-temporal UNet (diffusers
``UNetSpatioTemporalConditionModel``, Blattmann et al., arXiv:2311.15127),
NHWC, with diffusers' parameter names so that a state dict loads from an
HF checkpoint.

A clip's frames are ``num_frames`` consecutive batch rows, as the
multiview UNet's window rows are: activations are (B * F, H, W, C).

* :class:`SpatioTemporalResBlock`: the spatial ``ResnetBlock2D`` (the port's
  fused conv path where its gates admit the shape), then a
  :class:`TemporalResnetBlock` (GroupNorm over every frame's pixels of a
  clip, SiLU, a (3, 1, 1) convolution over the frames, the time embedding,
  again), then the learned mix :class:`AlphaBlender`.
* :class:`TransformerSpatioTemporalModel`: GroupNorm, ``proj_in``, a spatial
  block (self-attention, cross-attention to the clip's one image-embedding
  token, GEGLU), the frame index's sinusoid through ``time_pos_embed``
  added, a :class:`TemporalBasicTransformerBlock` (``ff_in``,
  self-attention over the frames at each pixel, cross-attention to the
  first frame's token, GEGLU) on the (B * HW, F, C) transpose, the mix,
  ``proj_out`` and the residual.
* The time embedding is ``time_embedding(t) + add_embedding(sinusoid_256(
  [fps, motion_bucket_id, noise_aug_strength]))``.

The temporal convolutions are three shifted GEMMs on the (B, F, HW, C) view
(:func:`temporal_conv`); every attention goes through
``ops.attention.dot_product_attention`` (the frames' self-attention in a
profiler range ``op/temporal_attention``); the temporal GroupNorms run on
the GroupNorm kernel pair as a (B, F * H, W, C) view. Each temporal resnet
with its mix, and each temporal transformer block with its transposes and
mix, is a profiler range ``op/temporal``. ``image_only_indicator`` is all
zeros in image-to-video sampling, so the mix is ``sigmoid(mix_factor)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from diffuman4d_torch.models.layers import (
    Attention,
    Downsample2D,
    FeedForward,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    conv_nhwc,
    timestep_sinusoidal,
)
from diffuman4d_torch.models.transformer import LayerNorm32
from diffuman4d_torch.utils.tracing import profiler_range

TEMPORAL_RANGE = "op/temporal"
TEMPORAL_ATTENTION_RANGE = "op/temporal_attention"


@dataclass(frozen=True)
class SVDUNetConfig:
    """The fields of SVD-xt's ``unet/config.json`` the port reads, with its
    values as defaults; ``norm_num_groups`` is 32 in diffusers' code (a
    field here for the tests' tiny widths)."""

    in_channels: int = 8  # noisy latents 4 + the conditioning image's latents 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: tuple[int, ...] = (5, 10, 20, 20)
    transformer_layers_per_block: int = 1
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    num_frames: int = 25
    sample_size: int = 96
    norm_num_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def temporal_conv(conv: nn.Conv3d, x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """A (3, 1, 1) ``nn.Conv3d`` with padding (1, 0, 0) over the frames of
    (B * F, H, W, C): ``out[f] = W0 x[f-1] + W1 x[f] + W2 x[f+1] + b``, zero
    past a clip's ends, as three GEMMs on the (B, F * HW, C) view (the
    middle tap writes, the outer two accumulate in place on the rows they
    reach)."""
    bf, h, w, c = x.shape
    b = bf // num_frames
    n = h * w
    taps = conv.weight.permute(2, 0, 1, 3, 4).reshape(3, conv.out_channels, c)
    x3 = x.reshape(b, num_frames * n, c)
    out = F.linear(x3, taps[1], conv.bias)
    if num_frames > 1:
        for i in range(b):
            out[i, n:].addmm_(x3[i, :-n], taps[0].t())
            out[i, :-n].addmm_(x3[i, n:], taps[2].t())
    return out.reshape(bf, h, w, conv.out_channels)


def _clip_view(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B * F, H, W, C) as (B, F * H, W, C): one image per clip, so that a
    GroupNorm's statistics span every frame's pixels."""
    bf, h, w, c = x.shape
    return x.reshape(bf // num_frames, num_frames * h, w, c)


class AlphaBlender(nn.Module):
    """``alpha * x_spatial + (1 - alpha) * x_temporal`` with ``alpha =
    sigmoid(mix_factor)`` (merge strategies ``learned`` and
    ``learned_with_images`` with no image-only frames), or ``1 - alpha``
    with ``switch_spatial_to_temporal_mix``; alpha in the inputs' dtype, the
    mix in fp32 (``torch.lerp``), one rounding."""

    def __init__(self, alpha: float = 0.5, switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.switch = switch_spatial_to_temporal_mix
        self.init_alpha = alpha
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def alpha(self) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor.float())
        return 1.0 - a if self.switch else a

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        return torch.lerp(x_temporal, x_spatial, self.alpha().to(x_spatial.dtype), out=out)


class TemporalResnetBlock(nn.Module):
    """GroupNorm (over every frame of a clip) - SiLU - temporal conv, the
    time embedding added per frame, again, plus the input (in and out
    channels are equal in every use)."""

    def __init__(self, channels: int, temb_channels: int | None, eps: float, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(channels, groups, eps)
        self.conv1 = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, channels)
        self.norm2 = GroupNorm(channels, groups, eps)
        self.conv2 = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None, num_frames: int):
        h = self.norm1(_clip_view(x, num_frames), silu=True).reshape(x.shape)
        h = temporal_conv(self.conv1, h, num_frames)
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.norm2(_clip_view(h, num_frames), silu=True).reshape(x.shape)
        return x + temporal_conv(self.conv2, h, num_frames)


class SpatioTemporalResBlock(nn.Module):
    """``ResnetBlock2D`` per frame, then :class:`TemporalResnetBlock` over
    the frames, mixed by :class:`AlphaBlender` (a profiler range
    ``op/temporal`` around the temporal part and the mix)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int | None,
                 eps: float = 1e-6, temporal_eps: float | None = None, groups: int = 32,
                 merge_factor: float = 0.5, switch_spatial_to_temporal_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, temb_channels, groups,
                                               eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, temb_channels, eps if temporal_eps is None else temporal_eps, groups)
        self.time_mixer = AlphaBlender(merge_factor, switch_spatial_to_temporal_mix)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None, num_frames: int):
        h = self.spatial_res_block(x, temb)
        with profiler_range(TEMPORAL_RANGE):
            ht = self.temporal_res_block(h, temb, num_frames)
            return self.time_mixer(h, ht)


class BasicTransformerBlock(nn.Module):
    """Pre-norm self-attention, cross-attention to ``context``, GEGLU."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, cross_attention_dim=cross_attention_dim)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """On (B * HW, F, C): ``ff_in`` (GEGLU) with a residual, self-attention
    over the F frames (a profiler range ``op/temporal_attention`` around the
    attention call), cross-attention to the first frame's token, GEGLU."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, cross_attention_dim: int):
        super().__init__()
        self.norm_in = LayerNorm32(dim, eps=1e-5)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.attn1.op_range = TEMPORAL_ATTENTION_RANGE
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, cross_attention_dim=cross_attention_dim)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """``x`` (B * HW, F, C); ``context`` (B, Sk, cross_attention_dim),
        shared by a clip's HW rows."""
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, num_heads: int, head_dim: int, in_channels: int,
                 cross_attention_dim: int, num_layers: int = 1, groups: int = 32):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNorm(in_channels, groups, 1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_heads, head_dim, cross_attention_dim)
            for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, num_heads, head_dim, cross_attention_dim)
            for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(in_channels, in_channels * 4, in_channels)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, num_frames: int) -> torch.Tensor:
        """``x`` (B * F, H, W, C); ``context`` (B, Sk, cross_attention_dim),
        one clip's tokens (the first frame's, as diffusers takes them)."""
        bf, h, w, c = x.shape
        b, n = bf // num_frames, h * w
        residual = x
        t = self.proj_in(self.norm(x).reshape(bf, n, c))
        inner = t.shape[-1]
        frames = torch.arange(num_frames, device=x.device).repeat(b)
        pos = self.time_pos_embed(timestep_sinusoidal(frames, c, True, 0.0).to(t.dtype))
        pos = pos.reshape(b, num_frames, 1, inner).transpose(1, 2)  # (B, 1, F, C)
        frame_ctx = context.repeat_interleave(num_frames, dim=0)
        for block, tblock in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            t = block(t, frame_ctx)
            with profiler_range(TEMPORAL_RANGE):
                tv = t.reshape(b, num_frames, n, inner)
                tt = torch.empty((b, n, num_frames, inner), dtype=t.dtype, device=t.device)
                torch.add(tv.transpose(1, 2), pos, out=tt)
                tt = tblock(tt.reshape(b * n, num_frames, inner), context)
                mixed = torch.empty_like(tv)
                self.time_mixer(tv, tt.reshape(b, n, num_frames, inner).transpose(1, 2),
                                out=mixed)
                t = mixed.reshape(bf, n, inner)
        return self.proj_out(t).reshape(bf, h, w, c) + residual


class DownBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int, add_downsample: bool, eps: float, groups: int = 32,
                 num_heads: int | None = None, cross_attention_dim: int | None = None,
                 transformer_layers: int = 1):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_channels if i == 0 else out_channels, out_channels,
                                   temb_channels, eps, groups=groups)
            for i in range(num_layers)])
        if num_heads is not None:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(num_heads, out_channels // num_heads,
                                               out_channels, cross_attention_dim,
                                               transformer_layers, groups)
                for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels, out_channels)])

    def forward(self, x, temb, context, num_frames: int):
        states = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, num_frames)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, num_frames)
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class UNetMidBlockSpatioTemporal(nn.Module):
    def __init__(self, channels: int, temb_channels: int, num_heads: int,
                 cross_attention_dim: int, transformer_layers: int = 1, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(channels, channels, temb_channels, 1e-5, groups=groups)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            TransformerSpatioTemporalModel(num_heads, channels // num_heads, channels,
                                           cross_attention_dim, transformer_layers, groups)])

    def forward(self, x, temb, context, num_frames: int):
        x = self.resnets[0](x, temb, num_frames)
        x = self.attentions[0](x, context, num_frames)
        return self.resnets[1](x, temb, num_frames)


class UpBlockSpatioTemporal(nn.Module):
    def __init__(self, in_channels: int, skip_channels: list[int], out_channels: int,
                 temb_channels: int, add_upsample: bool, eps: float, groups: int = 32,
                 num_heads: int | None = None, cross_attention_dim: int | None = None,
                 transformer_layers: int = 1):
        """``skip_channels``: channels of the skips this block pops, in pop
        order (the last emitted first)."""
        super().__init__()
        resnets, ch = [], in_channels
        for skip in skip_channels:
            resnets.append(SpatioTemporalResBlock(ch + skip, out_channels, temb_channels, eps,
                                                  groups=groups))
            ch = out_channels
        self.resnets = nn.ModuleList(resnets)
        if num_heads is not None:
            self.attentions = nn.ModuleList([
                TransformerSpatioTemporalModel(num_heads, out_channels // num_heads,
                                               out_channels, cross_attention_dim,
                                               transformer_layers, groups)
                for _ in skip_channels])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, out_channels)])

    def forward(self, x, res_states: list, temb, context, num_frames: int):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_states.pop()], dim=-1), temb, num_frames)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, num_frames)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class UNetSpatioTemporalConditionModel(nn.Module):
    """conv_in -> 3 cross-attention down blocks and a plain one -> mid -> a
    plain up block and 3 cross-attention ones -> GroupNorm, SiLU, conv_out.
    Resnet epsilons as diffusers' blocks set them: 1e-6 in the
    cross-attention down blocks and every up block, 1e-5 in the last down
    block and the mid block."""

    def __init__(self, config: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        cfg = self.config = config
        ch, heads, n = cfg.block_out_channels, cfg.num_attention_heads, len(cfg.block_out_channels)
        ted, g, lpb = cfg.time_embed_dim, cfg.norm_num_groups, cfg.layers_per_block
        xdim, tl = cfg.cross_attention_dim, cfg.transformer_layers_per_block
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, ted)
        down, skips, prev = [], [ch[0]], ch[0]
        for i in range(n):
            final = i == n - 1
            down.append(DownBlockSpatioTemporal(
                prev, ch[i], ted, lpb, not final, 1e-5 if final else 1e-6, g,
                None if final else heads[i], xdim, tl))
            skips += [ch[i]] * lpb + ([] if final else [ch[i]])
            prev = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = UNetMidBlockSpatioTemporal(ch[-1], ted, heads[-1], xdim, tl, g)
        up, rch, rheads = [], ch[::-1], heads[::-1]
        for i in range(n):
            take = skips[-(lpb + 1):]
            del skips[-(lpb + 1):]
            up.append(UpBlockSpatioTemporal(
                prev, list(reversed(take)), rch[i], ted, i != n - 1, 1e-6, g,
                None if i == 0 else rheads[i], xdim, tl))
            prev = rch[i]
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], g, 1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,  # (B * F, H, W, in_channels)
        timestep: torch.Tensor,  # (B * F,), scalar or (1,): continuous timesteps
        encoder_hidden_states: torch.Tensor,  # (B, Sk, cross_attention_dim)
        added_time_ids: torch.Tensor,  # (B, 3): fps - 1, motion bucket, noise augmentation
        num_frames: int,
    ) -> torch.Tensor:
        cfg, dtype = self.config, self.dtype
        bf = sample.shape[0]
        b = bf // num_frames
        dev = sample.device
        t = torch.as_tensor(timestep, device=dev).reshape(-1).expand(bf)
        emb = self.time_embedding(
            timestep_sinusoidal(t, cfg.block_out_channels[0], True, 0.0).to(dtype))
        ids = timestep_sinusoidal(added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                                  True, 0.0).reshape(b, -1)
        emb = emb + self.add_embedding(ids.to(dtype)).repeat_interleave(num_frames, dim=0)
        context = encoder_hidden_states.to(dtype)

        x = conv_nhwc(self.conv_in, sample.to(dtype))
        res_states = [x]
        for blk in self.down_blocks:
            x, states = blk(x, emb, context, num_frames)
            res_states.extend(states)
        x = self.mid_block(x, emb, context, num_frames)
        n_up = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            take = res_states[-n_up:]
            del res_states[-n_up:]
            x = blk(x, take, emb, context, num_frames)
        return conv_nhwc(self.conv_out, self.conv_norm_out(x, silu=True))
