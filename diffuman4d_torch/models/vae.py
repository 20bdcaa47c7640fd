"""AutoencoderKL VAE (counterpart of ``diffuman4d_tpu/models/vae.py``).

SD-shaped, NHWC: channels (128, 256, 512, 512), two encoder resnets and
three decoder resnets per stage, single-head mid-block attention over all
channels (head dim 512 at full width), GroupNorm eps 1e-6, encoder
downsample convs with the asymmetric (0, 1, 0, 1) padding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from diffuman4d_torch.models.layers import GroupNorm, ResnetBlock2D, Upsample2D, conv_nhwc
from diffuman4d_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class VAEConfig:
    """Same fields and defaults as the JAX package's ``VAEConfig``."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VAEAttention(nn.Module):
    """GroupNorm -> one-head attention (qkv and out with bias) -> + residual."""

    def __init__(self, channels: int, norm_eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNorm(channels, 32, norm_eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, 1, c)
        out = dot_product_attention(self.to_q(t), self.to_k(t), self.to_v(t))
        return self.to_out[0](out.reshape(b, h * w, c)).reshape(b, h, w, c) + x


class VAEDownsample(nn.Module):
    """Stride-2 3x3 conv after (0, 1, 0, 1) zero padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class MidBlock(nn.Module):
    def __init__(self, channels: int, norm_eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, 32, norm_eps) for _ in range(2)
        ])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_eps)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _Stage(nn.Module):
    """One encoder ``down_blocks.i`` / decoder ``up_blocks.i``."""

    def __init__(self, resnets: list[nn.Module], sampler_key: str | None,
                 sampler: nn.Module | None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler_key is not None:
            setattr(self, sampler_key, nn.ModuleList([sampler]))
        self._sampler_key = sampler_key

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if self._sampler_key is not None:
            x = getattr(self, self._sampler_key)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        stages, prev = [], ch[0]
        for i, c in enumerate(ch):
            resnets = [ResnetBlock2D(prev if j == 0 else c, c, None, 32, cfg.norm_eps)
                       for j in range(cfg.layers_per_block)]
            last = i == len(ch) - 1
            stages.append(_Stage(resnets, None if last else "downsamplers",
                                 None if last else VAEDownsample(c)))
            prev = c
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = MidBlock(ch[-1], cfg.norm_eps)
        self.conv_norm_out = GroupNorm(ch[-1], 32, cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(self.conv_in, x)
        for stage in self.down_blocks:
            x = stage(x)
        x = self.mid_block(x)
        return conv_nhwc(self.conv_out, self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], cfg.norm_eps)
        stages, prev = [], rev[0]
        for i, c in enumerate(rev):
            resnets = [ResnetBlock2D(prev if j == 0 else c, c, None, 32, cfg.norm_eps)
                       for j in range(cfg.layers_per_block + 1)]
            last = i == len(rev) - 1
            stages.append(_Stage(resnets, None if last else "upsamplers",
                                 None if last else Upsample2D(c, c)))
            prev = c
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = GroupNorm(rev[-1], 32, cfg.norm_eps)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(conv_nhwc(self.conv_in, z))
        for stage in self.up_blocks:
            x = stage(x)
        return conv_nhwc(self.conv_out, self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        m = conv_nhwc(self.quant_conv, self.encoder(x.to(self.dtype)))
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.float().clamp(-30.0, 20.0)

    def sample_latents(self, mean: torch.Tensor, logvar: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
        """Posterior draw ``mean + exp(logvar / 2) * noise``, scaled."""
        z = mean.float() + torch.exp(0.5 * logvar) * noise.float()
        return (z * self.config.scaling_factor).to(self.dtype)

    def encode(self, x: torch.Tensor, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None, sample: bool = True) -> torch.Tensor:
        """Pixels (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 4).
        ``sample`` draws from the posterior with ``noise`` (fp32, the latent
        shape) or, without it, from ``generator``; otherwise the mean."""
        mean, logvar = self.moments(x)
        if not sample:
            return (mean.float() * self.config.scaling_factor).to(self.dtype)
        if noise is None:
            if generator is None:
                raise ValueError("encode(sample=True) needs noise or a generator")
            noise = torch.randn(mean.shape, generator=generator, dtype=torch.float32,
                                device=generator.device).to(mean.device)
        return self.sample_latents(mean, logvar, noise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> pixels in [-1, 1]."""
        z = (z / self.config.scaling_factor).to(self.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z))
