"""Stable Video Diffusion's VAE (diffusers ``AutoencoderKLTemporalDecoder``),
NHWC, with diffusers' parameter names: the SD encoder and ``quant_conv`` of
``models/vae.py`` and a temporal decoder.

``TemporalDecoder``: ``conv_in``, a mid block of two
``SpatioTemporalResBlock``s around the d = 512 one-head attention, up blocks
of three ``SpatioTemporalResBlock``s (spatial eps 1e-6, temporal eps 1e-5,
the mix ``learned`` from 0 with its sides switched: ``(1 - sigmoid(m)) *
spatial + sigmoid(m) * temporal``), GroupNorm, SiLU, ``conv_out``, then
``time_conv_out``, a (3, 1, 1) convolution over the frames. There is no
``post_quant_conv``. A clip's frames are ``num_frames`` consecutive rows, and
clips side by side in a batch do not mix.
"""

from __future__ import annotations

import torch
from torch import nn

from diffuman4d_torch.models.layers import GroupNorm, Upsample2D, conv_nhwc
from diffuman4d_torch.models.unet_spatiotemporal import SpatioTemporalResBlock, temporal_conv
from diffuman4d_torch.models.vae import Encoder, VAEAttention, VAEConfig


def _st_block(cin: int, cout: int) -> SpatioTemporalResBlock:
    return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                  merge_factor=0.0, switch_spatial_to_temporal_mix=True)


class MidBlockTemporalDecoder(nn.Module):
    def __init__(self, channels: int, num_layers: int, norm_eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([_st_block(channels, channels) for _ in range(num_layers)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_eps)])

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        x = self.resnets[0](x, None, num_frames)
        for resnet, attn in zip(self.resnets[1:], self.attentions):
            x = resnet(attn(x), None, num_frames)
        return x


class UpBlockTemporalDecoder(nn.Module):
    def __init__(self, cin: int, cout: int, num_layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([_st_block(cin if i == 0 else cout, cout)
                                      for i in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout, cout)])

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x, None, num_frames)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlockTemporalDecoder(rev[0], cfg.layers_per_block, cfg.norm_eps)
        blocks, prev = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(UpBlockTemporalDecoder(prev, c, cfg.layers_per_block + 1,
                                                 i != len(rev) - 1))
            prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(rev[-1], 32, cfg.norm_eps)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                       padding=(1, 0, 0))

    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        x = self.mid_block(conv_nhwc(self.conv_in, z), num_frames)
        for blk in self.up_blocks:
            x = blk(x, num_frames)
        x = conv_nhwc(self.conv_out, self.conv_norm_out(x, silu=True))
        return temporal_conv(self.time_conv_out, x, num_frames)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = TemporalDecoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        m = conv_nhwc(self.quant_conv, self.encoder(x.to(self.dtype)))
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.float().clamp(-30.0, 20.0)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Pixels (B, H, W, 3) in [-1, 1] -> the posterior's mode (its mean),
        unscaled, (B, H/8, W/8, 4): the conditioning latent of
        image-to-video sampling."""
        return self.moments(x)[0]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """Scaled latents of clips of ``num_frames`` consecutive rows ->
        pixels in [-1, 1]."""
        return self.decoder((z / self.config.scaling_factor).to(self.dtype), num_frames)
