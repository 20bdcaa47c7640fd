"""UNet down / mid / up blocks (counterpart of
``diffuman4d_tpu/models/unet_blocks.py``).

Down blocks emit one skip per layer plus one per downsampler; up blocks
consume ``num_layers`` skips in reverse, each concatenated on the channel
axis before its resnet, after FreeU (``models/freeu.py``) where the UNet's
config sets it: up blocks 0 and 1 (``resolution_idx``) then rescale both
halves of each pair.
"""

from __future__ import annotations

import torch
from torch import nn

from diffuman4d_torch.models.freeu import FreeUConfig, apply_freeu
from diffuman4d_torch.models.layers import Downsample2D, ResnetBlock2D, Upsample2D
from diffuman4d_torch.models.transformer import TransformerMultiview


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 num_layers: int = 2, add_downsample: bool = True, norm_groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels,
                          temb_channels, norm_groups)
            for i in range(num_layers)
        ])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_channels, out_channels)])

    def forward(self, x: torch.Tensor, temb: torch.Tensor, num_frames: int = 1):
        states = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class CrossAttnDownBlockMultiview(DownBlock2D):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, num_heads: int,
                 num_layers: int = 2, transformer_layers: int = 1, add_downsample: bool = True,
                 norm_groups: int = 32, use_linear_projection: bool = True,
                 attn_implementation: str = "auto"):
        super().__init__(in_channels, out_channels, temb_channels, num_layers, add_downsample,
                         norm_groups)
        head_dim = out_channels // num_heads
        self.attentions = nn.ModuleList([
            TransformerMultiview(out_channels, num_heads, head_dim, transformer_layers,
                                 norm_groups, use_linear_projection,
                                 attn_implementation=attn_implementation)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor, temb: torch.Tensor, num_frames: int = 1):
        states = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), num_frames=num_frames)
            states.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class UNetMidBlockMultiviewCrossAttn(nn.Module):
    def __init__(self, channels: int, temb_channels: int, num_heads: int, num_layers: int = 1,
                 transformer_layers: int = 1, norm_groups: int = 32,
                 use_linear_projection: bool = True, attn_implementation: str = "auto"):
        super().__init__()
        head_dim = channels // num_heads
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, norm_groups)
            for _ in range(num_layers + 1)
        ])
        self.attentions = nn.ModuleList([
            TransformerMultiview(channels, num_heads, head_dim, transformer_layers, norm_groups,
                                 use_linear_projection, attn_implementation=attn_implementation)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor, temb: torch.Tensor, num_frames: int = 1):
        x = self.resnets[0](x, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x, num_frames=num_frames), temb)
        return x


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, skip_channels: list[int], out_channels: int,
                 temb_channels: int, add_upsample: bool = True, norm_groups: int = 32,
                 resolution_idx: int = 0, freeu: FreeUConfig | None = None):
        """``skip_channels``: channels of the skips this block pops, in pop
        order (the last emitted first)."""
        super().__init__()
        self.resolution_idx = resolution_idx
        self.freeu = freeu
        resnets = []
        ch = in_channels
        for skip in skip_channels:
            resnets.append(ResnetBlock2D(ch + skip, out_channels, temb_channels, norm_groups))
            ch = out_channels
        self.resnets = nn.ModuleList(resnets)
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_channels, out_channels)])

    def _upsample(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsamplers[0](x) if hasattr(self, "upsamplers") else x

    def _join(self, x: torch.Tensor, res_states: list) -> torch.Tensor:
        """The next skip, after FreeU, concatenated to ``x``."""
        x, res = apply_freeu(self.resolution_idx, x, res_states.pop(), self.freeu)
        return torch.cat([x, res], dim=-1)

    def forward(self, x: torch.Tensor, res_states: list, temb: torch.Tensor,
                num_frames: int = 1):
        for resnet in self.resnets:
            x = resnet(self._join(x, res_states), temb)
        return self._upsample(x)


class CrossAttnUpBlockMultiview(UpBlock2D):
    def __init__(self, in_channels: int, skip_channels: list[int], out_channels: int,
                 temb_channels: int, num_heads: int, transformer_layers: int = 1,
                 add_upsample: bool = True, norm_groups: int = 32,
                 use_linear_projection: bool = True, attn_implementation: str = "auto",
                 resolution_idx: int = 0, freeu: FreeUConfig | None = None):
        super().__init__(in_channels, skip_channels, out_channels, temb_channels, add_upsample,
                         norm_groups, resolution_idx, freeu)
        head_dim = out_channels // num_heads
        self.attentions = nn.ModuleList([
            TransformerMultiview(out_channels, num_heads, head_dim, transformer_layers,
                                 norm_groups, use_linear_projection,
                                 attn_implementation=attn_implementation)
            for _ in skip_channels
        ])

    def forward(self, x: torch.Tensor, res_states: list, temb: torch.Tensor,
                num_frames: int = 1):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(self._join(x, res_states), temb), num_frames=num_frames)
        return self._upsample(x)
