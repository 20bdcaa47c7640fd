"""Model construction with random weights (counterpart of
``init_random_params`` in ``diffuman4d_tpu/sampling/loader.py``).

Loading a diffusers checkpoint is not ported yet. Random weights follow
flax's default scales: dense and conv kernels ~ N(0, 1/fan_in), biases
zero, norm scales one; the pose encoder's convs use He scaling
N(0, 2/fan_in), its ``final_proj`` and the temporal head's ``linear_2``
start at zero, its ``scale`` at 2.0 -- as the JAX package initialises them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diffuman4d_torch.models.layers import GroupNorm
from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig


def _fan_in(w: torch.Tensor) -> int:
    return math.prod(w.shape[1:])


@torch.no_grad()
def _init_module(model: nn.Module, gen: torch.Generator) -> None:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=gen.device)
                    / math.sqrt(_fan_in(w)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


@torch.no_grad()
def init_random_params(unet: UNetMultiviewCondition, vae: AutoencoderKL, seed: int = 0) -> None:
    """Fill both models' parameters in place from one seeded generator on
    the models' device."""
    dev = unet.conv_in.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    _init_module(unet, gen)
    _init_module(vae, gen)
    if unet.config.enable_pose_encoder:
        pe = unet.pose_encoder
        for layer in pe.conv_layers:
            if isinstance(layer, nn.Conv2d):
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen, device=dev)
                                   * math.sqrt(2.0 / _fan_in(layer.weight)))
        pe.final_proj.weight.zero_()
        pe.scale.fill_(2.0)
    if unet.config.enable_tem_embeds:
        unet.temporal_pos_embed.linear_2.weight.zero_()


def build_models(unet_config: UNetConfig = UNetConfig(), vae_config: VAEConfig = VAEConfig(),
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0) -> tuple[UNetMultiviewCondition, AutoencoderKL]:
    """Random-weight UNet and VAE on ``device`` in ``dtype``, eval mode: on
    the card unless the caller asks for the CPU (``device="cpu"``).
    Modules are created without initialisation (meta device) and filled on
    the target device, so a full-size model costs no host-side init. Conv
    weights are stored channels-last, the layout of the NHWC activations."""
    with torch.device("meta"):
        unet = UNetMultiviewCondition(unet_config)
        vae = AutoencoderKL(vae_config)
    unet = unet.to_empty(device=device)
    vae = vae.to_empty(device=device)
    init_random_params(unet, vae, seed)
    return tuple(m.to(dtype=dtype, memory_format=torch.channels_last).eval()
                 for m in (unet, vae))
