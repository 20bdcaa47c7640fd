"""Pipeline construction from config (counterpart of
``diffuman4d_tpu/sampling/loader.py``).

:func:`load_pipeline` builds the UNet, VAE and scheduler (any class
``schedulers.diffusion.from_config`` maps; its tables then live on the
pipeline's device) from a local diffusers-layout directory
(``model.model_dir``) or, when that directory
has no checkpoint, with random weights (:func:`build_models`) at the
production shape or, with ``model.arch=tiny``, at the smoke-test shape.
Random weights follow flax's default scales: dense and conv kernels ~ N(0, 1/fan_in), biases
zero, norm scales one; the pose encoder's convs use He scaling
N(0, 2/fan_in), its ``final_proj`` and the temporal head's ``linear_2``
start at zero, its ``scale`` at 2.0 -- as the JAX package initialises them.

Stable Video Diffusion (``UNetSpatioTemporalConditionModel`` and
``AutoencoderKLTemporalDecoder``) is built the same two ways: from a
diffusers directory whose ``unet/config.json`` names that class, or with
random weights at ``model.arch=svd-xt`` (the published widths) or
``svd-tiny``; it runs in :class:`SVDPipeline` with the published Euler
scheduler (Karras sigmas, v-prediction) unless the checkpoint has one.
"""

from __future__ import annotations

import logging
import math
import os.path as osp

import torch
from torch import nn

from diffuman4d_torch.configs.presets import DataConfig, ModelConfig, SamplerConfig
from diffuman4d_torch.models.layers import GroupNorm
from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
from diffuman4d_torch.models.unet_spatiotemporal import (
    AlphaBlender,
    SVDUNetConfig,
    UNetSpatioTemporalConditionModel,
)
from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig
from diffuman4d_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
from diffuman4d_torch.sampling.svd_pipeline import SVD_SCHEDULER_CONFIG, SVDPipeline
from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig, from_config

log = logging.getLogger(__name__)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}
# ModelConfig.attn_implementation -> the port's; the JAX package's "xla"
# (its plain attention) is the port's "math"
ATTN_IMPLEMENTATIONS = {"auto": "auto", "pallas": "pallas", "math": "math", "xla": "math"}
# model.arch=tiny without a checkpoint: the JAX package's smoke-test shape
TINY_UNET = dict(block_out_channels=(8, 16, 16, 16), num_attention_heads=(1, 2, 2, 2),
                 layers_per_block=1, norm_num_groups=4)
TINY_VAE = dict(block_out_channels=(4, 4, 8, 8), layers_per_block=1)
# model.arch=svd-xt | svd-tiny without a checkpoint: SVD's UNet widths
SVD_ARCHS = {
    "svd-xt": {},
    "svd-tiny": dict(block_out_channels=(8, 16, 16, 16), num_attention_heads=(1, 2, 2, 2),
                     layers_per_block=1, norm_num_groups=4, cross_attention_dim=16,
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=24),
}


def _fan_in(w: torch.Tensor) -> int:
    return math.prod(w.shape[1:])


@torch.no_grad()
def _init_module(model: nn.Module, gen: torch.Generator) -> None:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=gen.device)
                    / math.sqrt(_fan_in(w)))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, AlphaBlender):
            mod.mix_factor.fill_(mod.init_alpha)


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


def _empty_models(unet_config: UNetConfig, vae_config: VAEConfig, device,
                  attn_implementation: str) -> tuple[UNetMultiviewCondition, AutoencoderKL]:
    """Uninitialised fp32 modules on ``device`` (created on the meta device,
    so a full-size model costs no host-side init)."""
    with torch.device("meta"):
        unet = UNetMultiviewCondition(unet_config, attn_implementation=attn_implementation)
        vae = AutoencoderKL(vae_config)
    return unet.to_empty(device=device), vae.to_empty(device=device)


def _finish(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Eval mode in ``dtype``, conv weights channels-last (the layout of
    the NHWC activations)."""
    return module.to(dtype=dtype, memory_format=torch.channels_last).eval()


def finish_svd(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """:func:`_finish` for a module with 3D convs: its 2D conv weights
    channels-last, a 3D conv's weight in its own layout."""
    module = module.to(dtype=dtype).eval()
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    return module


def build_models(unet_config: UNetConfig = UNetConfig(), vae_config: VAEConfig = VAEConfig(),
                 device: torch.device | str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, attn_implementation: str = "auto",
                 ) -> tuple[UNetMultiviewCondition, AutoencoderKL]:
    """Random-weight UNet and VAE on ``device`` in ``dtype``, eval mode: on
    the card unless the caller asks for the CPU (``device="cpu"``).
    The weights are drawn on the target device."""
    unet, vae = _empty_models(unet_config, vae_config, device, attn_implementation)
    init_random_params(unet, vae, seed)
    return _finish(unet, dtype), _finish(vae, dtype)


def build_svd_models(unet_config: SVDUNetConfig = SVDUNetConfig(),
                     vae_config: VAEConfig = VAEConfig(), device: torch.device | str = "cuda",
                     dtype: torch.dtype = torch.bfloat16, seed: int = 0, state=None):
    """SVD's UNet and temporal-decoder VAE on ``device`` in ``dtype``, eval
    mode: ``state`` ((unet, vae) state dicts) loaded, else random weights
    drawn on the device (the mixes at their constructors' values)."""
    with torch.device("meta"):
        unet = UNetSpatioTemporalConditionModel(unet_config)
        vae = AutoencoderKLTemporalDecoder(vae_config)
    unet, vae = unet.to_empty(device=device), vae.to_empty(device=device)
    if state is None:
        gen = torch.Generator(device=unet.conv_in.weight.device).manual_seed(seed)
        _init_module(unet, gen)
        _init_module(vae, gen)
    else:
        for module, sd in zip((unet, vae), state):
            module.to(dtype).load_state_dict(sd)
    return finish_svd(unet, dtype), finish_svd(vae, dtype)


def sliding_from(cfg: SamplerConfig) -> SlidingConfig:
    return SlidingConfig(
        window_size=cfg.window_size,
        sliding_stride=cfg.sliding_stride,
        sliding_shift=cfg.sliding_shift,
        bidirectional=cfg.bidirectional,
        num_denoising_steps=cfg.num_denoising_steps,
        alternation_rounds=cfg.alternation_rounds,
        guidance_scale=cfg.guidance_scale,
        split_cfg_domains=tuple(cfg.split_cfg_domains or ()),
    )


def check_attention_dtype(device: str, dtype: str, attn_implementation: str) -> None:
    """Refuse a compute dtype the card's attention kernels cannot take,
    before anything is loaded (``ROADMAP.md`` C.24): on a CUDA device,
    attention ``auto`` or ``pallas`` runs the port's wgmma kernels, which
    take bf16 only. The JAX package's Pallas kernels take any dtype; here
    ``wgmma`` has no fp32 product, and a silent cast to bf16 would not be the
    fp32 run that was asked for. ``device`` is a device string ("cuda",
    "cuda:0", "cpu"); ``dtype`` and ``attn_implementation`` are the
    ``ModelConfig`` fields."""
    if torch.device(device).type != "cuda" or dtype == "bf16":
        return
    if ATTN_IMPLEMENTATIONS.get(attn_implementation) in ("auto", "pallas"):
        raise ValueError(
            f"model.dtype={dtype} with model.attn_implementation={attn_implementation} on "
            f"{device}: the port's attention kernels take bf16 only (wgmma has no {dtype} "
            f"product); set model.dtype=bf16, or model.attn_implementation=math for small "
            f"shapes")


def load_pipeline(
    model_cfg: ModelConfig,
    sampler_cfg: SamplerConfig,
    data_cfg: DataConfig,
    device: torch.device | str = "cuda",
    **pipeline_kw,
) -> Diffuman4DPipeline:
    """The pipeline of ``model_cfg`` on ``device`` (the card unless the
    caller asks for the CPU); ``pipeline_kw`` (the condition-cache budgets)
    goes to :class:`Diffuman4DPipeline`.

    Weights are stored at ``model_cfg.param_dtype`` and computed at
    ``model_cfg.dtype``, as in the JAX package: they are rounded to the
    one and held at the other, which gives the numbers of flax's cast at
    use. Random weights at fp32 compute stay fp32. On a CUDA device with
    kernel attention, a dtype other than bf16 is refused before anything is
    loaded (:func:`check_attention_dtype`)."""
    dtype = DTYPES[model_cfg.dtype]
    if model_cfg.attn_implementation not in ATTN_IMPLEMENTATIONS:
        raise ValueError(f"model.attn_implementation={model_cfg.attn_implementation!r}; "
                         f"one of {sorted(ATTN_IMPLEMENTATIONS)}")
    check_attention_dtype(str(device), model_cfg.dtype, model_cfg.attn_implementation)
    attn = ATTN_IMPLEMENTATIONS[model_cfg.attn_implementation]
    sliding = sliding_from(sampler_cfg)
    model_dir = osp.expandvars(model_cfg.model_dir)

    if osp.isdir(osp.join(model_dir, "unet")):
        from diffuman4d_torch.io.checkpoints import load_hf_checkpoint

        log.info("loading diffusers-layout checkpoint from %s", model_dir)
        unet_config, vae_config, sched_cfg, unet_state, vae_state = load_hf_checkpoint(
            model_dir, dtype=DTYPES[model_cfg.param_dtype])
        scheduler = from_config(sched_cfg)
        if isinstance(unet_config, SVDUNetConfig):
            unet, vae = build_svd_models(unet_config, vae_config, device, dtype,
                                         state=(unet_state, vae_state))
            return SVDPipeline(unet, vae, scheduler, sliding=sliding,
                               image_size=data_cfg.height, cond_seed=sampler_cfg.seed,
                               device=device)
        unet, vae = _empty_models(unet_config, vae_config, device, attn)
        for module, state in ((unet, unet_state), (vae, vae_state)):
            module.to(dtype).load_state_dict(state)
        unet, vae = _finish(unet, dtype), _finish(vae, dtype)
    elif model_cfg.arch in SVD_ARCHS:
        log.warning("model_dir %s has no checkpoint -- using RANDOM-INIT %s weights",
                    model_dir, model_cfg.arch)
        pdt = torch.float32 if dtype == torch.float32 else DTYPES[model_cfg.param_dtype]
        tiny = model_cfg.arch == "svd-tiny"
        unet, vae = build_svd_models(SVDUNetConfig(**SVD_ARCHS[model_cfg.arch]),
                                     VAEConfig(**TINY_VAE) if tiny else VAEConfig(), device,
                                     pdt, sampler_cfg.seed)
        unet, vae = finish_svd(unet, dtype), finish_svd(vae, dtype)
        return SVDPipeline(unet, vae, from_config(SVD_SCHEDULER_CONFIG), sliding=sliding,
                           image_size=data_cfg.height, cond_seed=sampler_cfg.seed,
                           device=device)
    else:
        log.warning(
            "model_dir %s has no checkpoint -- using RANDOM-INIT weights "
            "(demo/benchmark mode; outputs are not meaningful images)", model_dir)
        tiny = model_cfg.arch == "tiny"
        unet_config = UNetConfig(**TINY_UNET) if tiny else UNetConfig()
        vae_config = VAEConfig(**TINY_VAE) if tiny else VAEConfig()
        scheduler = Scheduler(SchedulerConfig(kind="ddim"))
        pdt = torch.float32 if dtype == torch.float32 else DTYPES[model_cfg.param_dtype]
        unet, vae = build_models(unet_config, vae_config, device=device, dtype=pdt,
                                 seed=sampler_cfg.seed, attn_implementation=attn)
        unet, vae = _finish(unet, dtype), _finish(vae, dtype)
    return Diffuman4DPipeline(unet, vae, scheduler, sliding=sliding,
                              image_size=data_cfg.height, device=device, **pipeline_kw)
