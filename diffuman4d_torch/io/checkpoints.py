"""Weights in the port's state dicts (diffusers key names): the carry of
the JAX package's flax params, and diffusers checkpoint directories.

The carry (:func:`state_dicts_from_flax`) is numpy only. It restates
``export_unet_torch_keys`` / ``export_vae_torch_keys`` of
``diffuman4d_tpu/io/checkpoints.py`` (which cannot be imported here: that
module imports ``jax.numpy`` and the flax models). Conv kernels go from flax
HWIO to PyTorch OIHW, dense kernels from (in, out) to (out, in), norm scales
become ``weight``. The mapping is linear (renames, transposes), so a flax
gradient tree and optax's Adam moments go through it unchanged
(:func:`grads_from_flax`, :func:`adam_state_from_flax`) and can be compared
with the port's key by key.

A diffusers directory (``unet/``, ``vae/``, ``scheduler/``, each with its
``config.json`` and ``diffusion_pytorch_model.safetensors``) is written by
:func:`save_hf_checkpoint` and read by :func:`load_hf_checkpoint`, the
counterparts of the JAX package's functions of the same names: a directory
either package writes loads in the other. The safetensors files are read
and written with numpy (:func:`read_safetensors`, :func:`write_safetensors`),
without the ``safetensors`` package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp

import numpy as np
import torch

from diffuman4d_torch.models.unet import UNetConfig
from diffuman4d_torch.models.vae import VAEConfig


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v), key))
        else:
            out[key] = np.asarray(v)
    return out


def _unmap_block_path(parts: list[str]) -> str:
    """flax path inside one UNet down/mid/up block -> diffusers suffix."""
    out = []
    in_ff = False
    for p in parts:
        if p.startswith("resnets_"):
            out.append(f"resnets.{p.split('_')[1]}")
        elif p.startswith("attentions_"):
            out.append(f"attentions.{p.split('_')[1]}")
        elif p.startswith("blocks_"):
            out.append(f"transformer_blocks.{p.split('_')[1]}")
        elif p == "downsample":
            out.append("downsamplers.0")
        elif p == "upsample":
            out.append("upsamplers.0")
        elif p in ("GroupNorm_0", "LayerNorm_0"):
            pass  # flax wrapper level
        elif p == "to_out":
            out.append("to_out.0")
        elif p == "ff":
            in_ff = True
        elif p == "proj_geglu":
            out.append("ff.net.0.proj")
        elif p == "proj_out" and in_ff:
            out.append("ff.net.2")
        else:
            out.append(p)
    return ".".join(out)


# a flax kernel's axes in torch layout: conv HWIO -> OIHW, dense (in, out) ->
# (out, in), by the kernel's ndim
KERNEL_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}


def torch_dim_of_flax_axis(name: str, ndim: int, axis: int) -> int:
    """The dim of the port's tensor ``name`` (ndim ``ndim``) that holds
    axis ``axis`` of the flax leaf it was carried from: kernels are
    transposed (every ``.weight`` of ndim 2 or 4; norm scales are 1-D),
    other leaves keep their axes."""
    if name.endswith(".weight") and ndim in KERNEL_TO_TORCH:
        return KERNEL_TO_TORCH[ndim].index(axis)
    return axis


def _leaf(out: dict, name: str, leaf: str, val: np.ndarray, path: str) -> None:
    if leaf == "kernel":
        out[f"{name}.weight"] = np.transpose(val, KERNEL_TO_TORCH[4 if val.ndim == 4 else 2])
    elif leaf == "scale":
        out[f"{name}.weight"] = val
    elif leaf == "bias":
        out[f"{name}.bias"] = val
    else:
        raise KeyError(f"unknown leaf {leaf} at {path}")


def unet_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """flax UNet ``params`` tree -> diffusers-named state dict (numpy)."""
    pose_conv_inv = {0: 0, 1: 2, 2: 4, 3: 6, 4: 8, 5: 10, 6: 12, 7: 14}
    out: dict[str, np.ndarray] = {}
    for path, val in _flatten(params).items():
        parts = path.split("/")
        leaf, body = parts[-1], parts[:-1]
        if body and body[0] == "pose_encoder":
            if leaf == "scale" and len(body) == 1:
                out["pose_encoder.scale"] = val
                continue
            if body[-1] == "final_proj":
                name = "pose_encoder.final_proj"
            else:
                idx = int(body[-1].split("_")[1])
                name = f"pose_encoder.conv_layers.{pose_conv_inv[idx]}"
        elif body and body[0].startswith(("down_blocks_", "up_blocks_")):
            kind, idx = body[0].rsplit("_", 1)
            name = f"{kind}.{idx}." + _unmap_block_path(body[1:])
        elif body and body[0] == "mid_block":
            name = "mid_block." + _unmap_block_path(body[1:])
        elif body and body[0] in ("time_embedding", "temporal_pos_embed"):
            name = ".".join(body)
        elif body and body[0] in ("conv_in", "conv_out", "conv_norm_out"):
            name = body[0]
        else:
            raise KeyError(f"unmapped flax param: {path}")
        _leaf(out, name, leaf, val, path)
    return out


def vae_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """flax AutoencoderKL ``params`` tree -> diffusers state dict (numpy)."""
    amap = {"group_norm": "group_norm", "to_q": "to_q", "to_k": "to_k",
            "to_v": "to_v", "to_out": "to_out.0"}
    out: dict[str, np.ndarray] = {}
    for path, val in _flatten(params).items():
        parts = path.split("/")
        leaf, body = parts[-1], parts[:-1]
        if body[0] in ("quant_conv", "post_quant_conv"):
            name = body[0]
        elif body[0] in ("encoder", "decoder"):
            side, head = body[0], body[1]
            if head in ("conv_in", "conv_out", "conv_norm_out"):
                name = f"{side}.{head}"
            elif head == "mid_block":
                if body[2].startswith("resnets_"):
                    name = f"{side}.mid_block." + _unmap_block_path(body[2:])
                elif body[2] == "attention":
                    name = f"{side}.mid_block.attentions.0.{amap[body[3]]}"
                else:
                    raise KeyError(f"unmapped vae mid param: {path}")
            elif head.startswith(("down_", "up_")):
                # down_{i}_resnets_{j} | down_{i}_downsample | up_{i}_upsample
                bits = head.split("_")
                kind, idx = bits[0], bits[1]
                if "resnets" in head:
                    name = f"{side}.{kind}_blocks.{idx}.resnets.{bits[-1]}"
                elif head.endswith("downsample"):
                    name = f"{side}.{kind}_blocks.{idx}.downsamplers.0"
                elif head.endswith("upsample"):
                    name = f"{side}.{kind}_blocks.{idx}.upsamplers.0"
                else:
                    raise KeyError(f"unmapped vae block param: {path}")
                rest = _unmap_block_path(body[2:])
                if rest:
                    name += "." + rest
            else:
                raise KeyError(f"unmapped vae param: {path}")
        else:
            raise KeyError(f"unmapped vae param: {path}")
        _leaf(out, name, leaf, val, path)
    return out


def state_dicts_from_flax(unet_params: dict, vae_params: dict):
    """(unet, vae) flax ``params`` trees -> (unet, vae) numpy state dicts."""
    return unet_state_dict_from_flax(unet_params), vae_state_dict_from_flax(vae_params)


def grads_from_flax(unet_grads: dict) -> dict[str, np.ndarray]:
    """A flax gradient tree of the UNet ``params`` -> numpy dict keyed like
    the port's ``named_parameters``."""
    return unet_state_dict_from_flax(unet_grads)


def adam_state_from_flax(opt_state) -> dict:
    """An optax optimiser state that holds one Adam state (any nesting of
    tuples, as ``optax.chain`` builds) -> ``{"count", "mu", "nu"}`` in the
    layout of the port's ``training.trainer.Optimizer``."""
    def find(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                if (hit := find(child)) is not None:
                    return hit
        return None

    adam = find(opt_state)
    if adam is None:
        raise KeyError("no Adam state (mu, nu) in the optimiser state")
    return {"count": int(adam.count), "mu": unet_state_dict_from_flax(adam.mu),
            "nu": unet_state_dict_from_flax(adam.nu)}


def load_numpy_state_dict(module: torch.nn.Module, state: dict[str, np.ndarray]) -> None:
    """Copy a numpy state dict into ``module`` key for key (strict), each
    value cast to the parameter's dtype and device."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for name, param in own.items():
            src = np.array(state[name], dtype=np.float32)  # a writable copy
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {src.shape} != {tuple(param.shape)}")
            param.copy_(torch.from_numpy(src).to(param.dtype))


# -------------------------------------------------------------- safetensors
# The format: an 8-byte little-endian header length, a JSON header that maps
# each tensor's name to its dtype, shape and [begin, end) byte offsets into
# the data that follows, then the raw little-endian bytes.
_HEADER_MAX = 100 << 20


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as an fp32 numpy array (F32, F16
    and BF16 are read; BF16 widens exactly)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if not 0 < n <= _HEADER_MAX:
            raise ValueError(f"{path}: not a safetensors file (header length {n})")
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    header.pop("__metadata__", None)
    out = {}
    for name, meta in header.items():
        begin, end = meta["data_offsets"]
        if not 0 <= begin <= end <= data.size:
            raise ValueError(f"{path}: {name} lies outside the file")
        raw, kind = data[begin:end], meta["dtype"]
        if kind == "F32":
            arr = np.require(raw.view("<f4"), requirements="A")
        elif kind == "F16":
            arr = raw.view("<f2").astype(np.float32)
        elif kind == "BF16":
            arr = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            raise ValueError(f"{path}: {name} has dtype {kind}; F32, F16 and BF16 are read")
        out[name] = arr.reshape(meta["shape"])
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write ``tensors`` as F32, in name order."""
    arrays = {k: np.ascontiguousarray(v, "<f4") for k, v in sorted(tensors.items())}
    header, offset = {}, 0
    for name, arr in arrays.items():
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for arr in arrays.values():
            arr.tofile(f)


# ------------------------------------------------------ diffusers directories
_WEIGHTS = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.fp16.safetensors")


def _numpy_state(module: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}


def save_hf_checkpoint(model_dir: str, unet: torch.nn.Module, vae: torch.nn.Module,
                       scheduler_config: dict | None = None) -> str:
    """Write a diffusers-layout checkpoint directory of the port's UNet and
    VAE (weights as F32, whatever the modules' dtype; every config field as
    it is, ``enable_pose_encoder`` and ``in_channels`` among them) and
    ``scheduler_config`` (default: DDIM), which both this package and the
    JAX package load."""
    for sub in ("unet", "vae", "scheduler"):
        os.makedirs(osp.join(model_dir, sub), exist_ok=True)
    write_safetensors(osp.join(model_dir, "unet", _WEIGHTS[0]), _numpy_state(unet))
    write_safetensors(osp.join(model_dir, "vae", _WEIGHTS[0]), _numpy_state(vae))

    ucfg = dataclasses.asdict(unet.config)
    ucfg["_class_name"] = "UNetMultiviewConditionModel"
    # diffusers' naming bug: its attention_head_dim is the per-stage head count
    ucfg["attention_head_dim"] = list(ucfg.pop("num_attention_heads"))
    vcfg = dataclasses.asdict(vae.config)
    vcfg["_class_name"] = "AutoencoderKL"
    for sub, name, cfg in (("unet", "config.json", ucfg), ("vae", "config.json", vcfg),
                           ("scheduler", "scheduler_config.json",
                            scheduler_config or {"_class_name": "DDIMScheduler"})):
        with open(osp.join(model_dir, sub, name), "w") as f:
            json.dump(cfg, f, indent=2)
    return model_dir


def unet_config_from_hf(cfg: dict) -> UNetConfig:
    """diffusers ``config.json`` -> UNetConfig (diffusers naming-bug note:
    ``attention_head_dim`` there is the per-stage head *count*)."""
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    if isinstance(heads, int):
        heads = (heads,) * len(cfg.get("block_out_channels", (320, 640, 1280, 1280)))
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        num_attention_heads=tuple(heads),
        transformer_layers_per_block=cfg.get("transformer_layers_per_block", 1),
        use_linear_projection=cfg.get("use_linear_projection", False),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        freq_shift=cfg.get("freq_shift", 0),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        num_3d_attn_blocks=cfg.get("num_3d_attn_blocks", 3),
        enable_tem_embeds=cfg.get("enable_tem_embeds", False),
        enable_pose_encoder=cfg.get("enable_pose_encoder", False),
    )


def vae_config_from_hf(cfg: dict) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def load_hf_checkpoint(model_dir: str, dtype: torch.dtype = torch.bfloat16):
    """Read a diffusers-layout checkpoint directory.

    ``dtype`` is the storage dtype of the weights, as in the JAX package
    (bf16 by default, the reference's ``from_pretrained``): every weight is
    rounded to it here. The caller holds them at the compute dtype, which
    gives the numbers flax's cast at use gives.

    Returns ``(unet_config, vae_config, scheduler_config, unet_state,
    vae_state)``; the states map diffusers names to CPU tensors of
    ``dtype``."""
    def read_json(*parts):
        with open(osp.join(model_dir, *parts)) as f:
            return json.load(f)

    def weights(sub):
        for name in _WEIGHTS:
            path = osp.join(model_dir, sub, name)
            if osp.isfile(path):
                return {k: torch.from_numpy(v).to(dtype) for k, v in read_safetensors(path).items()}
        raise FileNotFoundError(f"no safetensors found under {model_dir}/{sub}")

    return (unet_config_from_hf(read_json("unet", "config.json")),
            vae_config_from_hf(read_json("vae", "config.json")),
            read_json("scheduler", "scheduler_config.json"),
            weights("unet"), weights("vae"))
