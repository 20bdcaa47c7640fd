"""The weight carry: the JAX package's flax params, as numpy arrays, ->
the port's state dicts with diffusers key names.

Numpy only. It restates ``export_unet_torch_keys`` / ``export_vae_torch_keys``
of ``diffuman4d_tpu/io/checkpoints.py`` (which cannot be imported here: that
module imports ``jax.numpy`` and the flax models). Conv kernels go from flax
HWIO to PyTorch OIHW, dense kernels from (in, out) to (out, in), norm scales
become ``weight``. The mapping is linear (renames, transposes), so a flax
gradient tree and optax's Adam moments go through it unchanged
(:func:`grads_from_flax`, :func:`adam_state_from_flax`) and can be compared
with the port's key by key.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _leaf(out: dict, name: str, leaf: str, val: np.ndarray, path: str) -> None:
    if leaf == "kernel":
        if val.ndim == 4:
            out[f"{name}.weight"] = np.transpose(val, (3, 2, 0, 1))
        else:
            out[f"{name}.weight"] = np.transpose(val, (1, 0))
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
