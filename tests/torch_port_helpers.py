"""Shared setup for the PyTorch-port parity tests (tests/test_torch_port_*.py).

Builds a JAX (flax) module with random params, carries its numpy params into
the port through the port's weight carry (``diffuman4d_torch.io.checkpoints``)
and converts arrays between the two frameworks. Everything runs in fp32 on
the CPU; inputs come from numpy with a seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuman4d_torch.io.checkpoints import (
    _flatten,
    _leaf,
    _unmap_block_path,
    load_numpy_state_dict,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)

# a UNet with the production topology at toy widths (4 stages, the deepest
# three with 3D attention, temporal embeddings and pose encoder on)
TINY_UNET = dict(
    in_channels=11,
    block_out_channels=(8, 8, 16, 16),
    num_attention_heads=(1, 1, 2, 2),
    layers_per_block=1,
    norm_num_groups=4,
    num_3d_attn_blocks=3,
    enable_tem_embeds=True,
    enable_pose_encoder=True,
)
TINY_VAE = dict(block_out_channels=(4, 4, 8, 8), layers_per_block=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in the modules that import it: tiny shapes run as fast on one
    torch thread, and the suite's other workers keep the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def randn(r: np.random.Generator, *shape, scale: float = 1.0) -> np.ndarray:
    return (r.standard_normal(shape) * scale).astype(np.float32)


def t(x) -> torch.Tensor:
    """numpy / jax array -> fp32 CPU torch tensor."""
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


def j(x) -> jnp.ndarray:
    return jnp.asarray(np.asarray(x, np.float32))


def n(x) -> np.ndarray:
    """torch / jax -> numpy fp32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def perturb_params(params, seed: int = 1, scale: float = 0.2):
    """Add noise to every leaf: flax's zero / one initialisations (biases,
    norm scales, zero-init heads) would hide transposition and naming
    errors in the carry."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    r = rng(seed)
    leaves = [jnp.asarray(np.asarray(x, np.float32) + randn(r, *x.shape, scale=scale))
              for x in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def block_state_dict(params: dict, wrap: str | None = None) -> dict[str, np.ndarray]:
    """Carry one flax submodule's ``params`` into diffusers names, as the
    port's UNet carry does for each block. ``wrap`` names a parent path
    segment the mapping needs (e.g. "ff" for a standalone FeedForward); it
    is stripped again from the result."""
    out: dict[str, np.ndarray] = {}
    for path, val in _flatten(params).items():
        parts = path.split("/")
        body = ([wrap] if wrap else []) + parts[:-1]
        _leaf(out, _unmap_block_path(body), parts[-1], val, path)
    if wrap:
        out = {k[len(wrap) + 1:]: v for k, v in out.items()}
    # a leaf of the module itself maps to ".weight" / ".bias"
    return {k.lstrip("."): v for k, v in out.items()}


def load_block(module: torch.nn.Module, params: dict, wrap: str | None = None):
    load_numpy_state_dict(module, block_state_dict(params, wrap))
    return module.eval()


def jax_unet(cfg_kwargs: dict, seed: int = 0, num_frames: int = 2, latent: int = 8,
             perturb: bool = True):
    """(flax module, variables) for a UNet config, fp32, "xla" attention."""
    from diffuman4d_tpu.models.unet import UNetConfig, UNetMultiviewCondition

    cfg = UNetConfig(**cfg_kwargs)
    mod = UNetMultiviewCondition(cfg, dtype=jnp.float32, attn_implementation="xla")
    x = jnp.zeros((num_frames, latent, latent, cfg.in_channels))
    sk = jnp.zeros((num_frames, latent * 8, latent * 8, 3))
    params = jax.jit(lambda k: mod.init(k, x, jnp.zeros((num_frames,), jnp.int32), sk,
                                        num_frames=num_frames))(jax.random.PRNGKey(seed))
    if perturb:
        params = perturb_params(params, seed + 1)
    return mod, params


def port_unet(cfg_kwargs: dict, params: dict):
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition

    unet = UNetMultiviewCondition(UNetConfig(**cfg_kwargs)).float()
    load_numpy_state_dict(unet, unet_state_dict_from_flax(params["params"]))
    return unet.eval()


def jax_vae(cfg_kwargs: dict, seed: int = 0, image: int = 64, perturb: bool = True):
    from diffuman4d_tpu.models.vae import AutoencoderKL, VAEConfig

    mod = AutoencoderKL(VAEConfig(**cfg_kwargs), dtype=jnp.float32)
    params = jax.jit(lambda k: mod.init(k, jnp.zeros((1, image, image, 3))))(
        jax.random.PRNGKey(seed))
    if perturb:
        params = perturb_params(params, seed + 1, scale=0.05)
    return mod, params


def port_vae(cfg_kwargs: dict, params: dict):
    from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig

    vae = AutoencoderKL(VAEConfig(**cfg_kwargs)).float()
    load_numpy_state_dict(vae, vae_state_dict_from_flax(params["params"]))
    return vae.eval()


def jit_apply(mod, method=None, **static):
    """Jitted ``mod.apply`` (eager flax dispatch is several times slower
    on the CPU than one compiled program)."""
    return jax.jit(lambda p, *a: mod.apply(p, *a, method=method, **static))
