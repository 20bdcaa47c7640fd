"""Shared setup of the port's training tests against the JAX package
(``tests/test_torch_port_training.py``, ``tests/test_torch_port_train_steps.py``):
a batch of windows from numpy, the JAX draws of ``t`` / ``eps``, the port's
UNet from the JAX module's weights, and the key-by-key comparison."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import TINY_UNET, j, jax_unet, n, randn, rng, t

B, L, LAT = 2, 4, 8


def batch(seed=0):
    r = rng(seed)
    is_cond = np.zeros((B, L), bool)
    is_cond[:, : L // 2] = True
    return {"latents_x0": randn(r, B, L, LAT, LAT, 4), "plucker": randn(r, B, L, LAT, LAT, 6),
            "skeletons": randn(r, B, L, LAT * 8, LAT * 8, 3, scale=0.5), "is_cond": is_cond}


def jbatch(b):
    return {k: (jnp.asarray(v) if v.dtype == bool else j(v)) for k, v in b.items()}


def tbatch(b):
    return {k: (torch.from_numpy(v) if v.dtype == bool else t(v)) for k, v in b.items()}


def jax_draw(key, num_train_timesteps=1000):
    """The (t, eps) that the JAX ``diffusion_loss`` draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jax.random.randint(k_t, (B,), 0, num_train_timesteps, jnp.int32)
    eps = jax.random.normal(k_eps, (B, L, LAT, LAT, 4), jnp.float32)
    return torch.from_numpy(np.array(tt)), torch.from_numpy(np.array(eps))


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_unet(TINY_UNET, num_frames=L, latent=LAT)
    return jmod, jparams


def port_model(jparams):
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.io.checkpoints import load_numpy_state_dict, unet_state_dict_from_flax

    unet = UNetMultiviewCondition(UNetConfig(**TINY_UNET)).float().eval()
    load_numpy_state_dict(unet, unet_state_dict_from_flax(jparams["params"]))
    return unet


def assert_by_key(got: dict, want: dict, rel: float, what: str, floor: float = 0.0):
    """Every tensor within ``rel`` of its largest entry (plus ``floor``,
    for a tensor that is itself a cancelling sum, as the one-element
    gradient of the pose encoder's scale is)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        bound = rel * max(np.abs(w).max(), 1e-30) + floor
        assert np.abs(n(got[k]) - w).max() <= bound, f"{what}: {k}"


