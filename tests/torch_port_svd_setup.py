"""Shared set-up of the SVD tests: the tiny widths, seeded random weights
drawn once and loaded into both the port's modules and the plain reference
(``benchmark/reference/svd.py``), fp32 on the CPU, one torch thread."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import weights as W
from benchmark.reference import svd as ref
from diffuman4d_torch.models.unet_spatiotemporal import SVDUNetConfig
from diffuman4d_torch.models.vae import VAEConfig
from diffuman4d_torch.sampling.loader import build_svd_models

TINY_UNET = dict(in_channels=8, out_channels=4, block_out_channels=[8, 16, 16, 16],
                 num_attention_heads=[1, 2, 2, 2], layers_per_block=1, norm_num_groups=4,
                 transformer_layers_per_block=1, cross_attention_dim=16,
                 addition_time_embed_dim=8, projection_class_embeddings_input_dim=24)
TINY_VAE = dict(block_out_channels=[4, 4, 8, 8], layers_per_block=1, latent_channels=4,
                scaling_factor=0.18215)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def models(seed: int = 0, unet: dict = TINY_UNET, vae: dict = TINY_VAE):
    """((port unet, port vae), (reference unet, reference vae)), fp32 on the
    CPU, the same weights: every parameter drawn by the benchmark's rule
    (the mixes near sigmoid(1), every path reaching the output)."""
    with torch.device("meta"):
        spec = W.spec({"unet": ref.UNet(unet), "vae": ref.VAE(vae)})
    w = W.make_weights(spec, seed, "cpu", torch.float32)
    state = (W.split(w, "unet"), W.split(w, "vae"))
    port = build_svd_models(SVDUNetConfig(**_tuples(unet)), VAEConfig(**_tuples(vae)), "cpu",
                            torch.float32, state=state)
    r_unet, r_vae = ref.UNet(unet).eval(), ref.VAE(vae).eval()
    r_unet.load_state_dict(state[0], strict=True)
    r_vae.load_state_dict(state[1], strict=True)
    return port, (r_unet, r_vae)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the reference's largest magnitude."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())
