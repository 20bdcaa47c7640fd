"""Training data: window batches sampled from a SpaTemDataset scene
(counterpart of ``diffuman4d_tpu/training/data.py``).

Batches match the inference contract: each element is one window --
spatial: input cameras + ``window_size`` contiguous-roll target cameras at
one frame; temporal: the nearest condition camera's track + one target
camera over ``window_size`` frames. Targets' clean VAE latents are the
diffusion x0; condition rows are flagged in ``is_cond``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.data.dataset import SpaTemDataset
from diffuman4d_torch.data.rays import calc_plucker_embeds_lowres
from diffuman4d_torch.utils.arrays import fast_stack


@dataclass
class WindowBatcherConfig:
    window_size: int = 12
    spa_labels: list[str] | None = None
    tem_labels: list[str] | None = None
    input_spa_labels: list[str] = None


class WindowBatcher:
    def __init__(self, dataset: SpaTemDataset, cfg: WindowBatcherConfig):
        self.dataset = dataset
        self.cfg = cfg
        cams = dataset.cameras[dataset.scene_label]
        self.spa_labels = cfg.spa_labels or sorted(cams.keys())
        self.input_spa_labels = list(cfg.input_spa_labels)
        self.target_spa_labels = [
            s for s in self.spa_labels if s not in self.input_spa_labels
        ]
        self.tem_labels = cfg.tem_labels

    def sample_window(self, rng: np.random.Generator, domain: str):
        """-> dataset Sample for one training window."""
        w = self.cfg.window_size
        if domain == "spatial":
            tem = rng.choice(self.tem_labels)
            start = rng.integers(0, len(self.target_spa_labels))
            idx = [(start + i) % len(self.target_spa_labels) for i in range(w)]
            spa = self.input_spa_labels + [self.target_spa_labels[i] for i in idx]
            # dataset API wants full spa list ordering for spatial samples
            sample = self.dataset.get_item(
                scene_label=self.dataset.scene_label,
                spa_labels=spa,
                tem_labels=[tem],
                input_spa_labels=self.input_spa_labels,
            )
        elif domain == "temporal":
            target_cam = rng.choice(self.target_spa_labels)
            start = rng.integers(0, len(self.tem_labels))
            tems = [
                self.tem_labels[(start + i) % len(self.tem_labels)] for i in range(w)
            ]
            sample = self.dataset.get_item(
                scene_label=self.dataset.scene_label,
                spa_labels=[target_cam],
                tem_labels=tems,
                input_spa_labels=self.input_spa_labels,
            )
        else:
            raise ValueError(domain)
        return sample

    def make_batch(self, rng: np.random.Generator, batch_size: int, domain: str):
        """-> dict of stacked numpy arrays for ``encode_training_batch``."""
        samples = [self.sample_window(rng, domain) for _ in range(batch_size)]
        return {
            "pixel_values": fast_stack([s.pixel_values for s in samples]),
            "skeletons": fast_stack([s.skeletons for s in samples]),
            "is_cond": np.stack([s.cond_masks == 0.0 for s in samples]),
            "Ks": np.stack([s.Ks for s in samples]),
            "poses": np.stack([s.poses for s in samples]),
        }


@torch.no_grad()
def encode_training_batch(pipeline, raw: dict, generator: torch.Generator | None = None,
                          noise: torch.Tensor | None = None, rows: slice | None = None) -> dict:
    """Host batch -> device train-step batch: VAE-encode ALL rows' clean
    pixels (targets need x0 latents for the loss; the VAE stays frozen),
    Plücker rays at latent resolution. The VAE posterior noise
    (B*L, h, w, 4) is drawn from ``generator`` unless given. With ``rows``
    (a data row's share, ``trainer.data_rows``) only those windows of the
    batch are encoded, with their rows of the whole batch's noise."""
    B, L = raw["pixel_values"].shape[:2]
    dev, dtype = pipeline.device, pipeline.dtype
    lat, lc = pipeline.latent_size, pipeline.latent_channels
    if noise is None:
        if generator is None:
            raise ValueError("encode_training_batch needs a generator or the posterior noise")
        noise = torch.randn((B * L, lat, lat, lc), generator=generator, device=generator.device)
    if rows is not None:
        raw = {k: v[rows] for k, v in raw.items()}
        noise = noise.reshape((B, L) + tuple(noise.shape[1:]))[rows].flatten(0, 1)
        B = raw["pixel_values"].shape[0]
    pix = torch.from_numpy(np.ascontiguousarray(
        raw["pixel_values"].reshape((B * L,) + raw["pixel_values"].shape[2:]), np.float32))
    z = pipeline.encode_images(pix.to(dev, dtype), noise.to(dev, torch.float32))
    Ks = torch.from_numpy(np.asarray(raw["Ks"], np.float32).reshape(B * L, 3, 3)).to(dev)
    poses = torch.from_numpy(np.asarray(raw["poses"], np.float32).reshape(B * L, 4, 4)).to(dev)
    plucker = calc_plucker_embeds_lowres(pipeline.image_size, pipeline.image_size, Ks, poses,
                                         lat, lat)
    return {
        "latents_x0": z.reshape(B, L, lat, lat, lc),
        "plucker": plucker.reshape(B, L, lat, lat, 6).to(dtype),
        "skeletons": torch.from_numpy(np.ascontiguousarray(raw["skeletons"], np.float32)).to(
            dev, dtype),
        "is_cond": torch.from_numpy(np.asarray(raw["is_cond"])).to(dev),
    }
