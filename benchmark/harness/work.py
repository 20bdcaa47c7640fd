"""The work a window needs, counted from the configuration's widths and the
window's shapes, never from the program's launch records: the model FLOPs of
every UNet forward, VAE encode and decode and pose-encoder pass (products
only, each multiply-add two FLOPs), and the least time of every attention
call on the card's roofline. The reference modules run on the meta device
under ``FlopCounterMode``, so the count is the plain model's arithmetic.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s
(at the full 700 W power limit).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import models as ref

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BYTES_PER_ELEMENT = 2  # bf16 operands and outputs


def attention_least_s(b: int, s: int, h: int, d: int, sk: int | None = None) -> float:
    """Least time of one attention call (B, S, H, D) x (B, Sk, H, D): the
    larger of 4 B H S Sk D FLOPs at the bf16 peak and Q, K, V read once and
    the output written once at the HBM rate."""
    sk = s if sk is None else sk
    flops = 4.0 * b * h * s * sk * d
    nbytes = BYTES_PER_ELEMENT * b * h * d * (2 * s + 2 * sk)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def _count(fn) -> tuple[float, float]:
    """(FLOPs, attention least seconds) of ``fn()`` on meta tensors."""
    sites = []
    orig = ref.attention

    def record(p, q, k, v):
        sites.append((q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1]))
        return orig(p, q, k, v)

    ref.attention = record
    try:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
    finally:
        ref.attention = orig
    least = sum(attention_least_s(b, s, h, d, sk) for b, s, h, d, sk in sites)
    return float(fc.get_total_flops()), least


@functools.cache
def _modules(unet_cfg: tuple, vae_cfg: tuple):
    with torch.device("meta"):
        return ref.UNet(dict(unet_cfg)), ref.VAE(dict(vae_cfg))


def _frozen(d: dict) -> tuple:
    return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(d.items()))


class Work:
    """Per-call work of one configuration at one image size."""

    def __init__(self, config: dict, image_size: int):
        unet, vae = _modules(_frozen(config["unet"]), _frozen(config["vae"]))
        self.unet, self.vae = unet, vae
        self.size = image_size
        self.latent = image_size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        self.ucfg = config["unet"]
        self._cache: dict = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = _count(fn)
        return self._cache[key]

    def unet_forward(self, rows: int, frames: int) -> tuple[float, float]:
        """One UNet forward over ``rows`` rows attending across ``frames``."""
        def fn():
            lat = self.latent
            x = torch.empty(rows, lat, lat, self.ucfg["in_channels"], device="meta")
            t = torch.zeros(rows, dtype=torch.int64, device="meta")
            pose = (torch.empty(rows, lat, lat, self.ucfg["block_out_channels"][0],
                                device="meta") if self.ucfg["enable_pose_encoder"] else None)
            self.unet(x, t, t, frames, pose_features=pose)
        return self._memo(("unet", rows, frames), fn)

    def vae_encode(self) -> tuple[float, float]:
        """One frame's VAE encode (the posterior draw's products only)."""
        return self._memo(("enc",), lambda: self.vae.encode(
            torch.empty(1, self.size, self.size, 3, device="meta"),
            torch.empty(1, self.latent, self.latent, 4, device="meta")))

    def vae_decode(self) -> tuple[float, float]:
        return self._memo(("dec",), lambda: self.vae.decode(
            torch.empty(1, self.latent, self.latent, 4, device="meta")))

    def pose_encode(self) -> tuple[float, float]:
        return self._memo(("pose",), lambda: self.unet.pose_encoder(
            torch.empty(1, self.size, self.size, 3, device="meta")))
