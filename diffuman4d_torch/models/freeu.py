"""FreeU (arXiv 2309.11497; counterpart of ``diffuman4d_tpu/models/freeu.py``).

At the first two up stages the backbone features' first half of the
channels is scaled (b1 / b2) and the skip connection's lowest frequencies
are scaled in Fourier space (s1 / s2). Channels-last, as the UNet's
activations. The tuple keeps the JAX package's order ``(b1, b2, s1, s2)``
(not diffusers' ``enable_freeu(s1, s2, b1, b2)``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FreeUConfig(NamedTuple):
    b1: float = 1.5
    b2: float = 1.6
    s1: float = 0.9
    s2: float = 0.2


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred ``2 * threshold`` square of lowest frequencies of a
    (B, H, W, C) map; the FFT runs in fp32 (there is no bf16 FFT)."""
    xf = torch.fft.fftn(x.float(), dim=(1, 2))
    xf = torch.fft.fftshift(xf, dim=(1, 2))
    _, h, w, _ = x.shape
    cy, cx = h // 2, w // 2
    mask = torch.ones((1, h, w, 1), dtype=torch.float32, device=x.device)
    mask[:, cy - threshold : cy + threshold, cx - threshold : cx + threshold, :] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(x.dtype)


def apply_freeu(resolution_idx: int, hidden: torch.Tensor, skip: torch.Tensor,
                cfg: Optional[FreeUConfig]) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale the backbone's half channels and low-pass the skip at up
    stages 0 and 1; elsewhere, or without a config, both pass through."""
    if cfg is None or resolution_idx not in (0, 1):
        return hidden, skip
    b, s = (cfg.b1, cfg.s1) if resolution_idx == 0 else (cfg.b2, cfg.s2)
    half = hidden.shape[-1] // 2
    hidden = torch.cat([hidden[..., :half] * b, hidden[..., half:]], dim=-1)
    return hidden, fourier_filter(skip, threshold=1, scale=s)
