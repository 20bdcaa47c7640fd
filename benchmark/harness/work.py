"""The arithmetic of the work a window needs, whatever the model: the FLOPs of
a call on meta tensors and the least time of each attention site on the
card's roofline. What the calls are (which modules run, how often, at which
shapes) is a family's (``benchmark/families/<family>.py``); it counts each
call here, on its plain reference's modules, never from the program's launch
records. FLOPs are products only, each multiply-add two FLOPs.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s
(at the full 700 W power limit).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

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


def count(fn, module) -> tuple[float, float]:
    """(FLOPs, attention least seconds) of ``fn()`` on meta tensors. The
    attention sites are the calls of ``module.attention(prec, q, k, v)``,
    the plain reference's one attention function, each (B, S, H, D)."""
    sites = []
    orig = module.attention

    def record(p, q, k, v):
        sites.append((q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1]))
        return orig(p, q, k, v)

    module.attention = record
    try:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
    finally:
        module.attention = orig
    least = sum(attention_least_s(b, s, h, d, sk) for b, s, h, d, sk in sites)
    return float(fc.get_total_flops()), least
