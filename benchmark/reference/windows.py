"""Plain reference of the sliding-window schedule (zju3dv/Diffuman4D
``pipeline_diffuman4d.py``): which rows each window of a task holds, and how
many steps a target latent takes in a round and in all. The schedule is the
sampler's, whatever model denoises the windows."""

from __future__ import annotations

import numpy as np


def step_counts(window: int, stride: int, n_denoise: int, bidirectional: bool,
                rounds: int) -> tuple[int, int]:
    """(steps per round, steps per frame) of a target latent."""
    per = window * n_denoise // stride * (2 if bidirectional else 1)
    return per, per * rounds


def windows(targets, inputs, domain: str, window: int, stride: int, shift: int = 0,
            bidirectional: bool = False) -> np.ndarray:
    """(n_windows, L) rows of each window: inputs first, then the targets
    stepped; a temporal window's inputs are the condition track's frames
    aligned with its targets."""
    targets = np.asarray(targets, np.int64)
    n = len(targets)
    out = []
    for direction in ((-1, 1) if bidirectional else (-1,)):
        for s in range(shift, shift + n, stride):
            tw = targets[(np.arange(window) - s * direction) % n]
            iw = np.asarray(inputs, np.int64) if domain == "spatial" else tw - len(inputs)
            out.append(np.concatenate([iw, tw]))
    return np.stack(out)
