"""Sliding-window schedule as precomputed index matrices.

The reference builds Python lists of index tensors with ``torch.roll``
(pipeline_diffuman4d.py:504-518); here the whole schedule is two static
int32 matrices consumed by a ``lax.fori_loop`` — no data-dependent control
flow inside jit.

Semantics (bit-parity with the reference):
  * for each direction in (-1,) or (-1, +1):
      for shift in range(shift0, shift0 + num_targets, stride):
        target_window = roll(target_indices, shift * direction)[:window_size]
  * spatial domain: input window = all input indices (every window sees all
    input cameras)
  * temporal domain: input window = target_window - num_inputs (the
    condition-track frame aligned with each target frame; target rows sit
    at [T, 2T), condition rows at [0, T))
  * the sequence fed to the model is concat([input_window, target_window])
"""

from __future__ import annotations

import numpy as np


def step_counts(
    window_size: int,
    sliding_stride: int,
    num_denoising_steps: int,
    bidirectional: bool,
    alternation_rounds: int,
) -> tuple[int, int]:
    """(steps per alternation, total steps per target latent)
    (pipeline_diffuman4d.py:463-472)."""
    if (window_size * num_denoising_steps) % sliding_stride != 0:
        raise ValueError(
            f"window_size ({window_size}) * num_denoising_steps "
            f"({num_denoising_steps}) must be divisible by sliding_stride "
            f"({sliding_stride})"
        )
    peralt = window_size * num_denoising_steps // sliding_stride
    if bidirectional:
        peralt *= 2
    return peralt, peralt * alternation_rounds


def build_windows(
    target_indices: np.ndarray,
    input_indices: np.ndarray,
    domain: str,
    window_size: int,
    sliding_stride: int = 1,
    sliding_shift: int = 0,
    bidirectional: bool = False,
) -> np.ndarray:
    """-> (num_windows, L) int32 window matrix, L = n_inputs + window_size
    (spatial) or 2 * window_size (temporal). Row = concat(inputs, targets);
    the last ``window_size`` entries of each row are the stepped targets."""
    target_indices = np.asarray(target_indices, np.int64)
    input_indices = np.asarray(input_indices, np.int64)
    n = len(target_indices)
    if window_size > n:
        raise ValueError(f"window_size ({window_size}) > num targets ({n})")
    if n % sliding_stride != 0:
        raise ValueError(f"num targets ({n}) % sliding_stride ({sliding_stride}) != 0")

    rows = []
    directions = (-1, 1) if bidirectional else (-1,)
    for direction in directions:
        for shift in range(sliding_shift, sliding_shift + n, sliding_stride):
            # torch.roll(x, s)[k] == x[(k - s) % n]
            k = np.arange(window_size)
            tw = target_indices[(k - shift * direction) % n]
            if domain == "spatial":
                iw = input_indices
            elif domain == "temporal":
                iw = tw - len(input_indices)
            else:
                raise ValueError(f"unknown domain: {domain}")
            rows.append(np.concatenate([iw, tw]))
    return np.stack(rows).astype(np.int32)
