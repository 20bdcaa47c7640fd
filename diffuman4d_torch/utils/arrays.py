"""Host array helpers (numpy only; the port's copy of what it uses of
``diffuman4d_tpu/utils/arrays.py``)."""

from __future__ import annotations

import numpy as np


def fast_stack(arrays, dtype=None) -> np.ndarray:
    """``np.stack`` via a preallocated buffer + per-element assignment.

    np.stack routes through np.concatenate, which on hosts with slow
    first-touch memory runs several times slower than a strided copy into
    one buffer for multi-MB image arrays.
    """
    arrays = list(arrays)
    a0 = np.asarray(arrays[0])
    out = np.empty((len(arrays),) + a0.shape, dtype or a0.dtype)
    for i, a in enumerate(arrays):
        out[i] = a
    return out
