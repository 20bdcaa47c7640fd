"""Host array helpers and the byte-budgeted LRU (numpy only; the port's copy
of ``diffuman4d_tpu/utils/arrays.py``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class ByteLRU:
    """Byte-budgeted LRU cache for device-resident tensors.

    The pipeline's per-frame condition caches need a closed memory loop: a
    demo_4d grid has 7,200 (camera, frame) cells, so an insert evicts
    least-recently-used entries until the configured byte budget holds, and
    an entry larger than the whole budget is never cached. ``get`` and
    ``value`` refresh an entry's recency. An evicted tensor is freed when its
    last reference drops, so a consumer that still holds it is unaffected.
    """

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.nbytes = 0
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def put(self, key, value, nbytes: int) -> None:
        if key in self._d:
            self._d.move_to_end(key)
            return
        if nbytes > self.budget:
            return  # a single entry over budget: never cached
        self._d[key] = (value, nbytes)
        self.nbytes += nbytes
        while self.nbytes > self.budget:
            _, (_, freed) = self._d.popitem(last=False)
            self.nbytes -= freed

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def value(self, key):
        v = self.get(key)
        return None if v is None else v[0]

    def clear(self) -> None:
        self._d.clear()
        self.nbytes = 0


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
