"""Writer of the sampler's grid-state file (``.d4d``): the benchmark's
frozen copy of the port's ``io/gridstate.py`` writer, which seeds the state
that the temporal cells resume from.

One file holds the sampler's latent grid, its timestep-index grid and a
small JSON ``meta``: a JSON header and raw array blobs, written with one
large write per array. bf16 grids are stored as their uint16 bit patterns
(the caller bitcasts), so a file is half the size of an fp32 cast and the
round trip is exact.

File layout::

    b"D4DGRID1" | u64-le header_len | header json | blob_0 | blob_1 ...

Header: ``{"meta": {...}, "arrays": [{"name", "dtype", "shape",
"offset", "nbytes"}, ...]}``; offsets are relative to the end of the
header. Writes go to ``path + ".tmp"`` and then ``os.replace`` (atomic: a
crash leaves the previous state or the new one, never half a file).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

MAGIC = b"D4DGRID1"


def write_state(path: str, meta: dict, arrays: dict[str, np.ndarray]) -> None:
    entries = []
    blobs = []
    off = 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        entries.append({"name": name, "dtype": a.dtype.str, "shape": list(a.shape),
                        "offset": off, "nbytes": int(a.nbytes)})
        blobs.append(a)
        off += a.nbytes
    header = json.dumps({"meta": meta, "arrays": entries}).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for a in blobs:
            f.write(memoryview(a).cast("B"))  # one large write per array
    os.replace(tmp, path)
