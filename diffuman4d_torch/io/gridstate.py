"""Raw-container grid-state files for sampling checkpoints (the port's own
copy of ``diffuman4d_tpu/io/gridstate.py``, numpy only).

One file holds the sampler's latent grid, its timestep-index grid and a
small JSON ``meta``: a JSON header and raw array blobs, written with one
large write per array. bf16 grids are stored as their uint16 bit patterns
(the caller bitcasts), so a file is half the size of an fp32 cast and the
round trip is exact. For the same meta and arrays the file is byte-equal to
the JAX package's, and each package reads the other's.

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


def read_state(path: str, mmap: bool = True) -> tuple[dict, dict[str, np.ndarray]]:
    """Returns (meta, {name: array}). Arrays are read-only memmap views by
    default (no host copy until the caller makes one)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a D4DGRID1 state file")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = f.tell()
    out = {}
    for e in header["arrays"]:
        dtype, shape = np.dtype(e["dtype"]), tuple(e["shape"])
        if mmap:
            a = np.memmap(path, dtype=dtype, mode="r", offset=base + e["offset"], shape=shape)
        else:
            with open(path, "rb") as f:
                f.seek(base + e["offset"])
                a = np.fromfile(f, dtype=dtype,
                                count=int(np.prod(shape)) if shape else 1).reshape(shape)
        out[e["name"]] = a
    return header["meta"], out
