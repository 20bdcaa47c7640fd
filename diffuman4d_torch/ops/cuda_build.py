"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>_<hash>.so`` at the repository
root (the hash covers the sources, the shared headers and the flags, so an
edited kernel is rebuilt) and loaded with ``ctypes``. Nothing is built at
import time: the first wrapper call builds what it needs, and
:func:`build` compiles several sources in parallel (one ``nvcc`` each).
Every C entry point returns a ``cudaError_t``. Builds and loads are the
``setup/kernels`` phase (``utils/tracing.py``), counted as
``kernels/compiled`` and ``kernels/loaded``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from diffuman4d_torch.utils.tracing import count, phase

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# library -> {C entry point: its argument types}: pointers and the stream
# as void*, sizes as int
ENTRIES = {
    "flash_attn_skew_hopper": {"flash_attn_fwd_skew": [_PTR] * 4 + [_INT] * 7 + [_PTR]},
    "flash_attn_d512": {"flash_attn_fwd_d512": [_PTR] * 4 + [_INT] * 4 + [_PTR]},
    "flash_attn_hopper": {
        "flash_attn_fwd_two_level": [_PTR] * 4 + [_INT] * 7 + [_PTR],
        "flash_attn_fwd_lse": [_PTR] * 5 + [_INT] * 4 + [_PTR],
        "flash_attn_hopper_probe": [_PTR] * 6,
    },
    "flash_attn_single_hopper": {"flash_attn_single_pass": [_PTR] * 4 + [_INT] * 6 + [_PTR]},
    "conv3x3_hopper": {"conv3x3_fwd": [_PTR] * 7 + [_INT] * 6 + [_PTR]},
    "flash_attn_bwd": {
        "flash_attn_bwd_fused": [_PTR] * 11 + [_INT] * 4 + [_PTR],
        "flash_attn_bwd_probe": [_PTR] * 6,
    },
    "groupnorm_hopper": {
        "groupnorm_stats": [_PTR] * 6 + [_INT] * 8 + [_PTR],
        "groupnorm_apply": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    },
    "layernorm_geglu_hopper": {
        "layernorm_fwd": [_PTR] * 4 + [_INT] * 4 + [_PTR],
        "geglu_fwd": [_PTR] * 2 + [_INT] * 3 + [_PTR],
    },
}
SOURCES = tuple(ENTRIES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
)

# compiler output (ptxas register / spill report) of this process's builds
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


@phase("setup/kernels", sync=False)
def build(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library of ``names``, all ``nvcc`` processes
    started together. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        count("kernels/compiled")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    path = build([name])[name]
    with phase("setup/kernels", sync=False):
        lib = ctypes.CDLL(str(path))
    count("kernels/loaded")
    return lib


@functools.cache
def entry(name: str, fn_name: str | None = None):
    """C entry point ``fn_name`` (default: the first listed) of kernel
    library ``name`` (built and loaded on first use), with its argument and
    return types set."""
    fn_name = fn_name or next(iter(ENTRIES[name]))
    fn = getattr(_library(name), fn_name)
    fn.argtypes, fn.restype = ENTRIES[name][fn_name], ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, key: tuple) -> None:
    """Add one launch to ``wrapper.launches`` and to ``wrapper.shapes[key]``.
    The sampler launches from its main and its saver thread, so the two
    read-modify-writes are taken under one lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        wrapper.shapes[key] += 1
