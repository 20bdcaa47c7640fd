"""Tracing and timing (counterpart of ``diffuman4d_tpu/utils/tracing.py``):
phase timers, the torch profiler, and the one kernel timer of the port's
measurement tools with the card's peaks and name.

Usage::

    from diffuman4d_torch.utils.tracing import phase, report, trace_to

    with phase("task/sliding_denoise"):       # wall clock, device-synced
        ...
    print(report())

    with trace_to("results/trace_step"):      # Chrome trace of host and card
        ...

    RankedLogger(__name__).info("wave done")   # "[rank3] wave done"

    sec = timed(lambda: kernel(q, k, v), n=10)  # CUDA events, min of 3 windows
    rates(sec, flops=4 * b * h * s * s * d)    # {"ms", "tflops", "pct_of_bound", ...}
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import os.path as osp
import subprocess
import threading
import time
from collections import defaultdict

import torch

log = logging.getLogger(__name__)

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_TIMES: dict[str, list[float]] = defaultdict(list)
_LOCK = threading.Lock()  # phases are also timed on the sampler's IO threads


@contextlib.contextmanager
def phase(name: str, sync: bool = True):
    """Time a phase. With ``sync`` and work on the card (CUDA initialised)
    the card is synchronised at exit, so the time includes the phase's queued
    device work; a phase on a helper thread passes ``sync=False`` and ends
    with its own blocking copy instead (a synchronise would wait for the main
    thread's work too)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with _LOCK:
            _TIMES[name].append(dt)


def report(reset: bool = False) -> dict[str, dict]:
    out = {}
    with _LOCK:
        for name, vals in _TIMES.items():
            out[name] = {
                "count": len(vals),
                "total_s": round(sum(vals), 4),
                "mean_s": round(sum(vals) / len(vals), 4),
                "max_s": round(max(vals), 4),
            }
        if reset:
            _TIMES.clear()
    return out


def dump_report(path: str) -> None:
    with open(path, "w") as f:
        json.dump(report(), f, indent=2)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block with ``torch.profiler`` (host, and the card when
    CUDA is available), yield the profiler for its ``key_averages()``, and
    write ``log_dir/trace.json.gz``, a gzipped Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir, "trace.json.gz")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)



class RankedLogger(logging.LoggerAdapter):
    """Rank-prefixed logger (the JAX module's, with the rank from
    ``torch.distributed`` when a process group is up, else 0);
    ``rank_zero_only`` drops the records of every other rank."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = False):
        super().__init__(logging.getLogger(name), {})
        self.rank_zero_only = rank_zero_only

    def log(self, level, msg, *args, **kwargs):
        if not self.isEnabledFor(level):
            return
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        if self.rank_zero_only and rank != 0:
            return
        super().log(level, f"[rank{rank}] {msg}", *args, **kwargs)


def timed(fn, n: int = 10, warmup: int = 1, windows: int = 3) -> float:
    """Seconds per call of ``fn()``: ``warmup`` calls, then ``windows``
    windows of ``n`` calls each, the fastest window. On the card each
    window is timed by CUDA events around its launches; where no card was
    initialised (the tools' ``--device cpu``), by the host clock."""
    for _ in range(warmup):
        fn()
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(windows):
        if cuda:
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) / n)
    return best


def rates(seconds: float, flops: float = 0.0, nbytes: float = 0.0) -> dict:
    """A time in ms with its TFLOP/s and GB/s, and its share of the card's
    bound for the work: the larger of ``flops`` at the bf16 peak and
    ``nbytes`` at the HBM rate (each input read once, each output written
    once), over the time."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    out = {"ms": seconds * 1e3}
    if flops:
        out["tflops"] = flops / seconds / 1e12
    if nbytes:
        out["gbps"] = nbytes / seconds / 1e9
    if flops or nbytes:
        out["bound_ms"] = max(t_ops, t_bytes) * 1e3
        out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        out["pct_of_bound"] = 100.0 * max(t_ops, t_bytes) / seconds
    return out


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them; on the
    CPU, ``{"name": "cpu"}``."""
    if not torch.cuda.is_available():
        return {"name": "cpu", "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        name, limit = (x.strip() for x in line.rsplit(",", 1))
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(0), "not read"
    return {"name": name, "power_limit": limit}
