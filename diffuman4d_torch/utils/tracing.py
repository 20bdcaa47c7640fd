"""Tracing and timing (counterpart of ``diffuman4d_tpu/utils/tracing.py``):
phase timers and the torch profiler.

Usage::

    from diffuman4d_torch.utils.tracing import phase, report, trace_to

    with phase("task/sliding_denoise"):       # wall clock, device-synced
        ...
    print(report())

    with trace_to("results/trace_step"):      # Chrome trace of host and card
        ...

    RankedLogger(__name__).info("wave done")   # "[rank3] wave done"
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import os.path as osp
import threading
import time
from collections import defaultdict

import torch

log = logging.getLogger(__name__)

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
