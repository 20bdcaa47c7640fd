"""Tracing and timing (counterpart of ``diffuman4d_tpu/utils/tracing.py``):
phase spans and counters, the torch profiler, and the one kernel timer of
the port's measurement tools with the card's peaks and name.

Usage::

    from diffuman4d_torch.utils.tracing import count, counters, phase, report

    with phase("task/sliding_denoise"):       # wall clock, device-synced
        ...
    with phase("task/save_wait", sync=False): # wall clock, no synchronise
        ...
    with phase("denoise/window_step", device=True):  # CUDA events, no wait
        ...
    count("sampler/latent_steps", 528)
    print(report())     # {name: {count, total_s, mean_s, max_s, p50_s, p90_s}}
    print(counters())   # {name: total}

    with trace_to("results/trace_step"):      # Chrome trace of host and card
        ...                                    # (every phase a range in it)

    RankedLogger(__name__).info("wave done")   # "[rank3] wave done"

    sec = timed(lambda: kernel(q, k, v), n=10)  # CUDA events, min of 3 windows
    rates(sec, flops=4 * b * h * s * s * d)    # {"ms", "tflops", "pct_of_bound", ...}

While a torch profiler records, every phase is also a ``record_function``
range of its name, and each call of a function decorated with
:func:`ranged` is a range alone, with no span. With no profiler recording,
neither opens one.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import os.path as osp
import subprocess
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger(__name__)

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

_TIMES: dict[str, list[float]] = defaultdict(list)
# device phases' (start, end) CUDA event pairs, resolved into _TIMES by report()
_EVENTS: dict[str, list[tuple]] = defaultdict(list)
_COUNTS: dict[str, int] = defaultdict(int)
_LOCK = threading.Lock()  # phases are also timed on the sampler's IO threads
_NO_RANGE = contextlib.nullcontext()


def _range(name: str):
    """A ``record_function`` range ``name`` while a torch profiler records,
    from any thread; else a no-op context.
    The check is the profiler's own module flag, a global: the C++ state
    behind ``torch._C._autograd._profiler_enabled`` is per thread, false on
    the sampler's threads and, with ``profile_all_threads``, everywhere."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    return _autograd_profiler.record_function(name)


def ranged(name: str):
    """Decorate a function so that each call is a profiler range ``name``
    while a profiler records (no span: the call is not timed)."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _range(name):
                return fn(*args, **kwargs)
        return call
    return deco


@contextlib.contextmanager
def phase(name: str, sync: bool = True, device: bool = False):
    """Time a phase. With ``sync`` and work on the card (CUDA initialised)
    the card is synchronised at exit, so the time includes the phase's queued
    device work; a phase on a helper thread passes ``sync=False`` and ends
    with its own blocking copy instead (a synchronise would wait for the main
    thread's work too). ``device=True`` times the block on the card instead:
    a CUDA event pair on the current stream, recorded without a wait and
    resolved by :func:`report` (``sync`` is then unused); with CUDA not
    initialised it falls back to the host clock."""
    events = None
    if device and torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with _range(name):
        if events is not None:
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events is not None:
                events[1].record()
                with _LOCK:
                    _EVENTS[name].append(events)
            else:
                if sync and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                with _LOCK:
                    _TIMES[name].append(dt)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (kept apart from the phases:
    :func:`counters`)."""
    with _LOCK:
        _COUNTS[name] += n


def counters(reset: bool = False) -> dict[str, int]:
    with _LOCK:
        out = dict(_COUNTS)
        if reset:
            _COUNTS.clear()
    return out


def _quantile(s: list[float], q: float) -> float:
    """The ``q`` quantile of sorted ``s``, interpolated linearly (numpy's
    default)."""
    x = q * (len(s) - 1)
    i = int(x)
    return s[i] + (s[min(i + 1, len(s) - 1)] - s[i]) * (x - i)


def _resolve_events() -> None:
    """Move the device phases' event pairs into their times: each end event
    waited for (the card's work up to it), then the pair's elapsed time."""
    with _LOCK:
        pending = {name: pairs for name, pairs in _EVENTS.items() if pairs}
        _EVENTS.clear()
    done = {}
    for name, pairs in pending.items():
        done[name] = []
        for start, end in pairs:
            end.synchronize()
            done[name].append(start.elapsed_time(end) / 1e3)
    with _LOCK:
        for name, vals in done.items():
            _TIMES[name].extend(vals)


def report(reset: bool = False) -> dict[str, dict]:
    """Every phase's count, total, mean, max and its median and 90th
    percentile, in seconds; the device phases resolved first."""
    _resolve_events()
    out = {}
    with _LOCK:
        for name, vals in _TIMES.items():
            s = sorted(vals)
            out[name] = {
                "count": len(vals),
                "total_s": round(sum(vals), 4),
                "mean_s": round(sum(vals) / len(vals), 4),
                "max_s": round(s[-1], 4),
                "p50_s": round(_quantile(s, 0.5), 4),
                "p90_s": round(_quantile(s, 0.9), 4),
            }
        if reset:
            _TIMES.clear()
            _EVENTS.clear()
    return out


def dump_report(path: str) -> None:
    with open(path, "w") as f:
        json.dump(report(), f, indent=2)


def dump_counters(path: str) -> None:
    with open(path, "w") as f:
        json.dump(counters(), f, indent=2, sort_keys=True)


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
