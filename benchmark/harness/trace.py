"""Reduce a ``torch.profiler`` record of the window to the numbers the
per-layer readers and the result's ``breakdown`` need, in memory (a window
holds some 10^5 device events; nothing of the timeline is written).

* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy, fill) ran on the card;
* ``attn_device_s``: the device time of the kernels launched while a
  ``bench/attention`` range was open on the launching thread (matched through
  the launch's correlation id), whatever kernels a later program launches
  there;
* ``device_ops``: the ten operations that took most device time, by name;
* ``idle_gaps``: the ten longest idle gaps, each named by the innermost
  ``bench/*`` host range open at its midpoint.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ATTENTION_RANGE = "bench/attention"
WINDOW_RANGE = "bench/window"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")


def reduce_events(events, top: int = 10) -> dict:
    """The window is the ``bench/window`` host range: the profiler's own
    clock bounds it."""
    dev, ranges, launches = [], [], []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.duration_ns(), e.correlation_id(), name))
        elif e.is_user_annotation():
            if name.startswith("bench/"):
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
                               name))
        elif name in LAUNCHES:
            launches.append((e.start_ns(), e.start_thread_id(), e.correlation_id()))
    (t0_ns, t1_ns), = [(r[0], r[1]) for r in ranges if r[3] == WINDOW_RANGE]
    ranges = [r for r in ranges if r[3] != WINDOW_RANGE]
    if not dev:
        return {"busy_s": 0.0, "window_s": (t1_ns - t0_ns) / 1e9, "attn_device_s": None,
                "device_ops": [], "idle_gaps": []}

    start = np.array([d[0] for d in dev], np.int64)
    end = start + np.array([d[1] for d in dev], np.int64)
    start, end = np.clip(start, t0_ns, t1_ns), np.clip(end, t0_ns, t1_ns)
    order = np.argsort(start)
    start, end = start[order], end[order]
    reach = np.maximum.accumulate(end)
    # a gap opens where an operation starts after everything before it ended
    gap_lo = np.concatenate([[t0_ns], reach[:-1]])
    gap_len = np.maximum(start - gap_lo, 0)
    tail = max(t1_ns - int(reach[-1]), 0)
    idle_ns = int(gap_len.sum()) + tail
    busy_ns = (t1_ns - t0_ns) - idle_ns

    by_name = defaultdict(int)
    for _, dur, _, name in dev:
        by_name[name] += dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps = [(int(gap_lo[i]), int(gap_len[i])) for i in np.argsort(-gap_len)[:top]
            if gap_len[i] > 0]
    if tail:
        gaps.append((int(reach[-1]), tail))
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    named = []
    for lo, length in gaps:
        mid = lo + length // 2
        inside = [r for r in ranges if r[0] <= mid <= r[1]]
        label = min(inside, key=lambda r: r[1] - r[0])[3] if inside else "outside bench ranges"
        named.append([label, length / 1e9])

    attn = None
    att = [r for r in ranges if r[3] == ATTENTION_RANGE]
    if att:
        by_thread = defaultdict(list)
        for lo, hi, tid, _ in att:
            by_thread[tid].append((lo, hi))
        corr = set()
        for tid, spans in by_thread.items():
            spans = np.array(sorted(spans), np.int64)
            mine = [(ts, cid) for ts, t, cid in launches if t == tid]
            if not mine:
                continue
            ts = np.array([m[0] for m in mine], np.int64)
            k = np.searchsorted(spans[:, 0], ts, side="right") - 1
            hit = (k >= 0) & (ts <= spans[np.maximum(k, 0), 1])
            corr.update(mine[i][1] for i in np.nonzero(hit)[0])
        attn = sum(d[1] for d in dev if d[2] in corr) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9, "attn_device_s": attn,
            "device_ops": [[n, v / 1e9] for n, v in ops], "idle_gaps": named}
