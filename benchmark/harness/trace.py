"""Reduce a ``torch.profiler`` record of the window to the numbers the
per-layer readers and the result's ``breakdown`` need, in memory (a window
holds some 10^5 device events; nothing of the timeline is written).

* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy, fill) ran on the card;
* ``attn_device_s``: the device time of the kernels launched while a
  ``bench/attention`` range was open on the launching thread (matched through
  the launch's correlation id), whatever kernels a later program launches
  there;
* ``device_by_op``: the same for each of the program's own ``op/<name>``
  ranges open in the window (``op/attention``, ``op/conv3x3``,
  ``op/groupnorm``), keyed by ``<name>``: the device seconds a kernel's
  roofline reads beside the least time that the family's work count gives
  under the same name. A kernel launched inside nested ranges counts in
  each. Ranges are those of the threads the profiler records ranges on;
* ``device_ops``: the ten operations that took most device time, by name;
* ``idle_gaps``: the ten longest idle gaps, each named by the innermost
  ``bench/*`` host range open at its midpoint.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ATTENTION_RANGE = "bench/attention"
WINDOW_RANGE = "bench/window"
OP_PREFIX = "op/"  # the program's ranges around its ops (``utils/tracing.ranged``)
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
            if name.startswith(("bench/", OP_PREFIX)):
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id(),
                               name))
        elif name in LAUNCHES:
            launches.append((e.start_ns(), e.start_thread_id(), e.correlation_id()))
    (t0_ns, t1_ns), = [(r[0], r[1]) for r in ranges if r[3] == WINDOW_RANGE]
    ops = [r for r in ranges if r[3].startswith(OP_PREFIX)]
    ranges = [r for r in ranges if r[3].startswith("bench/") and r[3] != WINDOW_RANGE]
    if not dev:
        return {"busy_s": 0.0, "window_s": (t1_ns - t0_ns) / 1e9, "attn_device_s": None,
                "device_by_op": {}, "device_ops": [], "idle_gaps": []}

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
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

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

    att = [r for r in ranges if r[3] == ATTENTION_RANGE]
    attn = _launched_in(att, launches, dev) if att else None
    by_op = defaultdict(list)
    for r in ops:
        by_op[r[3][len(OP_PREFIX):]].append(r)
    device_by_op = {name: _launched_in(rs, launches, dev) for name, rs in sorted(by_op.items())}
    return {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9, "attn_device_s": attn,
            "device_by_op": device_by_op,
            "device_ops": [[n, v / 1e9] for n, v in top_ops], "idle_gaps": named}


def _launched_in(ranges, launches, dev) -> float:
    """Device seconds of the kernels launched while one of ``ranges`` (host
    ranges (start, end, thread, name)) was open on the launching thread,
    matched through the launches' correlation ids."""
    by_thread = defaultdict(list)
    for lo, hi, tid, _ in ranges:
        by_thread[tid].append((lo, hi))
    corr = set()
    for tid, spans in by_thread.items():
        spans = np.array(_merged(spans), np.int64)
        mine = [(ts, cid) for ts, t, cid in launches if t == tid]
        if not mine:
            continue
        ts = np.array([m[0] for m in mine], np.int64)
        k = np.searchsorted(spans[:, 0], ts, side="right") - 1
        hit = (k >= 0) & (ts <= spans[np.maximum(k, 0), 1])
        corr.update(mine[i][1] for i in np.nonzero(hit)[0])
    return sum(d[1] for d in dev if d[2] in corr) / 1e9


def _merged(spans):
    """The union of (start, end) intervals, as sorted disjoint intervals: a
    range nested in another of its name lies inside the outer one."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out
