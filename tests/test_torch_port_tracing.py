"""The port's ``utils/tracing.py`` on the CPU: phase timers, the report
that ``phases.json`` holds, ``trace_to``'s gzipped Chrome trace, and the
phases' modes (percentiles, device timing, profiler ranges) and counters."""

import gzip
import json

import pytest
import torch

from diffuman4d_torch.utils.tracing import dump_report, phase, report, trace_to


def test_phase_report_and_dump(tmp_path):
    report(reset=True)
    for _ in range(2):
        with phase("test/work"):
            torch.ones(8).sum()
    rep = report()
    assert rep["test/work"]["count"] == 2
    assert 0 <= rep["test/work"]["max_s"] <= rep["test/work"]["total_s"]
    dump_report(str(tmp_path / "phases.json"))
    assert json.loads((tmp_path / "phases.json").read_text()) == rep
    assert report(reset=True) == rep and report() == {}


def test_trace_to_writes_chrome_trace(tmp_path):
    a = torch.randn(32, 32)
    with trace_to(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    assert any("mm" in evt.key for evt in prof.key_averages())
    with gzip.open(tmp_path / "trace" / "trace.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in evt.get("name", "") for evt in events)


class _Clock:
    """``time.perf_counter`` stand-in: each call one tick of ``dt``, so a
    phase (a read at entry, one at exit) lasts ``dt``."""

    def __init__(self):
        self.now, self.dt = 0.0, 0.0

    def perf_counter(self):
        self.now += self.dt
        return self.now


def _case_percentiles(monkeypatch):
    """``p50_s`` / ``p90_s`` beside the old keys, numpy's linear quantiles."""
    import numpy as np

    from diffuman4d_torch.utils import tracing

    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    durations = [0.25, 1.0, 4.0, 2.0, 0.5, 8.0, 3.0]
    for d in durations:
        clock.dt = d
        with phase("test/pct", sync=False):
            pass
    rep = report()["test/pct"]
    assert list(rep) == ["count", "total_s", "mean_s", "max_s", "p50_s", "p90_s"]
    assert rep["count"] == len(durations) and rep["max_s"] == 8.0
    assert rep["total_s"] == sum(durations)
    assert rep["p50_s"] == round(float(np.percentile(durations, 50)), 4) == 2.0
    assert rep["p90_s"] == round(float(np.percentile(durations, 90)), 4) == 5.6
    with phase("test/one", sync=False):
        pass
    assert report()["test/one"]["p50_s"] == report()["test/one"]["p90_s"] == clock.dt


def _case_counters(monkeypatch):
    """``count`` adds under the phases' lock, from several threads;
    ``counters(reset=True)`` returns the totals and clears them; the
    phases' report holds no counter."""
    import threading

    from diffuman4d_torch.utils.tracing import count, counters

    def add():
        for _ in range(500):
            count("test/hits")
            count("test/rows", 3)

    workers = [threading.Thread(target=add) for _ in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    assert counters() == {"test/hits": 2000, "test/rows": 6000}
    assert report() == {}
    assert counters(reset=True) == {"test/hits": 2000, "test/rows": 6000}
    assert counters() == {}


def _case_profiler_ranges(monkeypatch):
    """Under a CPU profiler every phase is a range of its name, as long as
    the span to within 1 ms."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from diffuman4d_torch.utils import tracing

    @tracing.ranged("test/op")
    def op(x):
        return x * 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phase("test/warm", sync=False):  # the profiler's first range costs ~1 ms
            pass
        report(reset=True)
        for i in range(3):
            with phase("test/outer", sync=False):
                with phase("test/inner", device=True):
                    time.sleep(0.004 * (i + 1))
                op(torch.ones(4))
    spans = {name: list(tracing._TIMES[name]) for name in ("test/outer", "test/inner")}
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name().startswith("test/"):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.duration_ns() / 1e9))
    assert len(ranges["test/op"]) == 3
    assert "test/op" not in report()  # a range alone, not a span
    for name, durations in spans.items():
        got = [d for _, d in sorted(ranges[name])]
        assert len(got) == len(durations) == 3
        assert all(abs(g - d) < 1e-3 for g, d in zip(got, durations)), (got, durations)


def _case_no_profiler_no_range(monkeypatch):
    """With no profiler recording, no phase and no ranged call enters a
    ``record_function``; under one, each enters its range."""
    from torch.profiler import ProfilerActivity, profile

    from diffuman4d_torch.utils import tracing

    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing._autograd_profiler, "record_function", Counting)
    op = tracing.ranged("test/op")(lambda x: x + 1)

    def work():
        with phase("test/task", sync=False):
            with phase("test/step", device=True):
                op(1)

    work()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    assert entered == ["test/task", "test/step", "test/op"]


def _case_device_on_cpu(monkeypatch):
    """``device=True`` without CUDA: the host clock, no event pair, no
    synchronise."""
    from diffuman4d_torch.utils import tracing

    def no_sync():
        raise AssertionError("a device phase synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    clock.dt = 0.25
    with phase("test/dev", device=True):
        pass
    assert not torch.cuda.is_initialized() and not tracing._EVENTS
    assert report()["test/dev"]["total_s"] == 0.25


CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_percentiles, _case_counters, _case_profiler_ranges, _case_no_profiler_no_range,
    _case_device_on_cpu)}


@pytest.mark.parametrize("case", list(CASES))
def test_phase_modes_and_counters(case, monkeypatch):
    from diffuman4d_torch.utils.tracing import counters

    report(reset=True)
    counters(reset=True)
    try:
        CASES[case](monkeypatch)
    finally:
        report(reset=True)
        counters(reset=True)
