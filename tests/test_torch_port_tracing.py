"""The port's ``utils/tracing.py`` on the CPU: phase timers, the report
that ``phases.json`` holds, and ``trace_to``'s gzipped Chrome trace."""

import gzip
import json

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
