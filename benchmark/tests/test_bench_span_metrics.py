"""The readers of the program's spans inside the sampler and the pipeline
(``save_wait_pct``, ``conditions_ms``, ``window_step_p50_ms``): their
arithmetic, nothing read from a program without the spans, and a traced
run on the CPU that reports all three."""

import pytest

from benchmark.harness import spec as sp

NEW = ("save_wait_pct", "conditions_ms", "window_step_p50_ms")


def _span(total, count=1, p50=None):
    out = {"count": count, "total_s": total, "mean_s": total / count, "max_s": total}
    if p50 is not None:
        out.update(p50_s=p50, p90_s=p50)
    return out


def test_readers_arithmetic():
    rec = {"window_s": 50.0, "tasks": 2, "spans": {
        "task/save_wait": _span(5.0),
        "task/prepare_conditions": _span(3.0, 2),
        "cond/upload": _span(1.0, 4),
        "cond/chunk": _span(0.5, 4),
        "denoise/window_step": _span(40.0, 24, p50=1.6725),
    }}
    assert sp.metric_reader("save_wait_pct")(rec) == pytest.approx(10.0)
    assert sp.metric_reader("conditions_ms")(rec) == pytest.approx(1750.0)
    assert sp.metric_reader("window_step_p50_ms")(rec) == pytest.approx(1672.5)
    del rec["spans"]["cond/chunk"]  # a task whose pose features are not streamed
    assert sp.metric_reader("conditions_ms")(rec) == pytest.approx(1500.0)


def test_readers_read_nothing_without_the_spans():
    """The spans a program before them had: the readers stay silent, as
    they do on the parent of the change that brought them."""
    rec = {"window_s": 50.0, "tasks": 1, "spans": {
        "task/prepare_conditions": _span(0.5), "task/sliding_denoise": _span(43.0),
        "task/decode_save": _span(6.0)}}
    assert all(sp.metric_reader(m)(rec) is None for m in NEW)


def test_traced_run_reports_the_span_metrics(tiny_run):
    res = tiny_run("pose-demo3d", trace=True)["result"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert 0 < m["save_wait_pct"] <= m["outside_denoise_pct"]
    assert m["conditions_ms"] > 0
    assert 0 < m["window_step_p50_ms"] <= 1.1 * m["window_step_ms"]
