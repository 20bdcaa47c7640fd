"""``python -m diffuman4d_torch.bench`` on the CPU at the tiny shape: both
tiers' lines with ``bench.py``'s keys, the smoke mode, and the failure
paths (an error before any tier, an error after the smoke tier, the
watchdog's timeout), each of which exits non-zero without a number for a
tier that did not run."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the keys of bench.py's two lines (bench.py:140-148, :291-305)
SMOKE_KEYS = {"metric", "value", "unit", "vs_baseline"}
FULL_KEYS = {"metric", "value", "unit", "vs_baseline", "cold", "warm"}
KERNELS = {"B1", "B2", "B3", "B4", "B8", "B9", "B10"}
# the wrappers whose launched shapes the bench writes to shapes.json
WRAPPERS = {"flash_d64", "flash_d512", "single_pass", "single_pass_batched", "two_level",
            "conv3x3"}


def _bench(tmp_path, *args, timeout=240, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    e.update(PYTHONPATH=str(ROOT) + os.pathsep + e.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
             BENCH_SCENE_DIR=str(tmp_path / "bench"), **env)
    proc = subprocess.run([sys.executable, "-m", "diffuman4d_torch.bench", *args], cwd=ROOT,
                          env=e, capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    return proc, lines


def test_bench_prints_both_tiers(tmp_path):
    proc, lines = _bench(tmp_path, "--device", "cpu", "--arch", "tiny")
    assert proc.returncode == 0, proc.stderr[-3000:]
    smoke, full = lines
    assert smoke["metric"] == "smoke_window_step_sec" and SMOKE_KEYS <= set(smoke)
    assert full["metric"] == "cam_frames_per_sec_per_chip" and FULL_KEYS <= set(full)
    for line in lines:
        assert line["value"] > 0 and line["vs_baseline"] > 0 and line["device"] == "cpu"
        assert line["unit"].startswith("CPU run, not a card measurement")
        # the plain versions ran: no kernel launches on the CPU
        assert line["launches"] == dict.fromkeys(KERNELS, 0)
    assert full["value"] == full["cold"] and full["warm"] > 0
    for tag in ("warmup", "warm", "cold"):
        assert f"[bench] {tag}: task" in proc.stderr
    assert json.loads((tmp_path / "bench" / "partial.json").read_text())["metric"] == (
        "cam_frames_per_sec_per_chip")  # the warm line, written before the cold run
    shapes = json.loads((tmp_path / "bench" / "shapes.json").read_text())
    assert shapes == {tier: dict.fromkeys(WRAPPERS, []) for tier in ("smoke", "full")}


def test_bench_launch_records_by_tpu_kernel_and_shape():
    """A tier's launches by TPU kernel (the d = 64 kernel's batch <= 2 as
    B1, the rest as B2) and its launched shapes with their counts, from the
    wrappers' records since the tier began."""
    from diffuman4d_torch import bench
    from diffuman4d_torch.ops import conv, flash_attention as fa

    saved = {name: fn.shapes for name, fn in bench._wrappers().items()}
    try:
        fa.flash_attention_d64.shapes = Counter({(2, 4096, 4096, 20, 128, 256, 128): 3})
        before = bench.launch_records()
        fa.flash_attention_d64.shapes.update({(2, 4096, 4096, 20, 128, 256, 128): 2,
                                              (48, 1024, 1024, 20, 192, 256, 64): 5})
        fa.flash_attention_single_pass_batched.shapes.update({(48, 256, 256, 20, 128, 5): 1})
        conv.conv3x3.shapes.update({(48, 128, 128, 640, 640, False, False, False): 4})
        assert bench.launches_since(before) == {"B1": 2, "B2": 5, "B8": 0, "B9": 1, "B10": 0,
                                                "B3": 0, "B4": 4}
        got = bench.shapes_since(before)
        assert got["flash_d64"] == [[2, 4096, 4096, 20, 128, 256, 128, 2],
                                    [48, 1024, 1024, 20, 192, 256, 64, 5]]
        assert got["single_pass_batched"] == [[48, 256, 256, 20, 128, 5, 1]]
        assert got["conv3x3"] == [[48, 128, 128, 640, 640, False, False, False, 4]]
        assert got["single_pass"] == got["two_level"] == got["flash_d512"] == []
    finally:
        for name, fn in bench._wrappers().items():
            fn.shapes = saved[name]


def test_bench_smoke_mode_runs_the_smoke_tier_only(tmp_path):
    proc, lines = _bench(tmp_path, "--device", "cpu", "--arch", "tiny",
                         BENCH_MODE="smoke")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [x["metric"] for x in lines] == ["smoke_window_step_sec"]
    assert not (tmp_path / "bench" / "scene").exists()


def test_bench_without_a_card_fails_with_a_failure_line(tmp_path):
    """The default device is the card: no fallback to the CPU."""
    proc, lines = _bench(tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert lines == [{"metric": "cam_frames_per_sec_per_chip", "value": None,
                      "unit": lines[-1]["unit"], "vs_baseline": None}]
    assert lines[-1]["unit"].startswith("FAILED before any tier: RuntimeError: no CUDA device")


def test_bench_error_after_the_smoke_tier_exits_nonzero(tmp_path):
    """A file where the scene directory should be: the full tier raises;
    the last line is the smoke tier's again, and no throughput is printed."""
    (tmp_path / "bench").mkdir()
    (tmp_path / "bench" / "scene").write_text("not a directory")
    proc, lines = _bench(tmp_path, "--device", "cpu", "--arch", "tiny")
    assert proc.returncode != 0
    assert [x["metric"] for x in lines] == ["smoke_window_step_sec"] * 2
    assert lines[0] == lines[1]


def test_bench_watchdog_kills_a_run_past_its_time(tmp_path):
    proc, lines = _bench(tmp_path, "--device", "cpu", "--arch", "tiny",
                         BENCH_TIMEOUT_S="1")
    assert proc.returncode == -signal.SIGKILL
    last = lines[-1]
    if last["metric"] == "cam_frames_per_sec_per_chip":  # no tier had finished
        assert last["value"] is None and last["unit"].startswith("TIMEOUT")
    else:  # the smoke tier finished and is printed again
        assert last == lines[0] and last["value"] > 0
