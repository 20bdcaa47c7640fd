"""The port's schedule tools against the JAX package on the CPU:
``show_schedule``'s stdout byte-equal to ``scripts/show_schedule.py`` for
every sampler preset, ``probe_temporal_mem``'s schedule lines equal to the
JAX pipeline's ``_window_chunk_size`` / ``_chunk_pad_u``
(``diffuman4d_tpu/sampling/pipeline.py:756``, ``:787``) on the production
preset, and every tool of the port refusing to run without a card unless
given ``--device cpu``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- autouse fixture

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ["sliding_default", "sliding_fast", "sliding_3d", "sliding_premium",
           "sliding_low_mem"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grid", [(48, 150, 4), (16, 12, 4)])
@pytest.mark.parametrize("preset", PRESETS)
def test_show_schedule_prints_the_scripts_bytes(preset, grid, capsys, monkeypatch):
    from diffuman4d_torch import show_schedule

    cams, frames, inputs = map(str, grid)
    argv = [preset, "--cams", cams, "--frames", frames, "--inputs", inputs]
    monkeypatch.setattr(sys, "argv", ["show_schedule.py", *argv])
    _jax_script("show_schedule").main()
    want = capsys.readouterr().out
    assert show_schedule.main([*argv, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.startswith(f"preset {preset}:")


@pytest.mark.parametrize("window_chunk", [8, 5, 3, 1])
def test_probe_schedule_lines_match_the_jax_pipeline(window_chunk):
    from diffuman4d_tpu.sampling.pipeline import Diffuman4DPipeline as J
    from diffuman4d_tpu.sampling.windows import build_windows
    from diffuman4d_torch.probe_temporal_mem import schedule

    jself = SimpleNamespace(window_chunk=window_chunk)
    inputs = np.array([1, 13, 25, 37])
    for domain, n, windows in (
            ("temporal", 300, build_windows(np.arange(150, 300), np.arange(150), "temporal",
                                            12, 2)),
            ("spatial", 48, build_windows(np.setdiff1d(np.arange(48), inputs), inputs,
                                          "spatial", 12, 2))):
        c = J._window_chunk_size(jself, windows.shape[0])
        assert schedule(domain, window_chunk) == {
            "domain": domain, "rows": n, "windows": int(windows.shape[0]), "chunk": c,
            "pad_u": int(J._chunk_pad_u(jself, windows, c))}


def test_probe_runs_both_programs_on_the_cpu(capsys):
    """At the tiny model on the production 48 x 150 shapes: the schedule
    line, then each program once (no memory figures without a card)."""
    from diffuman4d_torch import probe_temporal_mem

    assert probe_temporal_mem.main(["--device", "cpu", "--arch", "tiny",
                                    "--split", "temporal"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    programs = [x["program"] for x in lines if "program" in x]
    assert programs == ["temporal/chunk_cond(c=5,pad_u=40)", "temporal/sliding_chunk(c=5)",
                        "spatial/chunk_cond(c=2,pad_u=18)", "spatial/sliding_chunk(c=2)"]
    assert all(x["peak_above_gb"] is None for x in lines if "program" in x)
    assert [x["chunk"] for x in lines if "chunk" in x] == [5, 2]


TOOLS = [("profile_units", []), ("profile_unet_units", []), ("profile_vae", []),
         ("profile_vae_conv", []), ("profile_window", []), ("attn_ceiling", []),
         ("bench_flash_backward", []), ("show_schedule", []), ("probe_temporal_mem", []),
         ("temporal_wave_proof", []), ("demo4d_slice", []), ("demo4d_chain", ["--", "--arch",
                                                                              "tiny"]),
         ("demo4d_report", [])]


@pytest.mark.parametrize("name,argv", TOOLS)
def test_every_tool_refuses_to_run_without_a_card(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"diffuman4d_torch.{name}")
    assert tool.main(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err
