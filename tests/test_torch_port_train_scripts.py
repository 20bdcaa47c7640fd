"""The port's two training entry points on the CPU at the tiny shape:
``train_step_chip`` (its record, the counted FLOPs, the tier file, the two
refused options) and ``train_run_chip`` (two sessions that resume, then
``--report``, equal to ``scripts/train_run_chip.py``'s ``summarize`` of the
same directory). Without a card both refuse to run on the default device."""

from __future__ import annotations

import importlib.util
import json
import math
from collections import Counter
from pathlib import Path

import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- autouse fixture

ROOT = Path(__file__).resolve().parents[1]
# the JAX script's record keys (scripts/train_step_chip.py:224-236), with its
# compile time as the port's first step and its cost model as a FLOP count
STEP_KEYS = {"tier", "metric", "value", "unit", "params_b", "loss", "first_step_s",
             "hbm_used_gb", "hbm_peak_gb", "all_steps_s", "tflop_per_step", "mfu_vs_989tf_bf16",
             "device"}


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra,tier", [([], "adafactor_f6"),
                                        (["--optimizer", "adamw", "--ema", "host"],
                                         "adamw_emahost_f6")])
def test_train_step_chip_record(tmp_path, extra, tier):
    from diffuman4d_torch import train_step_chip

    out = tmp_path / "tiers.json"
    argv = ["--device", "cpu", "--arch", "tiny", "--frames", "6", "--steps", "2", "--out",
            str(out), *extra]
    rec = train_step_chip.main(argv)
    assert STEP_KEYS <= set(rec) and rec["tier"] == tier
    assert rec["metric"] == "train_step_sec" and rec["value"] == min(rec["all_steps_s"]) > 0
    assert len(rec["all_steps_s"]) == 2 and math.isfinite(rec["loss"])
    assert rec["tflop_per_step"] > 0 and rec["mfu_vs_989tf_bf16"] is None  # no card, no MFU
    assert rec["hbm_peak_gb"] is None and rec["device"] == "cpu"
    assert ("ema_fold_s" in rec) == ("host" in extra)
    # a second run of the tier replaces its record in the file
    train_step_chip.main(argv + ["--steps", "1"])
    tiers = json.loads(out.read_text())
    assert [t["tier"] for t in tiers] == [tier] and len(tiers[0]["all_steps_s"]) == 1


def test_kernel_flops_from_launch_records():
    from diffuman4d_torch.train_step_chip import kernel_flops

    fwd = 4.0 * 10 * 49152 * 49152 * 64  # B1 H10 S49,152 d64
    conv = 2.0 * 9 * 128 * 128 * 640 * 640  # B1 128^2 640 -> 640
    launched = {"flash_fwd_lse": Counter({(1, 49152, 49152, 10): 2}),
                "flash_bwd": Counter({(1, 49152, 49152, 10): 1}),
                "conv3x3": Counter({(1, 128, 128, 640, 640, False, False, False): 3})}
    assert kernel_flops(launched) == pytest.approx(2 * fwd + 2.5 * fwd + 3 * conv)
    assert kernel_flops({}) == 0.0


def test_counted_flops_under_remat_match_the_analytic_count():
    """The step's FLOP count: a remat MLP's forward, recomputed forward and
    backward (2 M K N per matmul, twice that backward), with no module
    tracked but "Global" (the tracker's hooks are what kept remat's
    activations)."""
    import torch
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from diffuman4d_torch.train_step_chip import counted_flops

    M, widths = 32, (48, 64, 16)
    mlp = torch.nn.Sequential(torch.nn.Linear(widths[0], widths[1]), torch.nn.SiLU(),
                              torch.nn.Linear(widths[1], widths[2]))
    x = torch.randn(M, widths[0], requires_grad=True)

    def step():  # the whole forward recomputed (no early stop before the last matmul)
        with set_checkpoint_early_stop(False):
            checkpoint(mlp, x, use_reentrant=False).square().sum().backward()

    fwd = sum(2 * M * k * n for k, n in zip(widths, widths[1:]))
    assert counted_flops(step) == fwd + fwd + 2 * fwd


@pytest.mark.parametrize("argv,what", [(["--attn", "bundled"], "bundled"),
                                       (["--pallas-conv"], "pallas-conv")])
def test_train_step_chip_refuses_the_jax_only_options(argv, what, capsys):
    from diffuman4d_torch import train_step_chip

    with pytest.raises(SystemExit) as e:
        train_step_chip.parse_args(argv)
    assert e.value.code == 2 and what in capsys.readouterr().err


def test_train_scripts_need_a_card_by_default(tmp_path):
    import torch

    from diffuman4d_torch import train_run_chip, train_step_chip

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step_chip.main(["--out", ""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_run_chip.main(["--out", str(tmp_path / "run"), "--scene", str(tmp_path / "s")])
    assert not (tmp_path / "run").exists()


def test_train_run_chip_resumes_and_reports(tmp_path):
    from diffuman4d_torch import train_run_chip

    common = ["--device", "cpu", "--arch", "tiny", "--size", "64", "--checkpoint-every", "2",
              "--out", str(tmp_path / "run"), "--scene", str(tmp_path / "scene")]
    first = train_run_chip.main(common + ["--steps", "4"])
    assert first["last_step"] == 4 and first["state_checkpoints"] == [
        "state_0000002.pt", "state_0000004.pt"]
    second = train_run_chip.main(common + ["--steps", "7"])
    # the second session resumed at step 4: logged steps 1, 4 (session 1) and 7
    assert (second["first_step"], second["last_step"], second["steps_logged"]) == (1, 7, 3)
    assert second["state_checkpoints"] == ["state_0000002.pt", "state_0000004.pt",
                                           "state_0000006.pt", "state_0000007.pt"]
    assert second["domains_logged"] == ["spatial", "temporal"]
    assert second["device"] == "cpu" and second["session_wall_s"] > 0
    report = train_run_chip.main(["--report", "--out", str(tmp_path / "run")])
    assert report == _jax_script("train_run_chip").summarize(str(tmp_path / "run"))
    recs = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 4, 7]
    assert all(math.isfinite(r["loss"]) for r in recs)
