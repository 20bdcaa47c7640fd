"""The port's multi-rank dry run (``python -m diffuman4d_torch.dryrun_multichip``,
the counterpart of ``__graft_entry__._dryrun_inference_waves``) on four gloo
CPU ranks: a 2 x 2 mesh, waves of two tasks each denoised context-parallel
over two ranks, the grid validated on every rank."""

from __future__ import annotations

from diffuman4d_torch import dryrun_multichip


def test_dryrun_multichip_on_four_ranks(capsys):
    assert dryrun_multichip.main(["4"]) == 0
    assert capsys.readouterr().out.strip() == (
        "dryrun inference waves OK: mesh=(2x2) full-topology UNet (4-stage, CP active), "
        "grid validated")


def test_dryrun_multichip_on_two_ranks_runs_waves_alone():
    assert dryrun_multichip.dryrun_multichip(2, timeout_s=120.0) == (
        "dryrun inference waves OK: mesh=(2x1) full-topology UNet (4-stage, CP off), "
        "grid validated")
