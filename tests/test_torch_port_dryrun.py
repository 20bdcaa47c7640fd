"""The port's multi-rank dry run (``python -m diffuman4d_torch.dryrun_multichip``,
the counterpart of ``__graft_entry__.dryrun_multichip``) on four gloo CPU
ranks: a 2 x 2 mesh, waves of two tasks each denoised context-parallel over
two ranks, the grid validated on every rank; then one data- and
tensor-parallel train step on the same mesh, with a finite loss."""

from __future__ import annotations

import math
import re

from diffuman4d_torch import dryrun_multichip

TRAIN_LINE = re.compile(r"dryrun_multichip OK: mesh=\((\d+)x(\d+)\) loss=(\S+) grad_norm=(\S+)")


def _train_line(line: str) -> tuple:
    m = TRAIN_LINE.fullmatch(line)
    assert m, line
    assert math.isfinite(float(m.group(3))) and math.isfinite(float(m.group(4)))
    return int(m.group(1)), int(m.group(2))


def test_dryrun_multichip_on_four_ranks(capsys):
    assert dryrun_multichip.main(["4"]) == 0
    inference, train = capsys.readouterr().out.strip().splitlines()
    assert inference == (
        "dryrun inference waves OK: mesh=(2x2) full-topology UNet (4-stage, CP active), "
        "grid validated")
    assert _train_line(train) == (2, 2)


def test_dryrun_multichip_on_two_ranks_runs_waves_alone():
    inference, train = dryrun_multichip.dryrun_multichip(2, timeout_s=120.0)
    assert inference == (
        "dryrun inference waves OK: mesh=(2x1) full-topology UNet (4-stage, CP off), "
        "grid validated")
    assert _train_line(train) == (2, 1)
