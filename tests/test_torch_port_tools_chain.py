"""The port's ``demo4d_chain`` and ``demo4d_slice`` on the CPU at the tiny
shape, on demo_4d's preset cut to 6 cameras x 4 frames (inputs 0 and 3,
window 2): two budgeted chain sessions, the second resuming the first, end
on the grid state of one uninterrupted session with their sum; the slice
runs its two tasks and resumes its state."""

from __future__ import annotations

import json
from pathlib import Path

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- autouse fixture
from tests.test_torch_port_tools_demo4d import GRID, TINY


def test_chain_sessions_resume_to_the_uninterrupted_grid(tmp_path, monkeypatch):
    """The sessions' processes and this one (the uninterrupted session) on
    one thread each: the same reduction order everywhere."""
    from diffuman4d_torch import demo4d_chain, demo4d_prefix

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    scene, chain_dir = tmp_path / "scene", tmp_path / "chain"
    prefix = [*TINY, "--scene", str(scene)]
    assert demo4d_chain.main(["--task-budget", "1", "--max-sessions", "2", "--out-dir",
                              str(chain_dir), "--", *prefix, "--out", str(tmp_path / "chained"),
                              *GRID]) == 0
    lines = [json.loads(x) for x in (chain_dir / "sessions.jsonl").read_text().splitlines()]
    assert [(r["session"], r["rc"], r["start_round"], r["start_tasks"], r["tasks"],
             r["complete"]) for r in lines] == [(1, 0, 0, 0, 1, False), (2, 0, 0, 1, 1, False)]
    assert (chain_dir / "session_02.log").is_file()
    assert demo4d_prefix.main(["--task-budget", "2", "--checkpoint-every", "8", *prefix,
                               "--out", str(tmp_path / "whole"), *GRID]) == 0
    state = Path("state") / "grid_state.d4d"
    assert (tmp_path / "chained" / state).read_bytes() == (tmp_path / "whole" / state).read_bytes()


def test_slice_runs_both_domains_and_resumes(tmp_path, capsys):
    from diffuman4d_torch import demo4d_slice

    assert demo4d_slice.main(["--device", "cpu", "--tiny", "--scene", str(tmp_path / "scene"),
                              "--out", str(tmp_path / "out"), *GRID]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["grid"][:2] == [6, 4] and rep["card"]["name"] == "cpu"
    assert [rep["tasks"][d]["rows"] for d in ("spatial", "temporal")] == [6, 8]
