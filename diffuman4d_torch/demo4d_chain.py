"""Chained demo_4d sessions (counterpart of ``scripts/demo4d_chain.sh``):
``python -m diffuman4d_torch.demo4d_prefix`` run again and again, each
session a fresh process that resumes from the newest grid state, until the
schedule is complete, the session cap is reached or the deadline has
passed.

    python -m diffuman4d_torch.demo4d_chain [--task-budget 24] [--max-sessions 40]
        [--deadline EPOCH] [--out-dir runs/demo4d_chain] [-- PREFIX ARGS ...]

Each session gets ``--task-budget`` tasks and a state every 8 tasks; with a
deadline (seconds since the epoch; 0: none) it also gets a time budget of
the seconds left less a 120 s margin, at least 300 s, so that the last
session stops cleanly with its state saved. A session that fails (an exit
code other than 0 and the timeout's 124) is retried once; a failed retry
ends the chain. Arguments after ``--`` go to every ``demo4d_prefix`` call
(``--device cpu --arch tiny --size 64``, a scene, an output directory,
config overrides). Each session's output goes to ``session_NN.log`` and one
line per session to ``sessions.jsonl`` in ``--out-dir``: its exit code, wall
seconds, tasks and their seconds, the round and task it resumed at, its
phases and whether the schedule is complete (``demo4d_report`` rolls them
up). The chain itself touches no card: each session does, unless it is
given ``--device cpu``."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SESSION_TIMEOUT_S = 21000  # a backstop only: budgets end the sessions
DEADLINE_MARGIN_S, MIN_TIME_BUDGET_S = 120, 300
CHECKPOINT_EVERY = 8


def session_record(i: int, rc: int, wall_s: float, log: str) -> dict:
    """The line of ``sessions.jsonl`` for one session, from the JSON line
    ``demo4d_prefix`` prints (the script's keys)."""
    rec = {"session": i, "rc": rc, "wall_s": wall_s}
    line = next((json.loads(x) for x in reversed(log.splitlines())
                 if x.startswith("{") and '"resumed_rounds"' in x), None)
    if line is not None:
        rec.update(start_round=line["resumed_rounds"], start_tasks=line["resumed_tasks"])
        if "tasks_run" in line:
            rec.update(tasks=line["tasks_run"], exec_s=line["run_s"])
        rec["phases"] = line.get("phases")
    rec["complete"] = bool(line and line.get("complete"))
    return rec


def prefix_session(argv: list[str], log_path: Path) -> int:
    """One ``demo4d_prefix`` process; its output into ``log_path``."""
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with open(log_path, "w") as log:
        try:
            return subprocess.run([sys.executable, "-m", "diffuman4d_torch.demo4d_prefix",
                                   *argv], cwd=ROOT, env=env, stdout=log,
                                  stderr=subprocess.STDOUT, timeout=SESSION_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            return 124


def run_chain(budget: int, max_sessions: int, deadline: float, out_dir: Path,
              prefix_args: list[str], session=prefix_session,
              checkpoint_every: int = CHECKPOINT_EVERY) -> list[dict]:
    """Run the sessions; ``session(argv, log_path) -> exit code`` runs one
    with ``demo4d_prefix``'s arguments ``argv`` (in a process of its own
    unless given another runner). Returns the records appended to
    ``sessions.jsonl``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(1, max_sessions + 1):
        now = time.time()
        if deadline > 0 and now >= deadline:
            print(f"[chain] deadline reached before session {i} -- stopping cleanly", flush=True)
            break
        log = out_dir / f"session_{i:02d}.log"
        print(f"[chain] session {i} starting (budget {budget}) at "
              f"{time.strftime('%H:%M:%S', time.gmtime())}", flush=True)
        argv = ["--task-budget", str(budget), "--checkpoint-every", str(checkpoint_every)]
        if deadline > 0:
            tb = max(int(deadline - now - DEADLINE_MARGIN_S), MIN_TIME_BUDGET_S)
            argv += ["--time-budget", str(tb)]
        argv += prefix_args
        t0 = time.time()
        rc = session(argv, log)
        text = log.read_text(errors="replace")
        for line in text.splitlines()[-4:]:
            print(f"[chain][s{i}] {line}", flush=True)
        rec = session_record(i, rc, round(time.time() - t0), text)
        with open(out_dir / "sessions.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
        if rec["complete"]:
            print(f"[chain] full schedule complete after session {i}", flush=True)
            break
        if rc not in (0, 124):
            print(f"[chain] session {i} failed rc={rc} -- retrying once", flush=True)
            retry = Path(f"{log}.retry")
            if session(argv, retry) != 0:
                print(f"[chain] retry failed too -- stopping; see {retry}", flush=True)
                break
    print(f"[chain] done at {time.strftime('%H:%M:%S', time.gmtime())}", flush=True)
    return records


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    prefix_args = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task-budget", type=int, default=24)
    ap.add_argument("--max-sessions", type=int, default=40)
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="seconds since the epoch; 0: no deadline")
    ap.add_argument("--out-dir", default=str(ROOT / "runs" / "demo4d_chain"))
    args = ap.parse_args(argv[: argv.index("--")] if "--" in argv else argv)
    on_cpu = "--device" in prefix_args and \
        prefix_args[prefix_args.index("--device") + 1:][:1] == ["cpu"]
    if not on_cpu:
        import torch

        if not torch.cuda.is_available():
            print("demo4d_chain: no CUDA device; pass -- --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    records = run_chain(args.task_budget, args.max_sessions, args.deadline, Path(args.out_dir),
                        prefix_args)
    return 0 if records and all(r["rc"] in (0, 124) for r in records[-1:]) else 1


if __name__ == "__main__":
    sys.exit(main())
