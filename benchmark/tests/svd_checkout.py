"""A copy of the checkout's benchmark files with the ``svdxt-orbit-clip``
cell's mix cut to the tiny size, for the tests that run the cell on the
CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
CELL = "svdxt-orbit-clip"


def checkout(root: Path, tiny: bool = True) -> None:
    """The benchmark's files and ``BENCHMARK.json`` under ``root``; with
    ``tiny``, the cell's mix cut to a 5-camera ring (input camera 0, its 4
    others one clip, 3 Euler steps)."""
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(BENCH_DIR.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    if tiny:
        path = root / "benchmark" / "traffic" / "svd-orbit.json"
        mix = json.loads(path.read_text())
        mix["sampler"].update(window_size=4, sliding_stride=4, num_denoising_steps=3,
                              spa_label_range=[0, 5, 1])
        mix["scene"]["cams"] = 5
        path.write_text(json.dumps(mix))
