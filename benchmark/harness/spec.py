"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of the
checkout, ``benchmark/workloads/<cell>.json`` (configuration, traffic mix,
chips, why, the limits of the output check), ``benchmark/configs/<config>.json``
(widths, scheduler, dtype, source, reduced, assumed),
``benchmark/traffic/<traffic>.json`` (the mix's parameters, read by the one
generator in ``harness/program.py``) and ``benchmark/metrics/<metric>.py``
(one reader per metric). A cell, configuration, mix or metric is added by
adding its file and its entry in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_KEYS = {"config", "traffic", "chips", "why", "limits"}
CONFIG_KEYS = {"name", "source", "unet", "vae", "scheduler", "guidance_scale", "dtype",
               "image_size", "reduced", "assumed"}
TRAFFIC_KEYS = {"exp", "sampler", "scene", "frames", "resume_round", "pose_cache_mb",
                "reduced", "why"}


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json
    workload: dict  # benchmark/workloads/<name>.json
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/traffic/<traffic>.json
    end_to_end: list[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: list[dict]


def _load_json(path: Path, keys: set[str]) -> dict:
    data = json.loads(path.read_text())
    extra = set(data) - keys
    if extra:
        raise ValueError(f"{path.name}: unknown keys {sorted(extra)}")
    return data


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files, checked against each other."""
    if not NAME.match(name):
        raise ValueError(f"bad cell name {name!r}")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    bdir = root / "benchmark"
    workload = _load_json(bdir / "workloads" / f"{name}.json", CELL_KEYS)
    for k in ("config", "traffic", "chips"):
        if workload[k] != entry[k]:
            raise ValueError(f"{name}: {k} is {workload[k]!r} in its file, {entry[k]!r} in "
                             f"BENCHMARK.json")
    config = _load_json(bdir / "configs" / f"{entry['config']}.json", CONFIG_KEYS)
    traffic = _load_json(bdir / "traffic" / f"{entry['traffic']}.json", TRAFFIC_KEYS)
    if config["name"] != entry["config"]:
        raise ValueError(f"{entry['config']}.json names {config['name']!r}")
    return Cell(name, entry, workload, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """``read(rec) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
