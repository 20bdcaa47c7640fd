"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of the
checkout, ``benchmark/workloads/<cell>.json`` (configuration, traffic mix,
chips, why, the limits of the output check), ``benchmark/configs/<config>.json``
(the model family, its widths and scheduler, dtype, source, reduced,
assumed), ``benchmark/families/<family>.py`` (everything that depends on the
model: ``families/d4d_multiview.py`` says what a family provides),
``benchmark/traffic/<traffic>.json`` (the mix's parameters, read by the one
generator in ``harness/program.py``) and ``benchmark/metrics/<metric>.py``
(one reader per metric). A cell, configuration, family, mix or metric is
added by adding its file and its entry in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_KEYS = {"config", "traffic", "chips", "why", "limits"}
CONFIG_KEYS = {"name", "source", "family", "dtype", "image_size", "reduced", "assumed"}
DEFAULT_FAMILY = "d4d_multiview"  # a configuration without a ``family`` key
TRAFFIC_KEYS = {"exp", "sampler", "scene", "frames", "resume_round", "pose_cache_mb",
                "reduced", "why"}


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json
    workload: dict  # benchmark/workloads/<name>.json
    config: dict  # benchmark/configs/<config>.json
    traffic: dict  # benchmark/traffic/<traffic>.json
    family: ModuleType  # benchmark/families/<family>.py
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
    cpath = bdir / "configs" / f"{entry['config']}.json"
    family = load_family(json.loads(cpath.read_text()).get("family", DEFAULT_FAMILY), root)
    config = _load_json(cpath, CONFIG_KEYS | family.KEYS)
    traffic = _load_json(bdir / "traffic" / f"{entry['traffic']}.json", TRAFFIC_KEYS)
    if config["name"] != entry["config"]:
        raise ValueError(f"{entry['config']}.json names {config['name']!r}")
    return Cell(name, entry, workload, config, traffic, family,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _load_module(path: Path, module_name: str):
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[module_name] = mod  # as an import would: dataclasses look it up
    mod_spec.loader.exec_module(mod)
    return mod


def load_family(name: str, root: Path = ROOT):
    """The module of ``benchmark/families/<name>.py``."""
    path = root / "benchmark" / "families" / f"{name}.py"
    if not isinstance(name, str) or not NAME.match(name) or not path.is_file():
        raise ValueError(f"no model family {name!r}: benchmark/families/{name}.py is missing")
    return _load_module(path, f"bench_family_{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read(rec) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    return _load_module(root / "benchmark" / "metrics" / f"{name}.py",
                        f"bench_metric_{name}").read
