"""BENCHMARK.json and the files it names: every cell, configuration, mix and
metric loads and keeps to the contract's limits, and a cell added as files
is found with no edit."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec as sp

BENCH = json.loads((sp.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    n = 24  # a full benchmark: 2 + 14 runs a cell, each run_seconds + 60
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(x) for x in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry_and_reader(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(sp.metric_reader(metric["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    c = sp.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frames_per_s"}
    assert c.per_layer
    assert c.workload["limits"]["start"] == 0.0
    files = {x["name"]: x["file"] for x in BENCH["configs"]}
    assert (sp.ROOT / files[c.entry["config"]]).is_file()
    assert len(c.entry["why"]) <= 200 and "\n" not in c.entry["why"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the checkout's benchmark files with one more cell: a file
    under workloads/ and an entry in BENCHMARK.json, nothing edited."""
    shutil.copytree(sp.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = dict(bench["workloads"][0], name="pose-demo3d-copy")
    bench["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    src = tmp_path / "benchmark" / "workloads" / f"{BENCH['workloads'][0]['name']}.json"
    (tmp_path / "benchmark" / "workloads" / "pose-demo3d-copy.json").write_text(src.read_text())
    c = sp.load_cell("pose-demo3d-copy", tmp_path)
    assert c.name == "pose-demo3d-copy" and c.traffic == sp.load_cell(
        BENCH["workloads"][0]["name"]).traffic


def test_a_mismatched_cell_file_is_refused(tmp_path):
    shutil.copytree(sp.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    name = BENCH["workloads"][0]["name"]
    path = tmp_path / "benchmark" / "workloads" / f"{name}.json"
    data = json.loads(path.read_text())
    path.write_text(json.dumps(dict(data, chips=4)))
    with pytest.raises(ValueError):
        sp.load_cell(name, tmp_path)


# A second model family, as a later configuration of another architecture
# would bring it: a file under families/ (here the Diffuman4D family under
# another name, with one configuration key of its own), a configuration
# naming it, a cell, and their entries in BENCHMARK.json.
SECOND_FAMILY = '''"""The Diffuman4D family under another name, with a key of its own."""
from pathlib import Path

from benchmark.harness import spec as _sp

_base = _sp.load_family("d4d_multiview", Path(__file__).resolve().parents[2])
globals().update({k: v for k, v in vars(_base).items() if not k.startswith("__")})
KEYS = _base.KEYS | {"note"}
'''


def _with_second_family(root):
    shutil.copytree(sp.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "benchmark" / "families" / "d4d_copy.py").write_text(SECOND_FAMILY)
    base = sp.load_cell("pose-demo3d")
    config = dict(base.config, name="copy-pose-ddim", family="d4d_copy", note="a copy")
    (root / "benchmark" / "configs" / "copy-pose-ddim.json").write_text(json.dumps(config))
    (root / "benchmark" / "workloads" / "copy-demo3d.json").write_text(
        json.dumps(dict(base.workload, config="copy-pose-ddim")))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="copy-pose-ddim",
                                 file="benchmark/configs/copy-pose-ddim.json"))
    bench["workloads"].append(dict(base.entry, name="copy-demo3d", config="copy-pose-ddim"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return config


def test_a_configuration_of_a_second_family_added_as_files_runs(tmp_path, tiny_run):
    """The cell of a second family loads with the family's own keys and
    its tiny run is correct: nothing that was there needed an edit."""
    root = tmp_path / "checkout"
    _with_second_family(root)
    c = sp.load_cell("copy-demo3d", root)
    assert c.family.__name__ == "bench_family_d4d_copy" and c.config["note"] == "a copy"
    out = tiny_run("copy-demo3d", root=root, limits_of="pose-demo3d")
    assert out["result"]["correct"], out["result"]["checks"]


@pytest.mark.parametrize("family,error", [
    ("no_such_family", "no_such_family"),  # a family with no file
    (None, "note"),  # the default family does not read the second family's key
])
def test_a_configuration_naming_a_missing_family_or_an_unread_key_is_refused(
        tmp_path, family, error):
    config = _with_second_family(tmp_path)
    config = {k: v for k, v in dict(config, family=family).items() if v is not None}
    (tmp_path / "benchmark" / "configs" / "copy-pose-ddim.json").write_text(json.dumps(config))
    with pytest.raises(ValueError, match=error):
        sp.load_cell("copy-demo3d", tmp_path)
