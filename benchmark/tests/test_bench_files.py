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
