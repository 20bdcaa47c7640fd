"""The sampler's and the pipeline's spans and counters (``utils/tracing.py``)
on the CPU at the tiny model, 64^2 images, 6 cameras (inputs 0 and 3,
window 2):

- a demo_3d job, then a second job on the same pipeline, whose conditions
  all come from the caches;
- demo_4d's round 2 on 4 frames: two temporal tasks, their pose features
  streamed per window chunk (a pose cache of 0 MB).

Each run writes ``phases.json`` and ``counters.json`` through
``SamplingRunner._dump_phases``; the tests read them back."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

IMAGE = 64
GRID = ["sampler.spa_label_range=[0,6,1]", "sampler.input_spa_labels=[0,3]",
        "sampler.window_size=2", "model.arch=tiny", "model.dtype=fp32",
        f"data.height={IMAGE}", f"data.width={IMAGE}"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(root: Path, exp: str, frames: int, **cache_mb):
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.sampling.loader import load_pipeline

    cfg = build_config([f"exp={exp}", f"data.data_dir={root / 'data'}",
                        f"sampler.tem_label_range=[0,{frames},1]", *GRID])
    make_synthetic_scene(str(root / "data"), cfg.data.scene_label, num_cams=6,
                         num_frames=frames, image_size=IMAGE)
    return cfg, load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cpu", **cache_mb)


def _job(cfg, pipe, out: Path, start_round: int = 0, **kw) -> dict:
    """A sampler on ``out`` from round ``start_round`` (the rounds before
    it done), run; its tasks, grid moves and the files it wrote."""
    from diffuman4d_torch import cli
    from diffuman4d_torch.sampling.runner import SamplingRunner
    from diffuman4d_torch.utils.tracing import counters, report

    cfg.sampler.output_dir = str(out)
    sampler = cli.build_sampler(cfg, pipe, target_pixels=False, **kw)
    if start_round:
        targets = [sampler.spa_labels.index(s) for s in sampler.target_spa_labels]
        sampler.grid_t_idx[targets] = start_round * pipe.sliding.steps_per_alt
        sampler._completed_rounds = start_round
    before = sampler.grid_t_idx.copy()
    report(reset=True)
    counters(reset=True)
    sampler.execute_tasks()
    SamplingRunner(sampler)._dump_phases()
    tasks = [t for t in sampler.all_tasks[start_round]][:sampler._tasks_run]
    return {"sampler": sampler, "tasks": tasks, "moves": int((sampler.grid_t_idx - before).sum()),
            "phases": json.loads((out / "phases.json").read_text()),
            "counters": json.loads((out / "counters.json").read_text()),
            "report": report(reset=True), "counts": counters(reset=True)}


def _rows(sampler, task) -> tuple[int, int]:
    """(rows, conditional rows) of ``task``."""
    if task.domain == "spatial":
        return len(sampler.spa_labels), len(sampler.input_spa_labels)
    return 2 * len(sampler.tem_labels), len(sampler.tem_labels)


def _windows(sampler, task) -> int:
    return sampler._windows_for(task, _rows(sampler, task)[0]).shape[0]


@pytest.fixture(scope="module")
def demo3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans3d")
    cfg, pipe = _pipeline(root, "demo_3d", 1)
    return [_job(cfg, pipe, root / f"job{i}") for i in range(2)]


@pytest.fixture(scope="module")
def temporal(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans4d")
    cfg, pipe = _pipeline(root, "demo_4d", 4, pose_cache_mb=0)
    return _job(cfg, pipe, root / "out", start_round=1, task_budget=2)


def _both(demo3d, temporal):
    return [("demo3d", demo3d[0]), ("demo3d-cached", demo3d[1]), ("temporal", temporal)]


@pytest.mark.parametrize("run", ["demo3d", "demo3d-cached", "temporal"])
def test_window_steps_tasks_and_latent_steps_are_counted(demo3d, temporal, run):
    job = dict(_both(demo3d, temporal))[run]
    s, phases, c = job["sampler"], job["phases"], job["counters"]
    n_denoise = s.pipeline.sliding.num_denoising_steps
    assert len(job["tasks"]) == (2 if run == "temporal" else 1)
    assert phases["denoise/window_step"]["count"] == sum(
        _windows(s, t) * n_denoise for t in job["tasks"])
    assert c["sampler/tasks"] == len(job["tasks"])
    assert c["sampler/latent_steps"] == job["moves"] > 0
    step = phases["denoise/window_step"]
    assert step["p50_s"] <= step["p90_s"] <= step["max_s"]
    assert step["total_s"] <= phases["task/sliding_denoise"]["total_s"]


def test_cache_hits_and_misses_add_up_to_the_lookups(demo3d, temporal):
    """Every lookup of the three condition caches is a hit or a miss: the
    first demo_3d job misses everything, the second hits everything, and
    the streamed temporal tasks look up every skeleton row."""
    first, second = demo3d[0]["counters"], demo3d[1]["counters"]
    s = demo3d[0]["sampler"]
    rows, cond = _rows(s, demo3d[0]["tasks"][0])
    assert (first["cond/pix_cache_hit"], first["cond/pix_cache_miss"]) == (0, cond)
    assert (first["cond/pose_cache_hit"], first["cond/pose_cache_miss"]) == (0, rows)
    # the pose misses' skeleton rows, through the skeleton cache
    assert (first["cond/skel_cache_hit"], first["cond/skel_cache_miss"]) == (0, rows)
    assert (second["cond/pix_cache_hit"], second["cond/pix_cache_miss"]) == (cond, 0)
    assert (second["cond/pose_cache_hit"], second["cond/pose_cache_miss"]) == (rows, 0)
    assert second.get("cond/skel_cache_hit", 0) + second.get("cond/skel_cache_miss", 0) == 0

    t = temporal["counters"]
    lookups = [_rows(temporal["sampler"], task) for task in temporal["tasks"]]
    assert t["cond/pix_cache_hit"] + t["cond/pix_cache_miss"] == sum(c for _, c in lookups)
    assert t["cond/skel_cache_hit"] + t["cond/skel_cache_miss"] == sum(r for r, _ in lookups)
    assert "cond/pose_cache_hit" not in t  # streamed: the pose cache is not consulted


def test_waits_and_condition_spans_are_present(demo3d, temporal):
    first, second, tem = demo3d[0]["phases"], demo3d[1]["phases"], temporal["phases"]
    for phases in (first, second, tem):
        assert {"task/save_wait", "task/prepare_conditions", "cond/upload",
                "cond/plucker", "task/decode_save", "save/write_images"} <= set(phases)
        assert phases["task/save_wait"]["count"] >= 1
    # demo_3d decodes its finished rows; round 2 of 3 finishes none
    assert "save/decode" in first and "save/decode" not in tem
    assert {"cond/vae_encode", "cond/pose_encode"} <= set(first)
    assert not {"cond/vae_encode", "cond/pose_encode"} & set(second)  # all from the caches
    windows = [_windows(temporal["sampler"], t) for t in temporal["tasks"]]
    pipe = temporal["sampler"].pipeline
    assert tem["cond/chunk"]["count"] == sum(w // pipe._window_chunk_size(w) for w in windows)
    assert tem["task/prefetch_wait"]["count"] == 1  # the second task's sample


def test_phases_and_counters_files_hold_the_run(demo3d, temporal):
    for _, job in _both(demo3d, temporal):
        assert job["phases"] == job["report"]
        assert job["counters"] == job["counts"]
        out = Path(job["sampler"].output_dir)
        assert (out / "phases.json").is_file() and (out / "counters.json").is_file()
