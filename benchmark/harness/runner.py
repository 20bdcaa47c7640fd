"""One run of one cell: set-up, the measured window, the readers, the output
check. ``benchmark/run.py`` is the command line around :func:`run`; the CPU
tests call :func:`run` at the tiny size with ``device="cpu"``."""

from __future__ import annotations

import gc
import os.path as osp
import sys
import time

import numpy as np
import torch

from benchmark.harness import check as chk
from benchmark.harness import spec as sp
from benchmark.harness import trace as tr
from benchmark.harness import weights as W
from benchmark.harness.program import Program, Recorder
from benchmark.reference import data as ref_data

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffuman4d_tpu")
RANGES = {  # bench/* host ranges of a traced window, around public entry points
    "pipeline": ("prepare_conditions", "sliding_denoise", "decode"),
    "sampler": ("load_sample", "save_state", "validate_grid"),
}


CHECK_STEPS = 1  # window steps of the first task held against the reference
CHECK_FRAMES = 2  # decoded frames of the first job, where the mix decodes


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def _ranged(fn, name: str):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def wrap_attention() -> None:
    """Open a ``bench/attention`` range around every call of the port's
    attention entry, ``ops/attention.py: dot_product_attention``, wherever a
    module of the port bound it."""
    from diffuman4d_torch.ops import attention as att

    orig = att.dot_product_attention
    wrapped = _ranged(orig, tr.ATTENTION_RANGE)
    for name, mod in list(sys.modules.items()):
        if name.split(".", 1)[0] == "diffuman4d_torch" and \
                getattr(mod, "dot_product_attention", None) is orig:
            mod.dot_product_attention = wrapped


def _wrap_ranges(obj, names) -> None:
    for n in names:
        setattr(obj, n, _ranged(getattr(obj, n), f"bench/{n}"))


def _draw(rng: np.random.Generator, n: int, k: int) -> list[int]:
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", root=sp.ROOT, image_size=None, overrides=None, control=False,
        fault=None, cache=None, limits=None) -> dict:
    """Returns {"result": the result line's object, "report": extra
    numbers} and, with ``control=True``, "control": the verdict on the
    control in the program's place ({"correct", "checks"}). ``fault``, a
    callable on the program, breaks its timed path (tests); ``cache`` holds
    the scenes and the jobs' outputs (default ``benchmark/.cache``);
    ``overrides`` ({config key: {sub-key: value}}) and ``limits`` replace
    the configuration's and the cell's (the tests' tiny widths)."""
    cell = sp.load_cell(cell_name, root)
    cache = cache or osp.join(root, "benchmark", ".cache")
    dev = torch.device(device)
    prog = Program(cell, seed, dev, cache, image_size, overrides)
    pipe, sh, tr_cfg = prog.pipeline, prog.shape, cell.traffic
    setup_parts = {"program": time.perf_counter() - t_start}
    step_s = prog.family.warm_up(prog)
    setup_parts["warm_up"] = time.perf_counter() - t_start - sum(setup_parts.values())
    task_s = prog.task_seconds(step_s)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32])

    resumed = tr_cfg["resume_round"] > 0
    if resumed:
        seeded = prog.seed_state()
        # a whole number of tasks, fixed before the window: a time budget
        # would flip between one task and two on a few percent of host time
        sampler = prog.build_sampler(0, task_budget=max(1, int(seconds // task_s)))
        if sampler.grid_t_idx.max() == 0:
            raise RuntimeError("the sampler did not resume the seeded state")
        start_pairs = _resumed_pairs(sampler, seeded)
        start = {"latents": _bf16_to_f32(seeded["latents"]), "t_idx": seeded["t_idx"],
                 "aux": None if "aux_prev_x0" not in seeded else {
                     "prev_x0": seeded["aux_prev_x0"], "has_prev": seeded["aux_has_prev"]}}
    else:
        sampler = prog.build_sampler(0)
        start_pairs = [(sampler.grid_latents.float().cpu().numpy().copy(), None)]
    pipe.clear_condition_caches()
    setup_parts["sampler"] = time.perf_counter() - t_start - sum(setup_parts.values())
    prog.preload(sampler, sampler.all_tasks[tr_cfg["resume_round"]][0])
    setup_parts["first_sample"] = time.perf_counter() - t_start - sum(setup_parts.values())
    if fault is not None:
        fault(prog)
    rec = Recorder()  # the first job's window steps, for the output check
    rec.install(pipe)
    if trace:
        wrap_attention()
        _wrap_ranges(pipe, RANGES["pipeline"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    from diffuman4d_torch.utils.tracing import report

    prof = window_range = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        prof.__enter__()
        window_range = record_function(tr.WINDOW_RANGE)
        window_range.__enter__()
    report(reset=True)
    t0 = time.perf_counter()
    jobs = []  # (sampler, t_idx before)
    s = sampler
    while True:
        j0 = time.perf_counter()
        if trace:
            _wrap_ranges(s, RANGES["sampler"])
        before = s.grid_t_idx.copy()
        s.execute_tasks()
        jobs.append((s, before))
        rec.recording = False
        # a further fresh job only where the last one's time says it ends
        # within the seconds
        if resumed or time.perf_counter() - t0 + (time.perf_counter() - j0) > seconds:
            break
        s = prog.build_sampler(len(jobs))
        pipe.clear_condition_caches()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    spans = report(reset=True)
    prof_red = None
    if prof is not None:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        prof_red = tr.reduce_events(prof.profiler.kineto_results.events())
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

    # -- work done, by the grid -------------------------------------------
    latent_steps, tasks_run = 0, []
    round_idx = tr_cfg["resume_round"]
    for s, before in jobs:
        moved = s.grid_t_idx.astype(np.int64) - before
        end = (round_idx + 1) * sh.steps_per_alt
        if (s.grid_t_idx > end).any() or (moved < 0).any():
            raise RuntimeError("a grid cell moved past its round's end")
        _check_domain(s, moved, sh)
        latent_steps += int(moved.sum())
        per_task = sh.steps_per_alt * _targets_per_task(s, sh)
        if moved.sum() % per_task:
            raise RuntimeError("the window ran part of a task")
        tasks_run += [(s, t) for t in s.all_tasks[round_idx][:int(moved.sum()) // per_task]]

    rec_run = {
        "window_s": window_s, "setup_s": setup_s, "spans": spans,
        "latent_steps": latent_steps, "steps_per_frame": sh.total_steps,
        "window_steps": len(tasks_run) * sh.windows_per_task * sh.n_denoise,
        "tasks": len(tasks_run), "trace": prof_red,
    }
    if trace:
        rec_run.update(_work(prog, tasks_run, sh))

    # -- the output check, the program's state freed -------------------------
    first_sampler, first_task = tasks_run[0]
    if not resumed:
        S = len(first_sampler.spa_labels)
        cells = [(s, t) for s in range(S) for t in range(len(first_sampler.tem_labels))]
        noise = ref_data.init_noise(prog.seed, cells, pipe.latent_size)
        expect = noise.to(torch.bfloat16).float().numpy().reshape(start_pairs[0][0].shape)
        start_pairs = [(start_pairs[0][0], expect)]
        start = {"latents": expect, "t_idx": np.zeros(expect.shape[:2], np.int32),
                 "aux": None if first_sampler.grid_aux is None else {
                     "prev_x0": np.zeros(expect.shape, np.float32),
                     "has_prev": np.zeros(expect.shape[:2], bool)}}
    recorded = [_to_cpu(r) for r in rec.steps]
    chain_tasks = [_task_after(prog, s, task) for s, task in tasks_run if s is first_sampler]
    labels = prog.task_labels(first_sampler, first_task)
    is_cond_task = chain_tasks[0]["is_cond"]
    wins = chain_tasks[0]["windows"]
    steps = []
    cells0 = chain_tasks[0]["cells"]
    steps_ok = checkable_steps(wins, is_cond_task, start["t_idx"][cells0], sh.n_denoise,
                               sh.total_steps)
    for i in [steps_ok[k] for k in _draw(rng, len(steps_ok), CHECK_STEPS)]:
        rows = wins[i // sh.n_denoise]
        steps.append(([labels[j] for j in rows], labels[0], is_cond_task[rows], recorded[i]))
    decodes = []
    if rec.decodes:
        latents, images = rec.decodes[0]
        pick = _draw(rng, latents.shape[0], CHECK_FRAMES)
        decodes = [(latents[pick].cpu(), np.asarray(images)[pick])]
    run_info = {
        "family": prog.family, "config": prog.config, "seed": prog.seed, "device": dev,
        "entries": W.spec(prog.family.reference_modules(prog.config)),
        "scene_dir": osp.join(prog.data_root, prog.scene), "size": prog.size,
        "latent": pipe.latent_size, "total_steps": sh.total_steps,
        "domain": sh.domain, "start": start_pairs, "steps": steps, "decodes": decodes,
        "chain": {"start": start, "tasks": chain_tasks, "steps": recorded,
                  "decodes": [lat.cpu() for lat, _ in rec.decodes[:len(chain_tasks)]],
                  "n_denoise": sh.n_denoise, "total_steps": sh.total_steps},
    }
    del jobs, tasks_run, first_sampler, sampler, s, rec, pipe, prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings, ctrl, check_parts = chk.compare(run_info, control=control)
    check_s = time.perf_counter() - t_check
    limits = limits or cell.workload["limits"]
    checks, correct = verdict(readings, limits)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = sp.metric_reader(m["name"], root)(rec_run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = _device(dev, peak)
    if prof_red is not None:
        device_info["busy_s"] = prof_red["busy_s"]
        device_info["window_s"] = prof_red["window_s"]
    result = {"correct": bool(correct), "attempted": rec_run["tasks"],
              "failed": 0, "metrics": metrics, "device": device_info}
    if prof_red is not None:
        result["breakdown"] = {"device_ops": prof_red["device_ops"],
                               "idle_gaps": prof_red["idle_gaps"]}
    result["checks"] = checks
    report_extra = {"memory_peak_bytes": peak, "window_s": window_s, "setup_s": setup_s,
                    "tasks": rec_run["tasks"], "latent_steps": latent_steps,
                    "predicted_task_s": task_s, "warm_step_s": step_s, "check_s": check_s,
                    "setup_parts": setup_parts, "check_parts": check_parts, "spans": spans}
    if trace:
        report_extra.update(least_s_by_op=rec_run["least_s_by_op"],
                            device_by_op=prof_red["device_by_op"])
    out = {"result": result, "report": report_extra}
    if control:
        # the control in the program's place: its numbers replace the
        # program's, the rest (start, chain) it shares with the program
        c_checks, c_correct = verdict({**readings, **ctrl}, limits)
        out["control"] = {"correct": c_correct, "checks": c_checks}
    return out


def checkable_steps(windows: np.ndarray, is_cond: np.ndarray, t_idx: np.ndarray,
                    n_denoise: int, total_steps: int) -> list[int]:
    """The window steps of a task (``t_idx``: its rows' starting indices)
    in which some target row is short of its last step. At its last step a
    DDIM row takes eps at a weight of 0.012, and the grid's bf16 rounding is
    all the difference (``check._row_err`` skips such rows): a step with no
    other row compares nothing."""
    t = np.array(t_idx, np.int64)
    out = []
    for w_i, w in enumerate(windows):
        tgt = w[~is_cond[w]]
        for k in range(n_denoise):
            if (t[tgt] < total_steps - 1).any():
                out.append(w_i * n_denoise + k)
            t[tgt] += 1
    return out


def verdict(readings: dict, limits: dict) -> tuple[dict, bool]:
    """(each number beside its limit, correct): correct where every limit
    has a reading and no reading is over its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}
    correct = set(readings) == set(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    return checks, bool(correct)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _task_after(prog: Program, s, task) -> dict:
    """A task of the first job for the chain check: its rows' cells,
    conditional rows and windows, and the grid at its cells after the
    window."""
    spa, tem = prog.task_cells(s, task)
    dev = s.grid_latents.device
    sp_t, tm_t = torch.from_numpy(spa).to(dev), torch.from_numpy(tem).to(dev)
    return {"cells": (spa, tem), "is_cond": prog.task_is_cond(s, task),
            "windows": prog.task_windows(s, task),
            "after": {"latents": s.grid_latents[sp_t, tm_t].float().cpu().numpy(),
                      "t_idx": s.grid_t_idx[spa, tem].copy(),
                      "aux": None if s.grid_aux is None else {
                          k: v[sp_t, tm_t].cpu().numpy() for k, v in s.grid_aux.items()}}}


def _to_cpu(r: dict) -> dict:
    out = dict(r)
    for k in ("x", "out"):
        out[k] = r[k].cpu()
    for k in ("aux", "aux_out"):
        if r[k] is not None:
            out[k] = {n: v.cpu() for n, v in r[k].items()}
    return out


def _targets_per_task(s, sh) -> int:
    return len(s.target_spa_labels) if sh.domain == "spatial" else len(s.tem_labels)


def _check_domain(s, moved: np.ndarray, sh) -> None:
    """Every task that ran is of the mix's domain: a temporal task moves one
    target camera's every frame, a spatial one every target camera of one
    frame, each by the round's steps."""
    step = sh.steps_per_alt
    if ((moved != 0) & (moved != step)).any():
        raise RuntimeError("a grid cell moved by other than one round's steps")
    m = moved == step
    rows = [s.spa_labels.index(c) for c in s.target_spa_labels]
    if sh.domain == "temporal":
        whole = m.all(axis=1) | ~m.any(axis=1)
    else:
        whole = m[rows].all(axis=0) | ~m[rows].any(axis=0)
    if not whole.all():
        raise RuntimeError(f"a task of another domain than {sh.domain} ran in the window")


def _resumed_pairs(sampler, seeded: dict) -> list:
    """(program, seeded) array pairs of the resumed grid, copied: the window
    updates the grid in place."""
    lat = sampler.grid_latents.to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
    pairs = [(lat, seeded["latents"]), (sampler.grid_t_idx, seeded["t_idx"])]
    if sampler.grid_aux is not None:
        pairs.append((sampler.grid_aux["prev_x0"].cpu().numpy(), seeded["aux_prev_x0"]))
        pairs.append((sampler.grid_aux["has_prev"].cpu().numpy(), seeded["aux_has_prev"]))
    return [(np.array(a, copy=True), b) for a, b in pairs]


def _work(prog: Program, tasks_run, sh) -> dict:
    """The window's work as the model family counts it, from the tasks that
    ran grouped by job: ``flops``, ``least_s_by_op`` (the least time of each
    of the port's ``op/<name>`` ranges that the family counts) and
    ``attn_least_s``, its attention entry."""
    jobs: dict = {}
    for s, task in tasks_run:
        job = jobs.setdefault(id(s), {"tasks": [], "targets": len(s.target_spa_labels)})
        job["tasks"].append((prog.task_labels(s, task), prog.task_is_cond(s, task)))
    out = prog.family.work(prog.config, prog.size, sh, list(jobs.values()))
    return {"flops": out["flops"], "least_s_by_op": out["least_s_by_op"],
            "attn_least_s": out["least_s_by_op"].get("attention")}


def _device(dev, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak}
