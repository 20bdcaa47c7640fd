"""A whole run of each cell on the CPU at the tiny widths: the result line,
the work count, and ``correct`` false when the timed path is broken
underneath or when the control (the reference in float8) is put in the
program's place."""

import json

import pytest
import torch

from benchmark.harness import spec as sp
from conftest import TINY_LIMITS

CELLS = [w["name"] for w in json.loads((sp.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_and_counts_the_schedule(tiny_run, cell):
    out = tiny_run(cell)
    res, rep = out["result"], out["report"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"], res["checks"]
    c = sp.load_cell(cell)
    steps_per_frame = 12 if c.traffic["exp"] == "demo_3d" else 18
    per_task = 44 * 12 if c.traffic["exp"] == "demo_3d" else 24 * 6
    assert rep["latent_steps"] == rep["tasks"] * per_task
    assert res["metrics"]["frames_per_s"]["value"] == pytest.approx(
        rep["latent_steps"] / steps_per_frame / rep["window_s"])
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())


def test_traced_run_reports_the_per_layer_metrics(tiny_run):
    out = tiny_run("skel-temporal", trace=True)
    res, rep = out["result"], out["report"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    # the CPU has no device trace: the readers of device time stay silent,
    # every other per-layer metric of the cell reads
    cell = sp.load_cell("skel-temporal")
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer
                                   if m["source"] != "device_trace"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the work count by op; no device time by op without a device trace
    assert set(rep["least_s_by_op"]) == {"attention"} and rep["least_s_by_op"]["attention"] > 0
    assert rep["device_by_op"] == {}


def _unchanged(prog):
    sched = prog.pipeline.scheduler
    sched.step = lambda eps, t, x, **kw: x
    sched.step_with_aux = lambda eps, t, x, aux, **kw: (x, aux)


def _half_batch(prog):
    unet = prog.pipeline.unet
    fwd = unet.forward

    def half(x, *a, **kw):
        """The second half of the rows' outputs left out, the first half's
        mean in their place."""
        eps = fwd(x, *a, **kw)
        n = x.shape[0] // 2
        return torch.cat([eps[:n], eps[:n].mean(0, keepdim=True).expand_as(eps[n:])])
    unet.forward = half


def _altered_row(prog):
    sched = prog.pipeline.scheduler
    for name in ("step", "step_with_aux"):
        fn = getattr(sched, name)

        def step(eps, t, x, *a, _fn=fn, **kw):
            out = _fn(eps, t, x, *a, **kw)
            lat = out[0] if isinstance(out, tuple) else out
            row = int(torch.nonzero(kw["mask"])[0])
            lat[row] = 2 * x[row] - lat[row]  # the row's update reversed
            return out
        setattr(sched, name, step)


def _dropped_write_back(prog):
    """The second window's latents never written back into the task's
    rows (its timesteps are)."""
    pipe = prog.pipeline
    fn, calls = pipe._denoise_step, [0]

    def step(cond_w, latents_w, *a, **kw):
        lat, t, aux = fn(cond_w, latents_w, *a, **kw)
        calls[0] += 1
        return (latents_w if calls[0] == 2 else lat), t, aux
    pipe._denoise_step = step


def _stale_history(prog):
    """Each window after the first stepped with the history that the
    window before it was handed."""
    pipe = prog.pipeline
    fn, last = pipe._denoise_step, [None]

    def step(cond_w, latents_w, t_idx_w, domain, aux_w=None):
        use = aux_w if last[0] is None else last[0]
        last[0] = aux_w
        return fn(cond_w, latents_w, t_idx_w, domain, use)
    pipe._denoise_step = step


def _shifted_timestep(prog):
    """Every target row stepped one timestep index late, the index handed
    back as if it had not been: wrong, but the same in the step's inputs
    and outputs."""
    pipe = prog.pipeline
    fn = pipe._denoise_step

    def step(cond_w, latents_w, t_idx_w, domain, aux_w=None):
        tgt = (~cond_w["is_cond"]).to(t_idx_w.dtype)
        lat, t, aux = fn(cond_w, latents_w, t_idx_w + tgt, domain, aux_w)
        return lat, t - tgt, aux
    pipe._denoise_step = step


def _altered_frames(prog):
    """Every decoded image altered where the decoder produces it (the check
    samples two frames of the job)."""
    dec = prog.pipeline.decode

    def decode(latents):
        return 255 - dec(latents)
    prog.pipeline.decode = decode


def _swapped_decode(prog):
    """The finished rows decoded in reverse order: each image written
    under another camera's name."""
    dec = prog.pipeline.decode

    def decode(latents):
        return dec(latents.flip(0))
    prog.pipeline.decode = decode


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in
                                        (_unchanged, _half_batch, _altered_row,
                                         _dropped_write_back, _shifted_timestep)]
                         + [("pose-demo3d", _altered_frames), ("pose-demo3d", _swapped_decode),
                            ("skel-temporal", _stale_history)],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(tiny_run, cell, fault):
    res = tiny_run(cell, seed=11, fault=fault)["result"]
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_float8_is_not_correct(tiny_run, cell):
    """The control: the reference, computed with float8 e4m3 products, in
    the program's place, through the same verdict and limits."""
    out = tiny_run(cell, seed=13, control=True)
    assert out["result"]["correct"]
    assert out["control"]["correct"] is False, out["control"]["checks"]
    assert set(out["control"]["checks"]) == set(TINY_LIMITS[cell])


@pytest.mark.parametrize("readings,correct", [
    ({"start": 0.0, "chain": 0, "step": 0.1}, True),
    ({"start": 0.0, "chain": 0}, False),  # a limit with no reading
    ({"start": 0.0, "chain": 0, "step": 0.1, "hist": 0.0}, False),  # a reading with no limit
    ({"start": 0.0, "chain": 1, "step": 0.1}, False),
])
def test_verdict_needs_a_reading_for_every_limit(readings, correct):
    from benchmark.harness.runner import verdict

    checks, ok = verdict(readings, {"start": 0.0, "chain": 0, "step": 0.2})
    assert ok is correct and set(checks) == set(readings)
