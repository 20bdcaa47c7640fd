"""The output check: what the window produced, held against the plain
reference in fp32 (TF32 off), after the window has closed and the program's
state is freed.

The reference, the model family's ``Reference`` (``benchmark/families/``),
follows the program one window step at a time from the program's own state
(the latents and, for a multistep scheduler, the history that the step
received), and works out everything else itself from the raw scene files and
the seed: the rows' conditions, the weights, the schedule. The start is checked on its own: the grid the sampler starts from
(fresh seeded noise, or the resumed seeded state) must equal the reference's
bit for bit. So is the chain between the steps: from that start, every
step of the first job must receive what the schedule and the steps before
it left, so the state a sampled step received is the reference's start
carried through the program's own earlier steps, not a state of its own.

Numbers, each against its limit in the cell's file:

* ``start``: largest absolute difference of the starting grid (limit 0);
* ``chain``: rows of the first job that break the chain between its steps
  (limit 0): see :func:`chain`;
* ``step``: over the sampled window steps and their target rows, the largest
  L2 error of a row after the step, ``|out - out_ref|`` less the grid's bf16
  rounding, relative to the model's part of the reference's update of that
  row, ``|out_ref - out0_ref|`` (``out0_ref``: the same step with eps = 0;
  the step is affine in eps); see :func:`_row_err`;
* ``hist`` (a multistep scheduler): the same for the history's x0 prediction;
* ``decode`` (a mix that decodes): over the sampled frames, the largest RMS
  difference, in 8-bit levels, between the program's decoded image and the
  reference's decode of the same latents.
"""

from __future__ import annotations

import time

import numpy as np
import torch

RESOLVE = 4.0


def _row_err(out: torch.Tensor, ref: torch.Tensor, ref0: torch.Tensor,
             rows: torch.Tensor) -> float | None:
    """Largest over ``rows`` of the model's error in a row after the step,
    relative to the model's part of the row's update, ``|ref - ref0|``
    (``ref0``: the reference's step with eps = 0).

    ``out`` is held in a lower dtype than ``ref`` (the grid's bf16), and its
    rounding to that dtype is no error of the model: its expected square,
    ``|round(ref) - ref|^2`` (a row has 65,536 values, so the estimate is
    tight), is taken off ``|out - ref|^2``. A row whose model part is under
    ``RESOLVE`` times that rounding is not compared: there the rounding is
    the whole difference (a DDIM row at its last step, where eps enters with
    a weight of 0.012). None where no row is compared."""
    num2 = (out.double() - ref.double()).flatten(1).square().sum(1)
    rnd2 = (ref.to(out.dtype).double() - ref.double()).flatten(1).square().sum(1)
    den = (ref.double() - ref0.double()).flatten(1).norm(dim=1)
    keep = rows & (den > RESOLVE * rnd2.sqrt())
    if not bool(keep.any()):
        return None
    err = (num2 - rnd2).clamp(min=0).sqrt() / den.clamp(min=1e-30)
    return float(err[keep].max())


def chain(start: dict, tasks: list, steps: list, decodes: list, n_denoise: int,
          total_steps: int) -> int:
    """Rows of the first job whose state, handed from step to step, is not
    what the schedule and the steps before it make of the reference's
    starting state, bit for bit.

    ``start``: the reference's starting grid, ``latents`` (S, T, h, w, c) as
    float32, ``t_idx`` (S, T) and ``aux`` (``prev_x0``, ``has_prev``) or
    None. ``tasks``, in the order they ran: each task's ``cells`` (camera
    and frame index of its rows), ``is_cond`` per row, ``windows`` (rows of
    each window, by the reference's schedule) and ``after``, the program's
    grid at those cells once the window closed. ``steps``: the scheduler's
    calls in order, ``n_denoise`` to a window. ``decodes``: the decode
    calls' latents in order, one to a task whose rows finish.

    Each step's latents and history must be those its rows last left (the
    starting grid for a row not yet stepped), its targets' ``t_idx`` the
    starting one plus the steps the schedule gave them before, its inputs'
    0; each task's grid rows afterwards those its last steps left; each
    decode's latents the finished rows."""
    lat = {}
    hist = {}
    t_of = {}

    def row(cell):
        if cell not in lat:
            lat[cell] = torch.from_numpy(np.asarray(start["latents"][cell], np.float32))
            t_of[cell] = int(start["t_idx"][cell])
            if start["aux"] is not None:
                hist[cell] = (torch.from_numpy(np.asarray(start["aux"]["prev_x0"][cell],
                                                          np.float32)),
                              bool(start["aux"]["has_prev"][cell]))
        return cell

    bad = 0
    it = iter(steps)
    dec = iter(decodes)
    for task in tasks:
        cells = [row(c) for c in zip(*(a.tolist() for a in task["cells"]))]
        is_cond = task["is_cond"]
        for w in task["windows"]:
            for _ in range(n_denoise):
                rec = next(it, None)
                if rec is None:
                    return bad + len(w)
                x, t = rec["x"].float(), np.asarray(rec["t_idx"])
                for k, j in enumerate(w):
                    c = cells[j]
                    ok = torch.equal(x[k], lat[c]) and int(t[k]) == (0 if is_cond[j]
                                                                     else t_of[c])
                    if c in hist:
                        ok = ok and torch.equal(rec["aux"]["prev_x0"][k].float(), hist[c][0]) \
                            and bool(rec["aux"]["has_prev"][k]) == hist[c][1]
                    bad += not ok
                    lat[c] = rec["out"][k].to(rec["x"].dtype).float()
                    if not is_cond[j]:
                        t_of[c] += 1
                    if c in hist:
                        hist[c] = (rec["aux_out"]["prev_x0"][k].float(),
                                   bool(rec["aux_out"]["has_prev"][k]))
        after = task["after"]
        for j, c in enumerate(cells):
            ok = torch.equal(torch.from_numpy(after["latents"][j]), lat[c]) and \
                int(after["t_idx"][j]) == (0 if is_cond[j] else t_of[c])
            if c in hist:
                ok = ok and torch.equal(torch.from_numpy(after["aux"]["prev_x0"][j]),
                                        hist[c][0]) \
                    and bool(after["aux"]["has_prev"][j]) == hist[c][1]
            bad += not ok
        done = [j for j, c in enumerate(cells) if not is_cond[j] and t_of[c] == total_steps]
        if done:
            got = next(dec, None)
            want = torch.stack([lat[cells[j]] for j in done])
            bad += len(done) if got is None or got.shape[0] != len(done) else sum(
                not torch.equal(got[i].float(), want[i]) for i in range(len(done)))
    return bad + sum(1 for _ in it)


def compare(run: dict, control: bool = False) -> tuple[dict, dict, dict]:
    """(readings, control readings, seconds by part) of one run's records.

    ``run``: family (the model family's module, whose ``Reference`` is
    the plain reference), config, seed, device, entries (weight spec),
    scene_dir, size, latent, total_steps, domain, start (program vs expected
    starting arrays), chain (the arguments of :func:`chain`), steps
    ([(labels, first_label, is_cond, record)] of the sampled window steps),
    decodes ([(latents, images)] of the sampled frames)."""
    parts: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - clock[0]
        clock[0] = now

    ref = run["family"].Reference(run["config"], run["seed"], run["device"], run["entries"],
                                  run["total_steps"])
    lap("reference_build")
    out = {"start": max(0.0 if np.array_equal(a, b) else
                        float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))
                        for a, b in run["start"])}
    lap("start")
    out["chain"] = chain(**run["chain"])
    lap("chain")
    ctrl = {}
    step_err, hist_err, ctrl_step, ctrl_hist = [], [], [], []
    for labels, first, is_cond, rec in run["steps"]:
        cond = ref.conditions(run["scene_dir"], labels, first, is_cond, run["seed"],
                              run["size"], run["latent"])
        lap("conditions")
        (ref_out, ref_aux), (ref0, ref0_aux) = ref.step(run["domain"], rec, is_cond, cond)
        lap("step")
        tgt = torch.from_numpy(~is_cond).to(ref_out.device)
        step_err.append(_row_err(rec["out"].to(ref_out.device), ref_out, ref0, tgt))
        if ref_aux is not None:
            hist_err.append(_row_err(rec["aux_out"]["prev_x0"].to(ref_out.device),
                                     ref_aux["prev_x0"], ref0_aux["prev_x0"], tgt))
        if control:
            ref.set_fp8(True)
            c_cond = ref.conditions(run["scene_dir"], labels, first, is_cond, run["seed"],
                                    run["size"], run["latent"])
            (c_out, c_aux), _ = ref.step(run["domain"], rec, is_cond, c_cond)
            ref.set_fp8(False)
            lap("control")
            # in the program's place: its latents held in the grid's dtype
            ctrl_step.append(_row_err(c_out.to(rec["out"].dtype), ref_out, ref0, tgt))
            if c_aux is not None:
                ctrl_hist.append(_row_err(c_aux["prev_x0"], ref_aux["prev_x0"],
                                          ref0_aux["prev_x0"], tgt))
    for key, prog_vals, ctrl_vals in (("step", step_err, ctrl_step),
                                      ("hist", hist_err, ctrl_hist)):
        if any(v is not None for v in prog_vals):
            out[key] = max(v for v in prog_vals if v is not None)
            if control:
                ctrl[key] = max(v for v in ctrl_vals if v is not None)
    dec, cdec = [], []
    for latents, images in run["decodes"]:
        r = ref.decode(latents)
        prog = torch.from_numpy(np.asarray(images)).to(r.device).float()
        dec.append(((prog - r) ** 2).flatten(1).mean(1).sqrt().max())
        if control:
            ref.set_fp8(True)
            c = ref.decode(latents)
            ref.set_fp8(False)
            cdec.append(((c - r) ** 2).flatten(1).mean(1).sqrt().max())
    lap("decode")
    if dec:
        out["decode"] = float(max(dec))
        if control:
            ctrl["decode"] = float(max(cdec))
    return out, ctrl, parts
