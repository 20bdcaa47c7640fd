"""The FLOP and roofline counts against hand counts, and the Diffuman4D
family's count of a window's work at the published widths against the
numbers the harness gave before the family split (exact)."""

import types

import numpy as np
import pytest
import torch

from benchmark.harness import runner, work
from benchmark.harness import spec as sp
from benchmark.harness.program import Program, Shape
from benchmark.reference import models as ref

PEAK, HBM = work.PEAK_BF16_FLOPS, work.PEAK_HBM_BYTES
D4D = sp.load_family("d4d_multiview")


@pytest.mark.parametrize("b,s,h,d", [(2, 65536, 10, 64), (32, 256, 20, 64)])
def test_attention_least_time_by_hand(b, s, h, d):
    flops = 4 * b * h * s * s * d
    nbytes = 2 * 4 * b * s * h * d  # q, k, v read, o written, bf16
    assert work.attention_least_s(b, s, h, d) == pytest.approx(max(flops / PEAK, nbytes / HBM))


def test_attention_bound_switches_from_operations_to_bytes():
    assert work.attention_least_s(2, 65536, 10, 64) == pytest.approx(
        4 * 2 * 10 * 65536 ** 2 * 64 / PEAK)
    assert work.attention_least_s(32, 16, 20, 64) == pytest.approx(
        2 * 4 * 32 * 16 * 20 * 64 / HBM)


@pytest.mark.parametrize("size", [64, 1024])
def test_pose_encoder_flops_by_hand(size):
    flops, hw, cin = 0, size, 3
    for cout, k, s in ref.PoseEncoder.PLAN:
        hw = hw // s
        flops += 2 * cout * cin * k * k * hw * hw
        cin = cout
    flops += 2 * 320 * cin * hw * hw  # final 1x1 projection
    cfg = {"name": "t", "unet": dict(_unet(), enable_pose_encoder=True), "vae": _vae()}
    assert D4D.Work(cfg, size).pose_encode()[0] == flops


@pytest.mark.parametrize("s,h,d", [(4096, 1, 8), (256, 2, 16)])
def test_reference_attention_flops(s, h, d):
    f, least = work.count(lambda: ref.attention(
        ref.Prec(), *(torch.empty(1, s, h, d, device="meta") for _ in range(3))), ref)
    assert f == 4 * s * s * h * d
    assert least == pytest.approx(work.attention_least_s(1, s, h, d))


def test_unet_flops_scale_with_rows():
    cfg = {"name": "t", "unet": dict(_unet(), block_out_channels=[8, 16, 16, 16],
                                     num_attention_heads=[1, 2, 2, 2], norm_num_groups=4),
           "vae": _vae()}
    w = D4D.Work(cfg, 64)
    f1, _ = w.unet_forward(4, 1)
    f2, _ = w.unet_forward(8, 1)
    assert f2 == 2 * f1  # per-frame attention: linear in rows


@pytest.mark.parametrize("cell,skipped", [("pose-demo3d", [43]), ("skel-temporal", [])])
def test_checkable_steps_leave_out_a_window_of_last_steps_only(cell, skipped):
    """demo_3d's last window holds every target at its last step, so the
    checked step is drawn from the other 43; a temporal round 2 (indices
    6..11 of 18) keeps all 12."""
    from benchmark.harness.runner import checkable_steps
    from benchmark.reference import windows as ref_windows

    tr = sp.load_cell(cell).traffic
    sm = tr["sampler"]
    per, total = ref_windows.step_counts(sm["window_size"], sm["sliding_stride"],
                                         sm["num_denoising_steps"], False,
                                         sm["alternation_rounds"])
    if tr["exp"] == "demo_3d":
        is_cond = np.isin(np.arange(48), [1, 13, 25, 37])
        wins = ref_windows.windows(np.nonzero(~is_cond)[0], np.nonzero(is_cond)[0],
                                   "spatial", sm["window_size"], sm["sliding_stride"])
    else:
        n = tr["frames"]
        is_cond = np.arange(2 * n) < n
        wins = ref_windows.windows(np.arange(n, 2 * n), np.arange(n), "temporal",
                                   sm["window_size"], sm["sliding_stride"])
    t0 = np.where(is_cond, 0, tr["resume_round"] * per)
    ok = checkable_steps(wins, is_cond, t0, sm["num_denoising_steps"], total)
    assert sorted(set(range(len(wins))) - set(ok)) == skipped


# The window shapes of the cells (``Program.shape``) and the work the harness
# counted for fixed tasks before the Diffuman4D family was split out of it
# (``runner._work`` at the parent of that change): FLOPs and attention least
# seconds, at the configurations' published widths and 1024^2.
SHAPES = {
    "pose-demo3d": Shape("spatial", 16, 44, 1, 12, 12, False, True, True),
    "skel-temporal": Shape("temporal", 24, 12, 1, 6, 18, True, True, False),
    "pose-temporal-stream": Shape("temporal", 24, 12, 1, 6, 18, True, True, False),
}
PINNED = {
    ("pose-demo3d", 1): (1.5051615123800064e+16, 10.774147845010388),
    ("pose-demo3d", 2): (3.010323024760013e+16, 21.548295690020776),
    ("skel-temporal", 1): (2.204719798812672e+16, 16.66506098022464),
    ("pose-temporal-stream", 1): (2.1462293942370304e+16, 16.598356533645713),
}


def _fixed_tasks(domain: str) -> list:
    """(sampler, task) pairs of one job: the demo_3d ring's one spatial task,
    or three temporal tasks of which two share a condition camera."""
    cams = [f"{i:02d}" for i in range(48)]
    inputs = ["01", "13", "25", "37"]
    s = types.SimpleNamespace(input_spa_labels=inputs,
                              target_spa_labels=[c for c in cams if c not in inputs])
    if domain == "spatial":
        return [(s, types.SimpleNamespace(domain="spatial",
                                          labels=[("sc", c, "000000") for c in cams]))]
    frames = [f"{f:06d}" for f in range(24)]
    return [(s, types.SimpleNamespace(domain="temporal", labels=[
        ("sc", cam, f) for cam in (cond, tgt) for f in frames]))
        for tgt, cond in (("02", "01"), ("03", "01"), ("12", "13"))]


@pytest.mark.parametrize("cell,jobs", sorted(PINNED), ids=lambda x: str(x))
def test_window_work_at_the_published_widths_is_pinned(cell, jobs):
    c = sp.load_cell(cell)
    sh = SHAPES[cell]
    prog = types.SimpleNamespace(family=c.family, config=c.config, size=c.config["image_size"],
                                 task_labels=lambda s, t: t.labels)
    prog.task_is_cond = lambda s, t: Program.task_is_cond(prog, s, t)
    tasks = [x for _ in range(jobs) for x in _fixed_tasks(sh.domain)]
    out = runner._work(prog, tasks, sh)
    assert (out["flops"], out["attn_least_s"]) == PINNED[cell, jobs]
    assert out["least_s_by_op"] == {"attention": out["attn_least_s"]}


def _unet():
    return {"in_channels": 11, "out_channels": 4, "block_out_channels": [320, 640, 1280, 1280],
            "layers_per_block": 2, "num_attention_heads": [5, 10, 20, 20],
            "norm_num_groups": 32, "num_3d_attn_blocks": 3, "enable_tem_embeds": True,
            "enable_pose_encoder": True}


def _vae():
    return {"block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
            "latent_channels": 4, "scaling_factor": 0.18215}
