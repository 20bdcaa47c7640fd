"""The FLOP and roofline counts against hand counts."""

import numpy as np
import pytest
import torch

from benchmark.harness import work
from benchmark.reference import models as ref

PEAK, HBM = work.PEAK_BF16_FLOPS, work.PEAK_HBM_BYTES


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
    assert work.Work(cfg, size).pose_encode()[0] == flops


@pytest.mark.parametrize("s,h,d", [(4096, 1, 8), (256, 2, 16)])
def test_reference_attention_flops(s, h, d):
    f, least = work._count(lambda: ref.attention(
        ref.Prec(), *(torch.empty(1, s, h, d, device="meta") for _ in range(3))))
    assert f == 4 * s * s * h * d
    assert least == pytest.approx(work.attention_least_s(1, s, h, d))


def test_unet_flops_scale_with_rows():
    cfg = {"name": "t", "unet": dict(_unet(), block_out_channels=[8, 16, 16, 16],
                                     num_attention_heads=[1, 2, 2, 2], norm_num_groups=4),
           "vae": _vae()}
    w = work.Work(cfg, 64)
    f1, _ = w.unet_forward(4, 1)
    f2, _ = w.unet_forward(8, 1)
    assert f2 == 2 * f1  # per-frame attention: linear in rows


@pytest.mark.parametrize("cell,skipped", [("pose-demo3d", [43]), ("skel-temporal", [])])
def test_checkable_steps_leave_out_a_window_of_last_steps_only(cell, skipped):
    """demo_3d's last window holds every target at its last step, so the
    checked step is drawn from the other 43; a temporal round 2 (indices
    6..11 of 18) keeps all 12."""
    from benchmark.harness import spec as sp
    from benchmark.reference import sampling as ref_sampling
    from benchmark.harness.runner import checkable_steps

    tr = sp.load_cell(cell).traffic
    sm = tr["sampler"]
    per, total = ref_sampling.step_counts(sm["window_size"], sm["sliding_stride"],
                                          sm["num_denoising_steps"], False,
                                          sm["alternation_rounds"])
    if tr["exp"] == "demo_3d":
        is_cond = np.isin(np.arange(48), [1, 13, 25, 37])
        wins = ref_sampling.windows(np.nonzero(~is_cond)[0], np.nonzero(is_cond)[0],
                                    "spatial", sm["window_size"], sm["sliding_stride"])
    else:
        n = tr["frames"]
        is_cond = np.arange(2 * n) < n
        wins = ref_sampling.windows(np.arange(n, 2 * n), np.arange(n), "temporal",
                                    sm["window_size"], sm["sliding_stride"])
    t0 = np.where(is_cond, 0, tr["resume_round"] * per)
    ok = checkable_steps(wins, is_cond, t0, sm["num_denoising_steps"], total)
    assert sorted(set(range(len(wins))) - set(ok)) == skipped


def _unet():
    return {"in_channels": 11, "out_channels": 4, "block_out_channels": [320, 640, 1280, 1280],
            "layers_per_block": 2, "num_attention_heads": [5, 10, 20, 20],
            "norm_num_groups": 32, "num_3d_attn_blocks": 3, "enable_tem_embeds": True,
            "enable_pose_encoder": True}


def _vae():
    return {"block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
            "latent_channels": 4, "scaling_factor": 0.18215}
