"""The Stable Video Diffusion family (``families/svd_spatiotemporal.py``,
cell ``svdxt-orbit-clip``, run from a copy of the benchmark's files with its
mix cut to the tiny size, ``svd_checkout.py``): its work count against a
hand count of one UNet forward at the published widths, a tiny run of the
cell with ``correct`` true, ``correct`` false with the timed path broken
(the mix reversed, the temporal convolution's taps reversed, constant
guidance in place of the per-frame ramp) and with the float8 control in
the program's place, and the two per-layer readers.

The tiny run is the cell's mix cut to a 5-camera ring (input camera 0, its
4 others one clip, 3 Euler steps) at the tiny widths and 64^2 frames.
Limits: the bf16 program's readings on seeds 7 and 8 were step 0.031 /
0.027, decode 0.76 / 0.69 levels; the float8 control's step 0.26, decode 6.1
levels: step 0.15 and decode 2.0 lie between."""

import json
import time

import pytest
import torch

from benchmark.harness import runner, work
from benchmark.harness import spec as sp
from benchmark.harness.program import Shape
from svd_checkout import CELL, checkout

SVD = sp.load_family("svd_spatiotemporal")
CONFIG = json.loads((sp.BENCH_DIR / "configs" / "svd-xt.json").read_text())
LIMITS = {"start": 0.0, "chain": 0, "step": 0.15, "decode": 2.0}
TINY = {"unet": dict(block_out_channels=[8, 16, 16, 16], num_attention_heads=[1, 2, 2, 2],
                     layers_per_block=1, norm_num_groups=4, cross_attention_dim=16,
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=24),
        "vae": dict(block_out_channels=[4, 4, 8, 8], layers_per_block=1)}


def _hand_unet_flops(cfg: dict, frames: int, lat: int) -> tuple[float, float, float]:
    """(FLOPs, attention least seconds, temporal attention least seconds) of
    one UNet forward over a clip, layer by layer: a product of (M, K) by (K,
    N) is 2 M K N; a convolution 2 x outputs x Cin x taps; attention 4 B H S
    Sk D. A site's least time is the roofline's (Q, K, V read, O written);
    a one-key site's is V read and O written, all it moves."""
    ch, heads, lpb = cfg["block_out_channels"], cfg["num_attention_heads"], 2
    kv, ted, F = cfg["cross_attention_dim"], ch[0] * 4, frames
    total, att, tem = 0.0, 0.0, 0.0

    def one_key(b, s, h, d):
        return 2 * b * h * d * (s + 1) / work.PEAK_HBM_BYTES

    def hw(level):
        return (lat >> level) ** 2

    def resnet(cin, cout, level):
        n = F * hw(level)
        f = 2 * n * cin * cout * 9 + 2 * n * cout * cout * 9 + 2 * F * ted * cout
        f += 2 * n * cin * cout if cin != cout else 0
        f += 2 * (2 * n * cout * cout * 3) + 2 * F * ted * cout  # the temporal resnet
        return f

    def transformer(c, h, level):
        nonlocal att, tem
        n, s = F * hw(level), hw(level)
        f = 2 * 2 * n * c * c  # proj_in, proj_out
        f += 8 * n * c * c + 4 * F * s * s * c  # spatial self-attention
        f += 4 * n * c * c + 4 * F * kv * c + 4 * n * c  # cross-attention, one token a frame
        f += 24 * n * c * c  # GEGLU feed-forward
        f += 16 * F * c * c  # time_pos_embed
        f += 24 * n * c * c  # ff_in
        f += 8 * n * c * c + 4 * s * F * F * c  # the frames' self-attention
        f += 4 * n * c * c + 4 * kv * c + 4 * n * c  # cross-attention to the clip's token
        f += 24 * n * c * c
        d = c // h
        tem += work.attention_least_s(s, F, h, d, F)
        att += (work.attention_least_s(F, s, h, d) + one_key(F, s, h, d)
                + work.attention_least_s(s, F, h, d, F) + one_key(s, F, h, d))
        return f

    total += 2 * F * hw(0) * cfg["in_channels"] * ch[0] * 9
    total += 2 * F * (ch[0] * ted + ted * ted) + 2 * (3 * cfg["addition_time_embed_dim"] * ted
                                                       + ted * ted)
    skips, prev = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb):
            total += resnet(prev if j == 0 else c, c, i)
            if i < 3:
                total += transformer(c, heads[i], i)
        skips += [c] * lpb
        if i < 3:
            total += 2 * F * hw(i + 1) * c * c * 9
            skips.append(c)
        prev = c
    total += 2 * resnet(ch[-1], ch[-1], 3) + transformer(ch[-1], heads[-1], 3)
    for i, (c, h) in enumerate(zip(ch[::-1], heads[::-1])):
        level = 3 - i
        for _ in range(lpb + 1):
            total += resnet(prev + skips.pop(), c, level)
            prev = c
            if i > 0:
                total += transformer(c, h, level)
        if i < 3:
            total += 2 * F * hw(level - 1) * c * c * 9
    total += 2 * F * hw(0) * ch[0] * cfg["out_channels"] * 9
    return total, att, tem


def test_unet_work_is_the_hand_count_at_the_published_widths():
    cfg = CONFIG
    w = SVD.Work(cfg, cfg["image_size"])
    flops, least, tem = w.unet_forward(25)
    want, want_least, want_tem = _hand_unet_flops(cfg["unet"], 25, 96)
    assert flops == pytest.approx(want, rel=1e-12)
    assert least == pytest.approx(want_least, rel=1e-12)
    assert tem == pytest.approx(want_tem, rel=1e-12)
    assert 2.9e12 * 25 < flops < 3.5e12 * 25  # ~3.2 TFLOP a frame
    assert least > tem > 0


def test_window_work_of_a_job():
    """A job: 25 steps of two UNet halves over the 25-frame clip, one
    conditioning encode, one 25-frame decode."""
    cfg = CONFIG
    w = SVD.Work(cfg, 768)
    shape = Shape("spatial", 26, 1, 25, 25, 25, False, True, True)
    labels = [("s", f"{i:02d}", "000000") for i in range(26)]
    is_cond = [i == 0 for i in range(26)]
    out = SVD.work(cfg, 768, shape, [{"tasks": [(labels, is_cond)], "targets": 25}])
    u, e, d = w.unet_forward(25), w.encode(), w.decode(25)
    assert out["flops"] == pytest.approx(50 * u[0] + e[0] + d[0], rel=1e-12)
    assert out["least_s_by_op"]["attention"] == pytest.approx(50 * u[1] + e[1] + d[1], rel=1e-12)
    assert out["least_s_by_op"]["temporal_attention"] == pytest.approx(50 * u[2], rel=1e-12)


@pytest.fixture
def tiny_svd(tmp_path):
    checkout(tmp_path / "checkout")

    def run(seed=7, **kw):
        return runner.run(CELL, seed, 0.5, kw.pop("trace", False), time.perf_counter(),
                          device="cpu", image_size=64, overrides=TINY,
                          cache=str(tmp_path / "cache"), limits=LIMITS,
                          root=tmp_path / "checkout", **kw)
    return run


def test_tiny_run_is_correct(tiny_svd):
    out = tiny_svd(trace=True)
    res, rep = out["result"], out["report"]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert rep["tasks"] == 1 and rep["latent_steps"] == 12
    assert set(rep["least_s_by_op"]) == {"attention", "temporal_attention"}
    # no device trace on the CPU: the device readers stay silent
    assert "temporal_pct" not in res["metrics"] and "mfu" in res["metrics"]


def _mix_reversed(prog):
    from diffuman4d_torch.models.unet_spatiotemporal import AlphaBlender

    for m in prog.pipeline.unet.modules():
        if isinstance(m, AlphaBlender):
            m.switch = not m.switch


def _taps_reversed(prog):
    with torch.no_grad():
        for m in prog.pipeline.unet.modules():
            if isinstance(m, torch.nn.Conv3d):
                m.weight.copy_(m.weight.flip(2))


def _constant_guidance(prog):
    p = prog.pipeline
    p.guidance = lambda frames: torch.full((frames,), p.sliding.guidance_scale, device=p.device)


@pytest.mark.parametrize("fault", [_mix_reversed, _taps_reversed, _constant_guidance],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_svd, fault):
    out = tiny_svd(fault=fault)
    assert not out["result"]["correct"], out["result"]["checks"]


def test_control_in_float8_is_not_correct(tiny_svd):
    out = tiny_svd(control=True)
    assert out["result"]["correct"], out["result"]["checks"]
    assert not out["control"]["correct"], out["control"]["checks"]


def test_temporal_readers_arithmetic():
    pct = sp.metric_reader("temporal_pct")
    roof = sp.metric_reader("temporal_attn_roofline_pct")
    rec = {"trace": {"busy_s": 20.0, "device_by_op": {"temporal": 8.0,
                                                      "temporal_attention": 0.5}},
           "least_s_by_op": {"attention": 1.0, "temporal_attention": 0.2}}
    assert pct(rec) == pytest.approx(40.0)
    assert roof(rec) == pytest.approx(40.0)
    # a program without the ranges, or a run without a trace, reads nothing
    for r in ({"trace": {"busy_s": 20.0, "device_by_op": {}}, "least_s_by_op": {}},
              {"trace": None}, {}):
        assert pct(r) is None and roof(r) is None
