"""The port's quality metrics (``data/metrics.py``, ``data/lpips_vgg.py``)
against the JAX package's: PSNR and SSIM on seeded images, LPIPS(VGG16)
with shared random weights (the pretrained ones are absent,
docs/LPIPS_WEIGHTS.md), and ``evaluate_results`` on one synthetic scene.
CPU, fp32 (the port's SSIM blurs in fp64, the JAX package's in fp32 at
full precision)."""

from __future__ import annotations

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

# fp32 PSNR of the same mean squared error in another summation order;
# SSIM: fp64 against fp32 blurs of [0, 1] images
PSNR_ATOL = 1e-4
SSIM_ATOL = 1e-5
# LPIPS: fp32 VGG16 convs in another summation order (tests/test_lpips_parity.py)
LPIPS_RTOL = 2e-4


def _pair(seed: int, shape=(48, 40, 3), noise: float = 0.1):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + r.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed,noise", [(0, 0.1), (1, 0.01), (2, 0.5)])
def test_psnr_ssim_match_jax(seed, noise):
    from diffuman4d_tpu.data import metrics as jm
    from diffuman4d_torch.data import metrics as pm

    a, b = _pair(seed, noise=noise)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(pm.psnr(ta, tb)), float(jm.psnr(ja, jb)), rtol=0,
                               atol=PSNR_ATOL)
    np.testing.assert_allclose(float(pm.ssim(ta, tb)), float(jm.ssim(ja, jb)), rtol=0,
                               atol=SSIM_ATOL)
    assert float(pm.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-12)


def _random_lpips_weights(seed: int = 0) -> dict:
    """Random VGG16 + LPIPS head weights in the npz schema (activations kept
    in range by He scaling; heads non-negative, as LPIPS's are)."""
    from diffuman4d_torch.data.lpips_vgg import expected_schema

    r = np.random.default_rng(seed)
    w = {}
    for key, shape in expected_schema().items():
        if key.startswith("lin"):
            w[key] = np.abs(r.normal(0, 0.1, shape)).astype(np.float32)
        elif key.endswith("weight"):
            w[key] = r.normal(0, (2.0 / np.prod(shape[1:])) ** 0.5, shape).astype(np.float32)
        else:
            w[key] = r.normal(0, 0.01, shape).astype(np.float32)
    return w


def test_lpips_matches_jax_with_random_weights(tmp_path):
    from diffuman4d_tpu.data.lpips_vgg import lpips_distance as jlpips
    from diffuman4d_torch.data.lpips_vgg import VGG16LPIPS, lpips_distance
    from diffuman4d_torch.data.metrics import LPIPS

    weights = _random_lpips_weights()
    model = VGG16LPIPS.from_weights(weights)
    a, b = _pair(3, shape=(64, 64, 3))
    got, want = lpips_distance(model, a, b), jlpips(weights, a, b)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL, atol=1e-6)
    assert lpips_distance(model, a, a) == 0.0
    # the metric class picks the file up from a path (the npz schema)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **weights)
    metric = LPIPS(str(path))
    assert metric.available
    np.testing.assert_allclose(metric(a, b), want, rtol=LPIPS_RTOL, atol=1e-6)


def test_lpips_refuses_a_wrong_schema():
    from diffuman4d_torch.data.lpips_vgg import VGG16LPIPS

    weights = _random_lpips_weights()
    weights["features.0.weight"] = weights["features.0.weight"][:32]
    with pytest.raises(ValueError, match="features.0.weight"):
        VGG16LPIPS.from_weights(weights)
    del weights["lin4.weight"]
    with pytest.raises(ValueError, match="missing"):
        VGG16LPIPS.from_weights(weights)


def test_lpips_without_weights_is_nan(monkeypatch):
    from diffuman4d_torch.data.metrics import LPIPS

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    metric = LPIPS()
    a, b = _pair(4)
    assert not metric.available and np.isnan(metric(a, b))


def test_evaluate_results_matches_jax(tmp_path, monkeypatch):
    """One synthetic scene: 6 cameras x 2 frames at 64^2, predictions are
    the ground truth with noise, written as JPEGs; two of the cameras are
    inputs and are skipped."""
    from diffuman4d_tpu.data.metrics import evaluate_results as jeval
    from diffuman4d_torch.data.metrics import evaluate_results
    from diffuman4d_torch.data.synthetic import make_synthetic_scene

    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    make_synthetic_scene(str(tmp_path / "data"), "scene0", num_cams=6, num_frames=2,
                         image_size=64)
    r = np.random.default_rng(5)
    gt_dir = tmp_path / "data" / "scene0" / "images"
    for img in sorted(gt_dir.rglob("*.webp")):
        gt = np.asarray(Image.open(img).convert("RGB"), np.float32)
        pred = np.clip(gt + r.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
        out = tmp_path / "port" / "images" / img.parent.name / f"{img.stem}.jpg"
        out.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(pred).save(out, quality=95)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")

    kw = dict(data_dir=str(tmp_path / "data"), scene_label="scene0",
              input_spa_labels=["00", "03"], canvas_size=64)
    got = evaluate_results(output_dir=str(tmp_path / "port"), **kw)
    want = jeval(output_dir=str(tmp_path / "jax"), **kw)
    written = json.loads((tmp_path / "port" / "metrics.json").read_text())
    assert written["mean"] == got["mean"]
    assert [(v["key"], v["psnr"]) for v in written["values"]] == [
        (v["key"], v["psnr"]) for v in got["values"]]
    assert [v["key"] for v in got["values"]] == [v["key"] for v in want["values"]]
    assert len(got["values"]) == 8  # 4 target cameras x 2 frames
    for g, w in zip(got["values"], want["values"]):
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0, atol=PSNR_ATOL)
        np.testing.assert_allclose(g["ssim"], w["ssim"], rtol=0, atol=SSIM_ATOL)
        assert np.isnan(g["lpips"]) and np.isnan(w["lpips"])
    assert got["mean"]["lpips"] is None and want["mean"]["lpips"] is None
    assert got["mean"]["psnr"] == pytest.approx(want["mean"]["psnr"], abs=1e-3)
    assert got["mean"]["ssim"] == pytest.approx(want["mean"]["ssim"], abs=1e-3)
