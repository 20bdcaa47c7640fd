"""The port's preprocessing stages and full-resolution rays against the JAX
package's, on the CPU: the numpy-only modules (``skeleton_data``,
``keypoints``, ``triangulate``, ``draw_skeleton``, ``dna_extract``,
``download``, ``pipeline``) compute the same bytes on the fakes of
``tests/test_preprocess.py``, ``test_keypoint_driver.py`` and
``test_extraction.py`` (stub networks, a hand-built capture file, parquet
shards; no model file, no network); the visual hull's torch carving keeps
the voxels JAX's ``_carve_chunk`` keeps; ``BiRefNetMatting`` raises JAX's
error without a checkpoint and runs a fake model as JAX's does;
``get_rays`` / ``calc_plucker_embeds`` agree within 1e-5."""

from __future__ import annotations

import inspect
import io
import json
import os
import os.path as osp
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_keypoint_driver import StubPose
from tests.test_preprocess import _ring_cameras
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


def _tree(root: Path) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _equal(a, b) -> None:
    """Equal values of any nesting of tuples, lists, dicts and arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ numpy copies
def test_triangulation_and_skeleton_tables_equal():
    from diffuman4d_tpu.preprocess import skeleton_data as jsd, triangulate as jtr
    from diffuman4d_torch.preprocess import skeleton_data as psd, triangulate as ptr

    _equal(psd.coco_wholebody_skeleton(), jsd.coco_wholebody_skeleton())
    _equal(psd.coco_wholebody_keypoint_colors(), jsd.coco_wholebody_keypoint_colors())
    rng = np.random.default_rng(0)
    Ks, Ts = _ring_cameras(8)
    kp3d = rng.uniform(-0.5, 0.5, (133, 3))
    kp3d[5] = jtr.INVALID
    _equal(ptr.project_points(kp3d, Ks, Ts), jtr.project_points(kp3d, Ks, Ts))
    kp2d, _ = jtr.project_points(kp3d, Ks, Ts)
    kp2d = kp2d + rng.normal(0, 0.3, kp2d.shape)
    scores = rng.uniform(0.3, 1.0, (8, 133))
    _equal(ptr.triangulate_points(Ks, Ts, kp2d, scores),
           jtr.triangulate_points(Ks, Ts, kp2d, scores))
    _equal(ptr.triangulate_one_point(Ks, Ts, kp2d[:, 0], scores[:, 0]),
           jtr.triangulate_one_point(Ks, Ts, kp2d[:, 0], scores[:, 0]))
    s = rng.uniform(0, 1, 133)
    _equal(ptr.damp_finger_scores(s), jtr.damp_finger_scores(s))
    _equal(ptr.face_view_scores(kp3d, Ts), jtr.face_view_scores(kp3d, Ts))


def test_keypoint_math_and_driver_equal(tmp_path):
    from diffuman4d_tpu.preprocess import keypoints as jkp
    from diffuman4d_torch.preprocess import keypoints as pkp

    rng = np.random.default_rng(0)
    hm = rng.uniform(0, 1, (5, 64, 48)).astype(np.float32)
    for fn in ("get_heatmap_maximum",):
        _equal(getattr(pkp, fn)(hm), getattr(jkp, fn)(hm))
    _equal(pkp.udp_decode(hm, input_size=(192, 256), heatmap_size=(48, 64)),
           jkp.udp_decode(hm, input_size=(192, 256), heatmap_size=(48, 64)))
    args = (np.array([100.0, 50.0]), np.array([200.0, 100.0]), 10.0, (64, 32))
    _equal(pkp.udp_warp_matrix(*args), jkp.udp_warp_matrix(*args))
    boxes = np.concatenate([rng.uniform(0, 50, (20, 2)), rng.uniform(50, 100, (20, 2)),
                            rng.uniform(0, 1, (20, 1))], 1).astype(np.float32)
    _equal(pkp.nms_boxes(boxes, 0.3), jkp.nms_boxes(boxes, 0.3))
    imgs = [rng.uniform(0, 1, (200, 160, 3)).astype(np.float32) for _ in range(3)]
    bbs = [(20.0, 30.0, 120.0, 180.0), None, (10.0, 10.0, 150.0, 190.0)]
    kw = dict(batch_size=2, heatmap_size=StubPose.heatmap_size)
    _equal(pkp.predict_keypoints_batch(imgs, bbs, StubPose(), **kw),
           jkp.predict_keypoints_batch(imgs, bbs, StubPose(), **kw))
    mask = np.zeros((120, 100), bool)
    mask[20:100, 25:80] = True
    _equal(pkp.MaskDetector()(imgs[0], mask), jkp.MaskDetector()(imgs[0], mask))

    # the directory driver: images + masks -> JSON files, byte for byte
    images, fmasks = tmp_path / "images", tmp_path / "fmasks"
    for cam in ("00", "01"):
        (images / cam).mkdir(parents=True)
        (fmasks / cam).mkdir(parents=True)
        for frame in ("000000", "000001"):
            Image.fromarray(rng.uniform(0, 255, (120, 100, 3)).astype(np.uint8)).save(
                images / cam / f"{frame}.webp")
            Image.fromarray(mask.astype(np.uint8) * 255).save(fmasks / cam / f"{frame}.png")
    for name, mod in (("jax", jkp), ("port", pkp)):
        assert mod.predict_keypoints_dir(str(images), str(tmp_path / name), StubPose(),
                                         fmasks_dir=str(fmasks), batch_size=4) == 4
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_torchscript_models_equal_and_default_to_the_card(tmp_path):
    from diffuman4d_tpu.preprocess import keypoints as jkp
    from diffuman4d_torch.preprocess import keypoints as pkp

    class Det(torch.nn.Module):
        def forward(self, x):
            boxes = torch.tensor([[5.0, 5.0, 90.0, 95.0, 0.95], [0.0, 0.0, 99.0, 99.0, 0.2],
                                  [6.0, 6.0, 91.0, 96.0, 0.90]])
            return boxes, torch.tensor([0, 0, 0])

    class Pose(torch.nn.Module):
        def forward(self, x):
            return torch.nn.functional.avg_pool2d(x, 4)[:, :2] * 3.0

    torch.jit.script(Det()).save(str(tmp_path / "det.pt"))
    torch.jit.script(Pose()).save(str(tmp_path / "pose.pt"))
    img = np.random.default_rng(0).uniform(0, 1, (100, 100, 3)).astype(np.float32)
    _equal(pkp.TorchscriptDetector(str(tmp_path / "det.pt"), device="cpu")(img),
           jkp.TorchscriptDetector(str(tmp_path / "det.pt"))(img))
    crops = np.random.default_rng(1).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    _equal(pkp.TorchscriptPoseModel(str(tmp_path / "pose.pt"), device="cpu")(crops),
           jkp.TorchscriptPoseModel(str(tmp_path / "pose.pt"))(crops))
    for cls in ("TorchscriptDetector", "TorchscriptPoseModel"):
        assert inspect.signature(getattr(pkp, cls)).parameters["device"].default == "cuda"
        with pytest.raises(FileNotFoundError) as got:
            getattr(pkp, cls)(str(tmp_path / "missing.pt"))
        with pytest.raises(FileNotFoundError) as want:
            getattr(jkp, cls)(str(tmp_path / "missing.pt"))
        assert str(got.value) == str(want.value)


def test_draw_skeleton_equal(tmp_path):
    from diffuman4d_tpu.preprocess import draw_skeleton as jds
    from diffuman4d_torch.preprocess import draw_skeleton as pds

    rng = np.random.default_rng(0)
    data = {"instance_info": [{"keypoints": rng.uniform(20, 44, (133, 2)).tolist(),
                               "keypoint_scores": rng.uniform(0.3, 1.0, 133).tolist(),
                               "keypoint_depths": rng.uniform(1, 2, 133).tolist()}]}
    src = tmp_path / "kp" / "00" / "000000.json"
    src.parent.mkdir(parents=True)
    src.write_text(json.dumps(data))
    for name, mod in (("jax", jds), ("port", pds)):
        mod.draw_skeletons(str(tmp_path / "kp"), str(tmp_path / name),
                           kp2d_canvas_shape=(64, 64), out_kpmap_shape=(64, 64))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want and len(want) == 1
    assert np.asarray(Image.open(io.BytesIO(next(iter(got.values()))))).max() > 100


def test_dna_extraction_and_parquet_expansion_equal(tmp_path):
    from diffuman4d_tpu.preprocess import dna_extract as jdx, download as jdl
    from diffuman4d_torch.preprocess import dna_extract as pdx, download as pdl
    from tests.test_extraction import TestParquetExpansion, TestSMCExtraction

    ccm = np.random.default_rng(0).uniform(-0.01, 1.0, (3, 3))
    img = np.random.default_rng(1).uniform(0, 255, (8, 8, 3)).astype(np.float32)
    _equal(pdx.apply_ccm(img, ccm), jdx.apply_ccm(img, ccm))
    K = np.array([[2400.0, 0, 1240], [0, 2400, 1020], [0, 0, 1]])
    for cam_id in (5, 50):
        _equal(pdx.unified_intrinsics(K, 2048, 2448, cam_id=cam_id, image_size=1024),
               jdx.unified_intrinsics(K, 2048, 2448, cam_id=cam_id, image_size=1024))
    smc = str(tmp_path / "cap.smc")
    TestSMCExtraction()._make_smc(smc)
    assert pdx.extract_scene(smc, str(tmp_path / "port"), image_size=256) == 4
    assert jdx.extract_scene(smc, str(tmp_path / "jax"), image_size=256) == 4
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")

    # the parquet expansion, on the shards tests/test_extraction.py writes
    TestParquetExpansion().test_extract_parquet_tree(tmp_path / "pq")
    shards = str(tmp_path / "pq" / "shards")
    assert (pdl.extract_parquet_tree(shards, str(tmp_path / "pq_port"))
            == jdl.extract_parquet_tree(shards, str(tmp_path / "pq_jax")) == 4)
    assert _tree(tmp_path / "pq_port") == _tree(tmp_path / "pq_jax")


# ------------------------------------------------------------- background
def test_birefnet_raises_the_jax_error_and_runs_a_fake_model(tmp_path, monkeypatch):
    import transformers

    from diffuman4d_tpu.preprocess import background as jbg
    from diffuman4d_torch.preprocess import background as pbg

    with pytest.raises(FileNotFoundError, match="egress") as got:
        pbg.BiRefNetMatting("/nonexistent/birefnet")
    with pytest.raises(FileNotFoundError) as want:
        jbg.BiRefNetMatting("/nonexistent/birefnet")
    assert str(got.value) == str(want.value)
    assert inspect.signature(pbg.BiRefNetMatting).parameters["device"].default == "cuda"

    class Fake(torch.nn.Module):
        """BiRefNet's output contract: a list of logits, the last full-size."""

        def __init__(self):
            super().__init__()
            self.mix = torch.nn.Conv2d(3, 1, 3, padding=1)
            torch.nn.init.normal_(self.mix.weight, generator=torch.Generator().manual_seed(0))
            torch.nn.init.zeros_(self.mix.bias)

        def forward(self, x):
            return [x[:, :1], self.mix(x)]

    loads = []

    def from_pretrained(path, trust_remote_code=False):
        loads.append((path, trust_remote_code))
        return Fake()

    monkeypatch.setattr(transformers.AutoModelForImageSegmentation, "from_pretrained",
                        from_pretrained)
    img = np.random.default_rng(0).uniform(0, 1, (40, 56, 3)).astype(np.float32)
    got = pbg.BiRefNetMatting(str(tmp_path), image_size=64, device="cpu")(img)
    want = jbg.BiRefNetMatting(str(tmp_path), image_size=64)(img)
    assert got.shape == (40, 56) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert loads == [(str(tmp_path), True)] * 2


# ------------------------------------------------------------ visual hull
def _random_projections(rng, n=6, size=96):
    Ks, w2cs = _ring_cameras(n, radius=2.5 + rng.uniform(0, 1), f=150.0 + rng.uniform(0, 50),
                             size=size)
    w2cs = w2cs.copy()
    w2cs[:, :3, 3] += rng.normal(0, 0.05, (n, 3))
    return Ks, w2cs


def test_carve_chunk_keeps_the_voxels_jax_keeps():
    """Random sphere masks under jittered ring cameras, every voxel of a
    grid that straddles the image borders: the kept masks are equal, with
    ``min_views`` 0 and 4 (0 of 3 x 2 x 64,000 voxels differ here; a voxel
    whose projection lands on a .5 boundary could round either way after
    the fp32 divide)."""
    from diffuman4d_tpu.preprocess import visual_hull as jvh
    from diffuman4d_torch.preprocess import visual_hull as pvh

    rng = np.random.default_rng(0)
    for trial in range(3):
        Ks, w2cs = _random_projections(rng)
        P = pvh.make_projection_matrix(Ks, w2cs).astype(np.float32)
        np.testing.assert_array_equal(P, jvh.make_projection_matrix(Ks, w2cs).astype(np.float32))
        yy, xx = np.mgrid[0:96, 0:96]
        masks = np.stack([(xx - 48 - rng.normal(0, 4)) ** 2 + (yy - 48) ** 2
                          <= rng.uniform(15, 30) ** 2 for _ in range(len(P))])
        pts = rng.uniform(-1.2, 1.2, (64_000, 3)).astype(np.float32)
        for min_views in (0, 4):
            want = np.asarray(jvh._carve_chunk(jnp.asarray(pts), jnp.asarray(P),
                                               jnp.asarray(masks), min_views))
            got = pvh._carve_chunk(torch.from_numpy(pts), torch.from_numpy(P),
                                   torch.from_numpy(masks), min_views).numpy()
            assert want.any() and not want.all()
            np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_pipeline_cli_writes_the_jax_bytes(tmp_path):
    """``python -m diffuman4d_torch.preprocess.pipeline <scene> --actions ...
    --device cpu`` on the synthetic scene (masks made anew by chroma key,
    2D keypoints projected from a random skeleton) against the JAX
    pipeline on a copy: every file the stages write is the same, the
    carved hulls included."""
    from diffuman4d_tpu.preprocess import pipeline as jpipe, triangulate as jtr
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.data.cameras import parse_cameras
    from diffuman4d_torch.preprocess import pipeline as ppipe

    port = tmp_path / "port"
    make_synthetic_scene(str(port), "scene0", num_cams=6, num_frames=2, image_size=64)
    port = port / "scene0"
    shutil.rmtree(port / "fmasks")
    cams = parse_cameras(str(port / "transforms.json"), coord_system="opencv",
                         normalize_scene=False)
    labels = sorted(os.listdir(port / "images"))
    Ks = np.stack([cams[c].K for c in labels])
    Ts = np.stack([np.linalg.inv(cams[c].pose) for c in labels])
    rng = np.random.default_rng(0)
    center = np.mean([cams[c].pose[:3, 3] for c in labels], axis=0)
    for frame in ("000000", "000001"):
        kp3d = center + rng.uniform(-0.3, 0.3, (133, 3))
        kp2d, depth = jtr.project_points(kp3d, Ks, Ts)
        for i, cam in enumerate(labels):
            jtr.write_kp2d(str(port / "poses_sapiens" / cam / f"{frame}.json"), kp2d[i],
                           kp_score=rng.uniform(0.7, 1.0, 133))
    jax_scene = tmp_path / "jax" / "scene0"
    shutil.copytree(port, jax_scene)
    actions = "remove_background,carve_vhull,triangulate_skeleton,draw_skeleton"
    assert ppipe.main([str(port), "--actions", actions, "--image-size", "64",
                       "--device", "cpu"]) == 0
    assert jpipe.main([str(jax_scene), "--actions", actions, "--image-size", "64"]) == 0
    got, want = _tree(port), _tree(jax_scene)
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []
    for stage in ("fmasks", "images_alpha", "surfs", "poses_3d", "poses_2d", "skeletons"):
        assert any(k.startswith(stage + "/") for k in want), stage
    assert "sparse_pcd.ply" in want and b"element vertex 0\n" not in want["sparse_pcd.ply"]
    with pytest.raises(ValueError, match="sapiens-checkpoint"):
        ppipe.run_preprocess(str(port), ["predict_keypoints"], device="cpu")


# ------------------------------------------------------------------- rays
def test_full_resolution_rays_match_jax():
    from diffuman4d_tpu.data import rays as jr
    from diffuman4d_torch.data import rays as pr
    from tests.test_geometry import _random_camera

    rng = np.random.default_rng(0)
    Ks, poses = map(np.stack, zip(*[_random_camera(rng, h=48, w=40) for _ in range(3)]))
    want = np.asarray(jr.calc_plucker_embeds(48, 40, jnp.asarray(Ks), jnp.asarray(poses)))
    got = pr.calc_plucker_embeds(48, 40, torch.from_numpy(Ks), torch.from_numpy(poses))
    assert got.shape == (3, 48, 40, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ext = np.linalg.inv(poses)
    R, T = ext[:, :3, :3], ext[:, :3, 3:]
    jo, jd = jr.get_rays(48, 40, jnp.asarray(Ks), jnp.asarray(R), jnp.asarray(T))
    po, pd = pr.get_rays(48, 40, *(torch.from_numpy(x) for x in (Ks, R, T)))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    # the low-resolution form is the full one bilinearly resized
    low = pr.calc_plucker_embeds_lowres(48, 40, torch.from_numpy(Ks), torch.from_numpy(poses),
                                        12, 10)
    ref = torch.nn.functional.interpolate(got.permute(0, 3, 1, 2), size=(12, 10),
                                          mode="bilinear").permute(0, 2, 3, 1)
    torch.testing.assert_close(low, ref, rtol=0, atol=1e-5)
