"""The port keeps its own copies of the JAX package's numpy-only host
modules (window construction, step counts, the dataset, array stacking,
the config presets, background matting and the nerfstudio export).
Each copied function that computes something is held bit-equal to the
original here. The JAX package's ``io/native.py`` looks its decoder library
up without a lock: loader threads that ask while the first is still loading
it take the PIL path for that frame, so a process's first ``get_item`` can
return other pixels than later ones. The port's copy takes a lock; here the
JAX module's lookup is settled on the main thread before any load."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest


@pytest.mark.parametrize("domain,n_targets,n_inputs,window,stride,shift,bidir", [
    ("spatial", 12, 4, 12, 1, 0, False), ("spatial", 44, 4, 12, 4, 2, True),
    ("temporal", 24, 24, 12, 6, 0, False), ("temporal", 8, 8, 4, 2, 1, True)])
def test_build_windows_equal(domain, n_targets, n_inputs, window, stride, shift, bidir):
    from diffuman4d_tpu.sampling.windows import build_windows as want
    from diffuman4d_torch.sampling.windows import build_windows as got

    targets = np.arange(n_inputs, n_inputs + n_targets)
    inputs = np.arange(n_inputs)
    args = (targets, inputs, domain, window, stride, shift, bidir)
    np.testing.assert_array_equal(got(*args), want(*args))


@pytest.mark.parametrize("args", [(12, 1, 1, False, 1), (12, 4, 1, True, 3), (12, 6, 2, False, 3),
                                  (8, 2, 3, True, 2)])
def test_step_counts_equal(args):
    from diffuman4d_tpu.sampling.windows import step_counts as want
    from diffuman4d_torch.sampling.windows import step_counts as got

    assert got(*args) == want(*args)


def test_fast_stack_equal():
    from diffuman4d_tpu.utils.arrays import fast_stack as want
    from diffuman4d_torch.utils.arrays import fast_stack as got

    r = np.random.default_rng(0)
    arrays = [r.standard_normal((5, 7, 3)).astype(np.float16) for _ in range(4)]
    np.testing.assert_array_equal(got(arrays), want(arrays))
    np.testing.assert_array_equal(got(arrays, np.float32), np.stack(arrays).astype(np.float32))
    assert got(arrays, np.float32).dtype == np.float32


def test_dataset_get_item_and_synthetic_scene_equal(tmp_path):
    from diffuman4d_tpu.data import dataset as jds, synthetic as jsyn
    from diffuman4d_tpu.io import native as jnative
    from diffuman4d_torch.data import dataset as pds, synthetic as psyn
    from diffuman4d_torch.io import native as pnative

    assert jnative.available() == pnative.available()  # settles the JAX module's lookup

    jsyn.make_synthetic_scene(str(tmp_path / "a"), "scene0", num_cams=6, num_frames=2,
                              image_size=64)
    psyn.make_synthetic_scene(str(tmp_path / "b"), "scene0", num_cams=6, num_frames=2,
                              image_size=64)
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*")
                   if p.is_file())
    assert files and files == sorted(p.relative_to(tmp_path / "b")
                                     for p in (tmp_path / "b").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f

    kw = dict(data_dir=str(tmp_path / "a"), scene_label="scene0", height=64, width=64)
    want_ds, got_ds = jds.SpaTemDataset(**kw), pds.SpaTemDataset(**kw)
    item = dict(scene_label="scene0", spa_labels=[f"{i:02d}" for i in range(6)],
                tem_labels=["000000"], input_spa_labels=["00", "03"])
    for req in (item, dict(item, spa_labels=["02"], tem_labels=["000000", "000001"])):
        want, got = want_ds.get_item(**req), got_ds.get_item(**req)
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert a == b, f.name


# override lists for the presets: every preset, dotted keys of each type,
# labels with underscores (taken raw by str fields), flow lists, nulls
OVERRIDES = [
    [],
    ["exp=demo_3d"],
    ["exp=demo_4d", "data.scene_label=0326_07", "sampler.seed=3"],
    ["exp=demo_4d_tiny", "sampler=sliding_premium", "sampler.guidance_scale=2.0"],
    ["exp=demo_3d", "data=fdvai", "data.height=512", "data.width=512",
     "data.has_gt_target=false"],
    ["sampler=sliding_low_mem", "sampler.spa_labels=[1,2,3]", "sampler.tem_label_range=null",
     "sampler.split_cfg_domains=[spatial, temporal]", "model.dtype=fp32",
     "model.param_dtype=fp32", "model.attn_implementation=xla", "model.arch=tiny"],
    ["data=dna_rendering", "sampler.input_spa_labels=[0,3]", "sampler.window_size=4",
     "sampler.bidirectional=true", "evaluating=yes", "to_nerfstudio=off",
     "sampler.output_dir=/tmp/out_${exp_name}/${scene_label}", "exp_name=run_1"],
    ["sampler=sliding_fast", "sampler.num_denoising_steps=0x3", "sampler.sliding_shift=1_0",
     "sampler.spa_label_range=[0, 48, 2]", "sampler.save_debug_grids=False"],
]


def test_presets_equal():
    from diffuman4d_tpu.configs import presets as want
    from diffuman4d_torch.configs import presets as got

    assert got.DATA_PRESETS == want.DATA_PRESETS
    assert got.SAMPLER_PRESETS == want.SAMPLER_PRESETS
    assert got.EXP_PRESETS == want.EXP_PRESETS
    for overrides in OVERRIDES:
        a, b = want.build_config(overrides), got.build_config(overrides)
        assert dataclasses.asdict(b) == dataclasses.asdict(a), overrides
        assert got.config_tree(b) == want.config_tree(a)
    for bad in (["nokey=1"], ["exp=nope"], ["sampler=nope"], ["data.nokey=1"], ["novalue"]):
        with pytest.raises((KeyError, ValueError)):
            want.build_config(bad)
        with pytest.raises((KeyError, ValueError)):
            got.build_config(bad)


# YAML corpus for the port's own override parser: what the JAX package's
# parse_value (yaml.safe_load) returns
VALUES = ["0326_07", "0811_06", "[0,48,1]", "[0, 48, 1]", "[ 1 , 2 ]", "[]", "[1,]",
          "[[1,2],[3]]", "[spatial, temporal]", "['a', \"b\"]", "true", "false", "True",
          "FALSE", "yes", "No", "on", "off", "null", "Null", "~", "", "None", "2.0", "1.",
          ".5", "-.5", "1.5e-3", "2.0e+3", "3.0E-2", "1e5", ".inf", "-.inf", "-3", "+7", "0",
          "00", "017", "08", "0x1f", "0o17", "0b101", "1_000", "1:20", "1:20.5", "abc", "a b",
          "bf16", "./data/x", "/tmp/a-b_c", "'0326_07'", "'it''s'", "\"x\\ty\""]


@pytest.mark.parametrize("text", VALUES)
def test_parse_value_equals_yaml(text):
    from diffuman4d_tpu.configs.presets import parse_value as want
    from diffuman4d_torch.configs.presets import parse_value as got

    a, b = want(text), got(text)
    assert type(b) is type(a)
    if isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert b == a
    if isinstance(a, list):
        assert [type(x) for x in b] == [type(x) for x in a]


@pytest.mark.parametrize("text", ["a: 1", "{a: 1}", "- 1", "&anchor 1", "!!str 1", "2024-01-01",
                                  "x #comment", "[1,,2]", "[1, 2"])
def test_parse_value_refuses_what_it_does_not_read(text):
    from diffuman4d_torch.configs.presets import parse_value

    with pytest.raises(ValueError):
        parse_value(text)


def _matting_images(root, seed: int = 0):
    """A few RGB frames under images/{cam}/{frame}.jpg: a grey border and a
    coloured blob, with noise."""
    from PIL import Image

    r = np.random.default_rng(seed)
    for cam in ("00", "01", "02"):
        for frame in ("000000", "000001"):
            img = np.full((40, 48, 3), 110.0) + r.normal(0, 6, (40, 48, 3))
            img[10:30, 12:36] = r.uniform(0, 255, 3)
            path = root / "images" / cam / f"{frame}.jpg"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=95)


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_background_matting_equal(tmp_path):
    from diffuman4d_tpu.preprocess import background as want
    from diffuman4d_torch.preprocess import background as got

    r = np.random.default_rng(1)
    image = r.uniform(0, 1, (32, 24, 3)).astype(np.float32)
    image[8:20, 6:18] = 0.9
    for threshold in (0.12, 0.3):
        np.testing.assert_array_equal(got.ChromaKeyMatting(threshold)(image),
                                      want.ChromaKeyMatting(threshold)(image))
    _matting_images(tmp_path / "a")
    _matting_images(tmp_path / "b")
    for mod, root in ((want, tmp_path / "a"), (got, tmp_path / "b")):
        n = mod.remove_background(str(root / "images"), str(root / "fmasks"),
                                  out_alpha_dir=str(root / "alpha"))
        assert n == 6
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")
    assert len(_tree(tmp_path / "a")) == 18


@pytest.mark.parametrize("matting", [None, False])
def test_nerfstudio_export_equal(tmp_path, matting):
    from diffuman4d_tpu.data.synthetic import make_synthetic_scene
    from diffuman4d_tpu.io.nerfstudio import export_to_nerfstudio as want
    from diffuman4d_torch.io.nerfstudio import export_to_nerfstudio as got

    make_synthetic_scene(str(tmp_path / "data"), "scene0", num_cams=3, num_frames=2,
                         image_size=48)
    scene = tmp_path / "data" / "scene0"
    (scene / "sparse_pcd.ply").write_bytes(b"ply\n")
    for out in ("a", "b"):
        _matting_images(tmp_path / out)
    want(str(scene), str(tmp_path / "a"), ["00"], matting=matting)
    got(str(scene), str(tmp_path / "b"), ["00"], matting=matting)
    tree = _tree(tmp_path / "a")
    assert tree == _tree(tmp_path / "b")
    assert {"transforms.json", "transforms_input.json", "export_manifest.json",
            "sparse_pcd.ply"} <= set(tree)
    assert any(k.startswith("images_alpha/") for k in tree) == (matting is None)
