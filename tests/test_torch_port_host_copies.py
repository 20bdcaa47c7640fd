"""The port keeps its own copies of the JAX package's numpy-only host
modules (window construction, step counts, the dataset, array stacking).
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
