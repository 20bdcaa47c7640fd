"""The port's training loop under a mesh of gloo CPU ranks: its
checkpoints hold whole tensors, so that a state written on 2 x 2 resumes on
one card (the single-card loop) and one written on one card resumes on
2 x 2, each equal to four uninterrupted steps; and the refusals
(``tests/torch_port_dist_worker.py`` holds the rank functions, and
``tests/test_torch_port_dp_meshes.py`` the steps on every mesh shape). The
model is the loop tests' two-stage UNet at toy widths, fp32, with
``min_size=2**8`` so that the model axis splits the larger weights."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

TIMEOUT_S = 180.0
B, L, LAT = 2, 4, 8
MIN_SIZE = 2**8
# the mesh-shape tolerance: 1e-5 of the largest entry of the state's part
# (masters, a moment, the shadow). Per tensor it would be tighter than fp32
# summation allows where a tensor is itself a cancelling sum: the second
# moment of the pose encoder's one-element scale is ~1e-11 where others are
# ~1e-4, and splitting its gradient over two ranks moves it by 1.7e-5 of
# itself.
REL = 1e-5


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    top = max((np.abs(np.asarray(w)).max() for w in want.values()), default=0.0)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert np.abs(g - w).max() <= REL * top, f"{what}: {k}"


def _state0() -> dict:
    unet, _ = worker.small_models()
    return {k: v.detach().numpy().copy() for k, v in unet.state_dict().items()}


def _inputs() -> tuple:
    r = np.random.default_rng(7)
    batches, draws = [], []
    for _ in range(2):
        is_cond = np.zeros((B, L), bool)
        is_cond[:, : L // 2] = True
        batches.append({
            "latents_x0": r.standard_normal((B, L, LAT, LAT, 4)).astype(np.float32),
            "plucker": r.standard_normal((B, L, LAT, LAT, 6)).astype(np.float32),
            "skeletons": (r.standard_normal((B, L, LAT * 8, LAT * 8, 3)) * 0.5).astype(
                np.float32),
            "is_cond": is_cond})
        draws.append((r.integers(0, 1000, (B,)).astype(np.int64),
                      r.standard_normal((B, L, LAT, LAT, 4)).astype(np.float32)))
    return batches, draws


def _load(path) -> dict:
    return torch.load(path, weights_only=True)


def _assert_states_close(got: dict, want: dict, what: str) -> None:
    assert got["step"] == want["step"] and got["opt_state"]["count"] == want["opt_state"]["count"]
    _close({k: v.numpy() for k, v in got["params"].items()},
           {k: v.numpy() for k, v in want["params"].items()}, f"{what} params")
    for slot, tree in want["opt_state"].items():
        if slot != "count":
            _close({k: v.numpy() for k, v in got["opt_state"][slot].items()},
                   {k: v.numpy() for k, v in tree.items()}, f"{what} {slot}")
    _close({k: v.numpy() for k, v in got["ema_params"].items()},
           {k: v.numpy() for k, v in want["ema_params"].items()}, f"{what} ema")


@pytest.mark.parametrize("ema_host", [False, True], ids=["device_ema", "host_ema"])
def test_loop_resumes_across_mesh_shapes(tmp_path, ema_host):
    """Four uninterrupted steps of the single-card loop against (a) two
    steps on 2 x 2, resumed by the single-card loop, and (b) two steps of
    the single-card loop, resumed on 2 x 2. The 2 x 2 runs write whole
    tensors (rank 0), which the single-card loop reads unchanged."""
    scene = worker.scene_dir(tmp_path)
    kw = dict(learning_rate=1e-3, ema_decay=0.9, ema_host=ema_host)
    full = str(tmp_path / "full")
    logs = worker.loop_run(0, 1, None, 1, scene, full, 4, kw)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    pdist.spawn_cpu_ranks(worker.loop_run, 4, (2, 2, scene, a, 2, kw, MIN_SIZE),
                          timeout_s=TIMEOUT_S)
    worker.loop_run(0, 1, None, 1, scene, a, 4, kw)
    worker.loop_run(0, 1, None, 1, scene, b, 2, kw)
    ranks = pdist.spawn_cpu_ranks(worker.loop_run, 4, (2, 2, scene, b, 4, kw, MIN_SIZE),
                                  timeout_s=TIMEOUT_S)
    assert [r["step"] for r in logs] == [1, 2, 3, 4]
    assert [r["step"] for r in ranks[0]] == [1, 2, 3, 4] and ranks[1:] == [[], [], []]
    want = _load(tmp_path / "full" / "state_0000004.pt")
    for run in ("a", "b"):
        files = sorted(p.name for p in (tmp_path / run).iterdir())
        assert files == ["ckpt_0000002.pt", "ckpt_0000004.pt", "metrics.jsonl",
                         "state_0000002.pt", "state_0000004.pt"], run
        _assert_states_close(_load(tmp_path / run / "state_0000004.pt"), want, run)
        # the loss of every step agrees with the uninterrupted run's
        recs = [json.loads(x)
                for x in (tmp_path / run / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs] == [1, 2, 3, 4]
        for r, w in zip(recs, logs):
            assert abs(r["loss"] - w["loss"]) <= REL * w["loss"], (run, r["step"])
    # the 2 x 2 checkpoint holds whole tensors in the diffusers names
    ckpt = _load(tmp_path / "a" / "ckpt_0000002.pt")["unet"]
    assert {k: tuple(v.shape) for k, v in ckpt.items()} == {
        k: tuple(v.shape) for k, v in _load(tmp_path / "full" / "ckpt_0000002.pt")["unet"].items()}


def test_refusals():
    """A batch the data axis does not divide, draws of the wrong size."""
    from diffuman4d_torch.parallel.mesh import Mesh
    from diffuman4d_torch.training.trainer import data_rows

    assert data_rows(None, 3) == slice(0, 3)
    with pytest.raises(ValueError, match="does not divide"):
        data_rows(Mesh(2, 1), 3)

    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training import trainer as pt

    unet, _ = worker.small_models()
    batches, draws = _inputs()
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    t, eps = (torch.from_numpy(x) for x in draws[0])
    cfg = pt.TrainConfig()
    state = pt.create_train_state(unet, cfg, make_mesh())
    step = pt.make_train_step(unet, Scheduler(SchedulerConfig()), cfg, "spatial", make_mesh())
    with pytest.raises(ValueError, match="rows for 1 data rows of 2"):
        step(state, batch, t=t[:1], eps=eps[:1])
    with pytest.raises(ValueError, match="a generator, or t and eps"):
        step(state, batch)
