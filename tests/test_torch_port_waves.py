"""Task waves of the port's sampler (``SlidingIterativeSampler
.execute_tasks_parallel`` through ``SamplingRunner``) on gloo CPU ranks,
against the port's own serial run (the assertions of
``tests/test_multiprocess_sampling.py``: the grid, the timestep indices and
the image set). The grid is demo_4d's schedule on a tiny scene, two rounds
(spatial, then temporal with split CFG); see
``tests/torch_port_dist_worker.py``. Every rank computes its tasks exactly
as the serial path does, so on the data axis the grid-state file, the
multistep history and the JPEGs are byte-equal; a model axis changes the
attention's summation order, within 1e-5 as in ``tests/test_cp_unet.py``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- an autouse fixture

TIMEOUT_S = 120.0
CP_ATOL = 1e-5


def _jpegs(root) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(Path(root).rglob("images/*/*.jpg"))}


def _state(out) -> bytes:
    return (Path(out) / "state" / "grid_state.d4d").read_bytes()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return worker.scene_dir(tmp_path_factory.mktemp("waves"))


@pytest.fixture(scope="module")
def serial(scene, tmp_path_factory):
    """The serial runs, one per scheduler kind, made on first use."""
    runs = {}

    def get(kind: str) -> dict:
        if kind not in runs:
            out = tmp_path_factory.mktemp(f"serial_{kind}")
            s = worker.build_sampler(scene, str(out), kind=kind)
            s.execute_tasks()
            runs[kind] = {**worker.grid_of(s), "out": out}
        return runs[kind]

    return get


def _waves(scene, out, world, data, model, **kw) -> list[dict]:
    return pdist.spawn_cpu_ranks(worker.run_waves, world, (scene, str(out), data, model, kw),
                                 timeout_s=TIMEOUT_S)


def _assert_equal_runs(ref: dict, ranks: list[dict], out) -> None:
    for r in ranks:
        assert set(r) >= set(ref) - {"out", "tasks_run"}
        for k in ref:
            if k.startswith(("latents", "aux_", "t_idx")):
                np.testing.assert_array_equal(r[k], ref[k], err_msg=k)
    assert _state(out) == _state(ref["out"])
    assert _jpegs(out) == _jpegs(ref["out"])


@pytest.mark.parametrize("kind", ["ddim", "dpm++"])
def test_two_rank_waves_equal_serial(scene, serial, tmp_path, kind):
    """Waves of 2 over 4-task rounds; with DPM++ the multistep history goes
    through the waves and the state too."""
    ref = serial(kind)
    ranks = _waves(scene, tmp_path, 2, 2, 1, kind=kind)
    _assert_equal_runs(ref, ranks, tmp_path)
    assert len(_jpegs(tmp_path)) == 24  # 6 cameras x 4 frames
    if kind == "dpm++":
        assert ref["aux_has_prev"].any()
    assert [r["tasks_run"] for r in ranks] == [8, 8]


def test_odd_task_count_pads_the_last_wave(scene, serial, tmp_path):
    """Waves of 3 over 4-task rounds: the second wave is the round's last
    task and two copies of it, which write nothing twice."""
    ranks = _waves(scene, tmp_path, 3, 3, 1)
    _assert_equal_runs(serial("ddim"), ranks, tmp_path)
    assert [r["tasks_run"] for r in ranks] == [8, 8, 8]


def test_task_budget_stops_mid_round_and_resumes(scene, serial, tmp_path):
    """A task budget of 5 stops a 2-rank run after the temporal round's
    first wave (6 tasks run) with an intra-round state; a second 2-rank run
    resumes there and finishes, equal to the serial run."""
    first = _waves(scene, tmp_path, 2, 2, 1, task_budget=5)
    assert [(r["completed_rounds"], r["tasks_run"]) for r in first] == [(1, 6)] * 2
    from diffuman4d_torch.io.gridstate import read_state

    meta, _ = read_state(str(tmp_path / "state" / "grid_state.d4d"))
    assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == (1, 2)
    second = _waves(scene, tmp_path, 2, 2, 1)
    assert [r["tasks_run"] for r in second] == [2, 2]
    _assert_equal_runs(serial("ddim"), second, tmp_path)


def test_data_and_model_mesh_with_context_parallel(scene, serial, tmp_path):
    """A 2 x 2 mesh: waves of 2 tasks, each window step split over 2 ranks
    (fused CFG in the spatial round, split CFG in the temporal one)."""
    ref = serial("ddim")
    ranks = _waves(scene, tmp_path, 4, 2, 2)
    for r in ranks:
        np.testing.assert_array_equal(r["t_idx"], ref["t_idx"])
        np.testing.assert_allclose(r["latents"], ref["latents"], rtol=0, atol=CP_ATOL)
        np.testing.assert_array_equal(r["latents"], ranks[0]["latents"])  # one replica
    assert set(_jpegs(tmp_path)) == set(_jpegs(ref["out"]))


def test_one_by_one_mesh_equals_the_serial_path(scene, serial, tmp_path):
    """``execute_tasks_parallel`` on a 1 x 1 mesh (no process group, the
    collectives are copies) gives the serial path's bytes."""
    from diffuman4d_torch.parallel.mesh import make_mesh

    s = worker.build_sampler(scene, str(tmp_path))
    s.execute_tasks_parallel(make_mesh())
    got = worker.grid_of(s)
    assert torch.equal(s.grid_latents, torch.from_numpy(serial("ddim")["latents"]))
    _assert_equal_runs(serial("ddim"), [got], tmp_path)


def test_time_budget_is_refused_above_one_rank(scene, tmp_path):
    msgs = pdist.spawn_cpu_ranks(worker.refuse_time_budget, 2, (scene, str(tmp_path)),
                                 timeout_s=TIMEOUT_S)
    assert all("time_budget_s is single-process only" in m for m in msgs), msgs
