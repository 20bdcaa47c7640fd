"""Two train steps of the port on meshes of 1 x 1 (no process group),
2 x 1, 1 x 2 and 2 x 2 gloo CPU ranks give one state
(``tests/test_torch_port_dp_loop.py`` holds the loop and the shared
helpers; ``tests/torch_port_dist_worker.py`` the rank functions)."""

from __future__ import annotations

import pytest

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.test_torch_port_dp_loop import MIN_SIZE, REL, TIMEOUT_S, _close, _inputs, _state0
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_two_steps_give_one_state_on_every_mesh_shape(optimizer):
    """1 x 1 (no process group), 2 x 1, 1 x 2 and 2 x 2: the loss, the
    gradient norm and the whole state after two steps agree within 1e-5 of
    the largest entry."""
    state0, (batches, draws) = _state0(), _inputs()
    kw = dict(optimizer=optimizer, learning_rate=1e-3, ema_decay=0.9)
    args = (worker.SMALL_UNET, state0, kw, "temporal", batches, draws, MIN_SIZE)
    ref = worker.train_steps(0, 1, 1, 1, *args)
    assert not any(ref["placement"][k] is None for k in ("conv_out.weight",))
    for data, model in ((2, 1), (1, 2), (2, 2)):
        ranks = pdist.spawn_cpu_ranks(worker.train_steps, data * model, (data, model, *args),
                                      timeout_s=TIMEOUT_S)
        for r in ranks:
            for m, w in zip(r["metrics"], ref["metrics"]):
                assert abs(m["loss"] - w["loss"]) <= REL * w["loss"], (data, model)
                assert abs(m["grad_norm"] - w["grad_norm"]) <= REL * w["grad_norm"]
            assert r["module_is_masters"]
        got, want = ranks[0]["state"], ref["state"]
        assert got["count"] == want["count"] == 2
        for slot in want:
            if slot != "count":
                _close(got[slot], want[slot], f"{data}x{model} {slot}")
        if model > 1:  # the model axis halves the masters' bytes on each rank
            assert (ranks[0]["metrics"][-1]["state_bytes"]["masters"]
                    < 0.6 * ref["metrics"][-1]["state_bytes"]["masters"])
