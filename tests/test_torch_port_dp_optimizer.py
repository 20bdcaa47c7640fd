"""The port's optimiser on model-axis slices (four gloo CPU ranks, a 1 x 4
mesh) against the JAX package's ``make_optimizer`` (optax) on the whole
arrays in flax layout, and against the port's own optimiser on whole
tensors: Adafactor on shapes that factor either way round the sharded dim,
AdamW beside it. optax computes its statistics on the whole arrays, so the
port's ``Optimizer`` decides ``factored_dims`` by the whole shape and sums
the row normaliser and both rms values over the model group
(``tests/torch_port_dist_worker.py`` holds the rank function)."""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.test_torch_port_adafactor import REL, TO_TORCH, _moment_in_torch_layout, _torch_layout
from tests.torch_port_dp_setup import _find
from tests.torch_port_helpers import j, one_torch_thread  # noqa: F401

TIMEOUT_S = 180.0


# the optimiser alone on slices: torch-layout shapes whose factored axes
# fall either way round dim 0 (v_row or v_col keeps it), a weight that
# factors only by its whole shape (256 x 512 is 64 x 512 on each of four
# ranks, under the 128 that decides factoring), one kept whole by its
# shape (8 rows) and a bias that is not sharded
OPT_SHAPES = {"a.weight": (512, 256), "b.weight": (256, 512), "c.weight": (256, 128, 3, 3),
              "f.weight": (128, 256, 3, 3), "d.weight": (8, 4096), "e.bias": (256,)}
GRAD_SCALES = (0.01, 1.0, 0.001)  # global norms ~9.4, ~940, ~0.94: the clip acts on step 2
GRAD_CLIP = 100.0


def _flax_layout(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, np.argsort(TO_TORCH[x.ndim])))


def _close(got, want, what: str) -> None:
    """Within REL of the largest entry (``tests/test_torch_port_adafactor.py``)."""
    want = np.asarray(want, np.float32)
    bound = REL * max(np.abs(want).max(), 1e-30)
    assert np.abs(np.asarray(got) - want).max() <= bound, what


def _jax_steps(params: dict, grads: list, kw: dict) -> tuple:
    """optax's chain of the JAX package on the whole arrays in flax layout:
    the parameters and the optimiser's state after the steps."""
    from diffuman4d_tpu.training import trainer as jt

    jopt = jt.make_optimizer(jt.TrainConfig(**kw))
    jparams = {k: j(_flax_layout(v)) for k, v in params.items()}
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        updates, jstate = jupdate({k: j(_flax_layout(v)) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return {k: np.asarray(v) for k, v in jparams.items()}, jstate


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_optimizer_on_model_slices_matches_whole_tensors(optimizer):
    from diffuman4d_torch.training import trainer as pt

    r = np.random.default_rng(3)
    # the scale and learning rate of tests/test_torch_port_adafactor.py: a
    # step well above the parameters' fp32 rounding
    params = {k: (r.standard_normal(s) * 0.05).astype(np.float32) for k, s in OPT_SHAPES.items()}
    grads = [{k: (r.standard_normal(s) * scale).astype(np.float32) for k, s in OPT_SHAPES.items()}
             for scale in GRAD_SCALES]
    norms = [np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs.values())) for gs in grads]
    assert [n > GRAD_CLIP for n in norms] == [False, True, False]
    kw = dict(optimizer=optimizer, learning_rate=0.1, weight_decay=1e-2, grad_clip=GRAD_CLIP)
    ranks = pdist.spawn_cpu_ranks(worker.optimizer_shards, 4, (4, params, grads, kw),
                                  timeout_s=TIMEOUT_S)

    # the reference: optax on the whole arrays
    jparams, jstate = _jax_steps(params, grads, kw)
    want = {k: _torch_layout(v) for k, v in jparams.items()}
    if optimizer == "adamw":
        adam = _find(jstate, "mu")
        want_state = {slot: {k: _torch_layout(np.asarray(v)) for k, v in getattr(adam, slot).items()}
                      for slot in ("mu", "nu")}
    else:
        fact = _find(jstate, "v_row")
        want_state = {"v": {}, "v_row": {}, "v_col": {}}
        for k, s in OPT_SHAPES.items():
            flax_shape = _flax_layout(params[k]).shape
            dims = pt.factored_dims(s)
            if dims is None:
                want_state["v"][k] = _torch_layout(np.asarray(fact.v[k]))
                continue
            jk = {"v_row": fact.v_row[k], "v_col": fact.v_col[k]}
            d1, d0 = dims
            want_state["v_row"][k] = _moment_in_torch_layout(jk, flax_shape, d0)
            want_state["v_col"][k] = _moment_in_torch_layout(jk, flax_shape, d1)
    # the second check: the port's optimiser on whole tensors
    opt = pt.make_optimizer(pt.TrainConfig(**kw))
    whole = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(whole)
    for g in grads:
        opt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, state, whole)
    assert set(state) - {"count"} == set(want_state)

    for res in ranks:
        for k in OPT_SHAPES:
            # the step from the start and the parameters, against optax
            _close(res["params"][k] - params[k], want[k] - params[k], f"step {k}")
            _close(res["params"][k], want[k], k)
            if optimizer == "adamw":  # elementwise: the same bits on slices as on whole tensors
                assert np.array_equal(res["params"][k], whole[k].numpy()), k
            np.testing.assert_allclose(res["params"][k], whole[k].numpy(), rtol=0,
                                       atol=1e-6 * np.abs(whole[k].numpy()).max(), err_msg=k)
        for slot, tree in want_state.items():
            assert set(res["opt_state"][slot]) == set(tree) == set(state[slot]), slot
            for k, m in tree.items():
                _close(res["opt_state"][slot][k], m, f"{slot} {k}")
                np.testing.assert_allclose(res["opt_state"][slot][k], state[slot][k].numpy(),
                                           rtol=1e-6, atol=1e-30, err_msg=f"{slot} {k}")
        # factoring follows the whole shape; the slices are 1/4 along dim 0
        assert res["factored"] == {k: pt.factored_dims(s) for k, s in OPT_SHAPES.items()}
        for slot, shapes in res["shapes"].items():
            for k, s in shapes.items():
                full = tuple(state[slot][k].shape) if slot != "params" else OPT_SHAPES[k]
                split = k != "e.bias" and pt.slot_sharded(_Layout(), slot, k)
                assert s == ((full[0] // 4,) + full[1:] if split else full), (slot, k)
    if optimizer == "adafactor":
        assert sorted(state["v"]) == ["d.weight", "e.bias"]
        assert set(state["v_row"]) == {"a.weight", "b.weight", "c.weight", "f.weight"}


class _Layout:
    """Just what ``slot_sharded`` reads: every weight of OPT_SHAPES sharded."""

    shapes = OPT_SHAPES

    def sharded(self, name: str) -> bool:
        return name != "e.bias"
