"""Data- and tensor-parallel training of the port (``training/trainer.py``
under a ``parallel/mesh.py`` mesh) against the JAX package's train step
jitted on a 2 x 2 device mesh of the conftest's 8 CPU devices, with
``shard_params_for_tp(min_size=2**10)`` and a ``P("data")`` batch (the
layout of ``__graft_entry__.dryrun_multichip``). The port runs on four gloo
CPU ranks (``tests/torch_port_dist_worker.py``) from the same weights,
batches and JAX draws of ``t`` / ``eps``; fp32 on both sides, within the
tolerances of the one-card tests (``tests/test_torch_port_training.py``,
``tests/test_torch_port_adafactor.py``). The placement is held to the JAX
arrays' sharding specs, and the port's optimiser on model-axis slices to
the same optimiser on whole tensors (the temporal domain is
``tests/test_torch_port_dp_temporal.py``, Adafactor
``tests/test_torch_port_dp_adafactor.py``; the shared setup is
``tests/torch_port_dp_setup.py``)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests import torch_port_dp_setup as dp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_setup():
    return dp.jax_setup()


def test_placement_matches_the_jax_sharding_specs(jax_setup):
    """The port's rule names the JAX layout's sharded arrays, on the dim
    that holds the flax kernel's last axis; biases and norms stay whole."""
    from diffuman4d_torch.parallel.mesh import Mesh, shard_params_for_tp

    _, jparams, _, placed = jax_setup
    flags = dp.flax_to_port(jax.tree.map(
        lambda x: np.full(x.shape, "model" in tuple(x.sharding.spec)), placed["params"]))
    want = {k for k, v in flags.items() if v.all()}
    whole = {k: torch.from_numpy(v) for k, v in dp.flax_to_port(jparams["params"]).items()}
    placement = shard_params_for_tp(whole, Mesh(2, 2), min_size=dp.MIN_SIZE)
    assert {k for k, d in placement.items() if d is not None} == want and want
    flax_out = dp.flax_to_port(jax.tree.map(
        lambda x: np.full(x.shape, x.shape[-1]), jparams["params"]))
    for k in want:  # the sharded dim is the one that holds the flax output axis
        assert whole[k].shape[placement[k]] == flax_out[k].flat[0], k
    assert placement == shard_params_for_tp(whole, Mesh(1, 1), min_size=dp.MIN_SIZE)
    with pytest.raises(ValueError, match="does not divide"):
        shard_params_for_tp({"w.weight": torch.zeros(6, 512)}, Mesh(1, 4), min_size=1)


def test_full_width_unet_shards_evenly_over_eight():
    """Every parameter of the full-width ``UNetConfig()`` that the default
    rule shards (ndim >= 2, >= 2**16 elements) splits over model = 8
    (widths 320 / 640 / 1280), along dim 0; built on the meta device."""
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.parallel.mesh import Mesh, shard_params_for_tp

    with torch.device("meta"):
        unet = UNetMultiviewCondition(UNetConfig())
    named = dict(unet.named_parameters())
    placement = shard_params_for_tp(named, Mesh(1, 8))
    sharded = {k: named[k].shape for k, d in placement.items() if d is not None}
    assert set(placement.values()) == {None, 0}
    assert len(sharded) > 250 and all(s[0] % 8 == 0 for s in sharded.values())
    share = sum(named[k].numel() for k in sharded) / sum(p.numel() for p in named.values())
    assert share > 0.95  # the masters and moments of nearly every weight split


def test_two_adamw_steps_on_a_2x2_mesh_match_jax(jax_setup):
    dp.two_steps_match_jax(jax_setup, "adamw", "spatial")
