"""The port's Adafactor under data- and tensor-parallel training: two train
steps on four gloo CPU ranks (a 2 x 2 mesh) against the JAX step jitted on
a 2 x 2 device mesh (``tests/torch_port_dp_setup.py``; the optimiser alone
on model-axis slices is ``tests/test_torch_port_dp_optimizer.py``)."""

from __future__ import annotations

from tests import torch_port_dp_setup as dp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


def test_two_adafactor_steps_on_a_2x2_mesh_match_jax():
    dp.two_steps_match_jax(dp.jax_setup(), "adafactor", "spatial")
