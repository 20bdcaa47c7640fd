"""Two AdamW steps of the temporal domain (temporal embeddings, the
two-camera track of a temporal window) on four gloo CPU ranks, a 2 x 2
mesh, against the JAX train step jitted on a 2 x 2 device mesh
(``tests/torch_port_dp_setup.py``; the spatial domain is
``tests/test_torch_port_dp_training.py``)."""

from __future__ import annotations

from tests import torch_port_dp_setup as dp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401


def test_two_adamw_steps_of_the_temporal_domain_on_a_2x2_mesh_match_jax():
    dp.two_steps_match_jax(dp.jax_setup(), "adamw", "temporal")
