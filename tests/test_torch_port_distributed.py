"""The port's process group, rank mesh and rank-prefixed logger
(``diffuman4d_torch/parallel/{distributed,mesh}.py``,
``utils/tracing.py`` ``RankedLogger``) against the JAX package's mesh, on
gloo CPU ranks spawned by ``spawn_cpu_ranks`` (rank functions in
``tests/torch_port_dist_worker.py``)."""

from __future__ import annotations

import logging

import jax
import numpy as np
import pytest

from diffuman4d_torch.parallel import distributed as pdist
from diffuman4d_torch.parallel.mesh import Mesh, make_mesh, mesh_ranks
from tests import torch_port_dist_worker as worker

TIMEOUT_S = 120.0


def test_initialize_is_a_noop_without_env(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.initialize("cpu") is False
    assert pdist.rank() == 0 and not pdist.is_multi()
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="mesh 2x2 needs more than 1 devices"):
        make_mesh(2, 2)


def test_initialize_raises_where_it_cannot_start(monkeypatch):
    """With a world above one rank and no way to bring the group up, the
    entry points raise: nothing falls back to one rank."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises((ValueError, RuntimeError)):
        pdist.initialize("cpu", timeout_s=5.0)
    from diffuman4d_torch import cli

    with pytest.raises((ValueError, RuntimeError)):
        cli.main(["exp=demo_3d", "device=cpu"])


@pytest.mark.parametrize("data,model", [(2, 2), (4, 2), (1, 4), (8, 1)])
def test_rank_order_is_the_jax_mesh_device_order(data, model):
    from diffuman4d_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(data=data, model=model)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh_ranks(data, model), ids - ids.min())
    assert dict(jmesh.shape) == Mesh(data, model).shape


@pytest.mark.parametrize("world,data,model", [(2, 2, 1), (4, 2, 2)])
def test_mesh_groups_and_wave_gather(world, data, model):
    infos = pdist.spawn_cpu_ranks(worker.mesh_info, world, (data, model), timeout_s=TIMEOUT_S)
    grid = mesh_ranks(data, model)
    for r, info in enumerate(infos):
        d, m = info["coords"]
        assert grid[d, m] == r
        assert info["model_group"] == grid[d].tolist()
        assert info["data_group"] == grid[:, m].tolist()
        assert info["local_data_rows"] == [d]
        # the wave-row gather: every data row's rows, in data-row order
        want = np.stack([np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * grid[i, m]
                         for i in range(data)])
        np.testing.assert_array_equal(info["wave_rows"], want)
        assert info["objects"] == [{"rank": i} for i in range(world)]
        assert info["records"] == [f"[rank{r}] wave 7"] + (["[rank0] once"] if r == 0 else [])


def test_ranked_logger_without_a_process_group(caplog):
    from diffuman4d_torch.utils.tracing import RankedLogger

    with caplog.at_level(logging.INFO, logger="port.ranked"):
        RankedLogger("port.ranked").info("step %d", 3)
        RankedLogger("port.ranked", rank_zero_only=True).warning("only rank 0")
        RankedLogger("port.ranked").debug("below the level")
    assert [r.getMessage() for r in caplog.records] == ["[rank0] step 3",
                                                        "[rank0] only rank 0"]


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="mesh 3x1 needs more than 2 devices"):
        pdist.spawn_cpu_ranks(worker.mesh_info, 2, (3, 1), timeout_s=TIMEOUT_S)


def test_jax_is_not_needed_by_the_ranks():
    """The rank functions' module imports the port alone (the spawned ranks
    never load jax)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(worker))
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "flax", "diffuman4d_tpu", "tests"}, names
    assert jax  # the oracle side of these tests does import it
