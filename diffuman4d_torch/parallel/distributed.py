"""Multi-process execution (counterpart of ``diffuman4d_tpu/parallel/distributed.py``).

The JAX package runs one process per host and addresses a global device
mesh; the port runs one process per card (``torchrun --nproc_per_node N``)
over ``torch.distributed``: NCCL between cards, gloo between CPU ranks.

* :func:`initialize` -- the process group from torchrun's environment; a
  no-op that returns False when the environment names no rank, so every
  entry point can call it.
* :func:`global_mesh` -- the (data, model) mesh over every rank, with the
  JAX module's check that a model group does not straddle hosts.
* :func:`local_data_rows` -- the data rows this process feeds: its own.
* :func:`gather_wave_rows` -- takes the place of the JAX module's
  ``put_sharded`` / ``host_local_to_global`` / ``replicate_to_host``: every
  rank holds a replica of the grid, so after a wave each rank's task rows
  are all-gathered over the data axis into every replica.
* :func:`all_gather_object` -- host values (the end-of-run coverage union)
  through ``torch.distributed.all_gather_object`` on the default group.
* :func:`spawn_cpu_ranks` -- a function run in n spawned processes that
  form a gloo group on the CPU (the dry run, and the tests' ranks).
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from diffuman4d_torch.parallel.mesh import Mesh, make_mesh

log = logging.getLogger(__name__)

# how long a rank waits for the others at a rendezvous or a collective: the
# JAX sampler's process barrier waits 1,200 s, and a wave's ranks may drift
# apart by a task's host work
TIMEOUT_S = 1200.0


def is_multi() -> bool:
    """Whether a process group of more than one rank is up."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize(device: str | torch.device = "cuda", init_method: str = "env://",
               timeout_s: float = TIMEOUT_S) -> bool:
    """Bring up the process group when torchrun's ``RANK`` / ``WORLD_SIZE``
    are set (``LOCAL_RANK`` picks the card, ``MASTER_ADDR`` /
    ``MASTER_PORT`` the rendezvous of ``env://``): NCCL for ``cuda``, gloo
    for ``cpu``. Returns False, doing nothing, when neither is set; True
    when the group is up (also when it already was). Raises when it cannot
    be brought up: a multi-rank run never falls back to one rank."""
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_available() and dist.is_initialized():
        return True
    if missing := [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]:
        raise ValueError(f"torch.distributed: {missing} not set beside the other")
    device = torch.device(device)
    world_size, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if not dist.is_available():
        raise RuntimeError("WORLD_SIZE is set but this torch has no torch.distributed")
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("WORLD_SIZE is set but this torch has no NCCL")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device}: cuda or cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("distributed: rank %d/%d over %s", rank_, world_size, backend)
    return True


def global_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over every rank. A model group may not
    straddle hosts: ``model`` must divide the ranks per host."""
    mesh = make_mesh(data=data, model=model)
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", mesh.size))
    if model > 1 and n_local % model != 0 and mesh.size > n_local:
        raise ValueError(
            f"model={model} straddles host boundaries "
            f"({n_local} local devices); choose model | local_device_count"
        )
    return mesh


def local_data_rows(mesh: Mesh) -> list[int]:
    """The data-axis rows whose tasks this process loads, prepares and
    denoises: its own row (one process per card)."""
    return [mesh.index("data")]


def gather_wave_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's task rows ``x`` and every other data row's, stacked in
    data-row order: (data, *x.shape) on every rank."""
    return mesh.all_gather(x[None], "data", dim=0)


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` in rank order (``[obj]`` without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _cpu_rank(fn, rank_: int, world: int, tmp: str, args: tuple, timeout_s: float) -> None:
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world), LOCAL_RANK=str(rank_),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)  # n ranks share the host's cores
    try:
        initialize("cpu", init_method=f"file://{tmp}/rendezvous", timeout_s=timeout_s)
        out, name = pickle.dumps(fn(rank_, world, *args)), f"rank{rank_}.pkl"
    except BaseException:
        out, name = traceback.format_exc().encode(), f"rank{rank_}.err"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{tmp}/{name}.part", "wb") as f:
        f.write(out)
    os.replace(f"{tmp}/{name}.part", f"{tmp}/{name}")  # the launcher sees whole files only


def spawn_cpu_ranks(fn, world: int, args: tuple = (), timeout_s: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each a rank
    of one gloo group on the CPU (``fn`` and ``args`` must pickle; ``fn``'s
    module must import without side effects). Returns every rank's result
    in rank order. Raises when a rank fails or the ranks outlast
    ``timeout_s``; every rank still running is then stopped.

    A rank is done when its result (or its traceback) is on disk: the
    launcher does not wait on exit codes, which a host process that reaps
    other children (as a test runner's may) can take away."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_cpu_rank, args=(fn, r, world, tmp, args, timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()

        def written(ext: str) -> list[int]:
            return [r for r in range(world) if os.path.isfile(f"{tmp}/rank{r}.{ext}")]

        deadline = time.monotonic() + timeout_s
        try:
            # until every rank has written, one has failed (the others may
            # wait on it) or one died without a word (killed, crashed)
            while (len(written("pkl")) < world and not written("err")
                   and not any(p.exitcode for p in procs) and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r in written("err"):
            with open(f"{tmp}/rank{r}.err") as f:
                errors.append(f"rank {r}:\n{f.read()}")
        if errors or len(written("pkl")) < world:
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"ranks exited with {codes}" + "".join(f"\n{e}" for e in errors)
                               + ("" if errors else f" (no result within {timeout_s} s)"))
        results = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
