"""A mesh of ranks (counterpart of ``diffuman4d_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``("data", "model")`` mesh: the
``data`` axis runs independent tasks of a round side by side (task waves),
the ``model`` axis splits one window step's frames (context parallelism).
The port runs one process per card, so its mesh is a grid of
``torch.distributed`` ranks in the JAX mesh's row-major order:
rank = data_row * model + model_index, the order of
``make_mesh``'s ``reshape(data, model)`` and of
``torch.distributed.device_mesh.init_device_mesh(..., mesh_dim_names=("data",
"model"))``. Each rank holds one process group per axis: the ranks of its
mesh row (``model``) and of its mesh column (``data``).

Without a process group (a plain one-card run) the mesh is 1 x 1 and its
collectives are copies. ``task_sharding`` / ``replicated`` have no
counterpart: every rank holds the whole grid and its own weights.

:func:`shard_params_for_tp` is the JAX function's placement rule for the
model axis of data- and tensor-parallel training: the parameters it names
are held as ``1/model`` slices (:class:`ShardLayout`) in the train state --
fp32 masters, optimiser moments and a device EMA -- while the module's
working copy stays whole on every rank (``ROADMAP.md`` C.21).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

def mesh_ranks(data: int, model: int) -> np.ndarray:
    """The (data, model) grid of ranks, row-major as the JAX mesh's devices."""
    return np.arange(data * model).reshape(data, model)


class Mesh:
    """This rank's view of a ("data", "model") mesh of ranks: ``shape`` as
    the JAX ``Mesh``'s, this rank's coordinates, and an all-gather over the
    ranks of either axis that share this rank's other coordinate."""

    def __init__(self, data: int, model: int, rank: int = 0, groups: dict | None = None):
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coords = {"data": rank // model, "model": rank % model}
        self._groups = groups or {}  # axis -> process group; none without a process group

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[axis]

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``x`` in place over the ``axis`` ranks that share this rank's
        other coordinate; returns ``x`` (unchanged where the axis has one
        rank and no process group)."""
        group = self._groups.get(axis)
        if group is None:
            if self.shape[axis] != 1:
                raise RuntimeError(f"mesh axis {axis} of {self.shape[axis]} ranks has no "
                                   "process group")
            return x
        dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every ``axis`` rank's ``x`` (one shape on all of them),
        concatenated along ``dim`` in the order of their coordinates; a new
        tensor, also where the axis has one rank."""
        group = self._groups.get(axis)
        if group is None:
            if self.shape[axis] != 1:
                raise RuntimeError(f"mesh axis {axis} of {self.shape[axis]} ranks has no "
                                   "process group")
            return torch.cat([x], dim)
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over the process group's ranks (a 1 x 1 mesh
    without one). ``data`` defaults to world // model. Every rank must call
    it, with the same arguments: the axis groups are made collectively."""
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    if data is None:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than {n} devices")
    if data * model < n:
        # the JAX mesh takes the first data * model devices; a rank outside
        # the mesh would have no task to run and no collective to join
        raise ValueError(f"mesh {data}x{model} leaves {n - data * model} of {n} ranks idle")
    if not initialized:
        return Mesh(1, 1)
    rank = dist.get_rank()
    grid = mesh_ranks(data, model)
    groups = {}
    # every rank creates every group, in one order
    for axis, lines in (("model", grid), ("data", grid.T)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(data, model, rank, groups)


def shard_params_for_tp(params: dict, mesh: Mesh, min_size: int = 2**16) -> dict:
    """The placement of the JAX package's tensor-parallel layout
    (``diffuman4d_tpu/parallel/mesh.py:46``): a tensor with ndim >= 2 and
    at least ``min_size`` elements is split over ``model`` along the dim
    that holds the flax kernel's last (output) axis; biases and norms stay
    whole. ``params`` maps diffusers names to tensors in torch layout;
    returns name -> the sharded dim, or None. The dim comes from the
    weight carry's transposes (``io/checkpoints.torch_dim_of_flax_axis``):
    dim 0 for every ``Linear`` and ``Conv`` weight. A sharded dim that
    ``model`` does not divide raises (XLA would pad; the port's slices are
    equal)."""
    from diffuman4d_torch.io.checkpoints import torch_dim_of_flax_axis

    m = mesh.shape["model"]
    placement = {}
    for name, x in params.items():
        dim = None
        if x.ndim >= 2 and x.numel() >= min_size:
            dim = torch_dim_of_flax_axis(name, x.ndim, x.ndim - 1)
            if x.shape[dim] % m:
                raise ValueError(f"{name}: dim {dim} of {tuple(x.shape)} does not divide "
                                 f"over model={m}")
        placement[name] = dim
    return placement


class ShardLayout:
    """This rank's slices of the parameters that a placement splits over
    the mesh's ``model`` axis: rank ``i`` of the axis holds the ``i``-th of
    ``model`` equal slices along dim 0, in the order of the coordinates.
    ``shapes`` are the whole tensors' shapes."""

    def __init__(self, placement: dict, shapes: dict, mesh: Mesh):
        self.mesh = mesh
        self.model = mesh.shape["model"]
        self.index = mesh.index("model")
        self.dims = {k: d for k, d in placement.items() if d is not None}
        if other := {k: d for k, d in self.dims.items() if d != 0}:
            # the flat gathers rebuild whole tensors from contiguous slices
            raise ValueError(f"sharded along a dim other than 0: {other}")
        self.shapes = {k: tuple(s) for k, s in shapes.items()}

    def sharded(self, name: str) -> bool:
        return name in self.dims

    def shard(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``x`` (a view; ``x`` itself
        where ``name`` is not sharded)."""
        if name not in self.dims:
            return x
        n = x.shape[0] // self.model
        return x.narrow(0, self.index * n, n)

    def gather(self, name: str, x: torch.Tensor, device=None) -> torch.Tensor:
        """The whole tensor from every model rank's slice ``x`` (``x``
        where ``name`` is not sharded); the collective runs on ``device``
        (a card for NCCL) and the result returns to ``x``'s device."""
        if name not in self.dims or self.model == 1:
            return x
        whole = self.mesh.all_gather(x.to(device or x.device), "model", dim=0)
        return whole.to(x.device)
