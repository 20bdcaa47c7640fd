"""Host-offloaded fp32 EMA shadow (counterpart of
``diffuman4d_tpu/training/ema.py``).

The shadow lives in host memory and its update overlaps device compute:

    launch step N+1             (device busy)
    fold()                      host folds the params staged after step N
    stage(new_params)           asynchronous device-to-host copies

``stage`` copies into pinned host buffers with ``non_blocking=True`` and
records an event; ``fold`` waits on that event, so folding before the next
step is also safe when the step overwrites the parameters in place (the
train step here does). The host math is the fp32 update of the in-step
device EMA: ``e <- d*e + (1-d)*p``.

Under a mesh the shadow follows the masters' shards (``ROADMAP.md`` C.22):
each rank stages and folds its own slices; ``load`` takes whole tensors
(a checkpoint) and keeps this rank's slices, and ``materialize(whole=True)``
gathers them over the model group.
"""

from __future__ import annotations

import torch


class HostEMA:
    """fp32 EMA shadow in host memory, fed by asynchronous device-to-host
    copies.

    ``update_every=k`` applies the spaced-update approximation
    ``e <- d^k * e + (1 - d^k) * p`` every k-th step: equivalent to the
    per-step EMA when the parameters drift slowly, at 1/k the transfer cost.
    """

    def __init__(self, params: dict, decay: float, update_every: int = 1, layout=None):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        if update_every < 1:
            raise ValueError(f"update_every must be >= 1, got {update_every}")
        self.update_every = int(update_every)
        self.decay = float(decay) ** self.update_every
        self.names = list(params)
        self.layout = layout  # parallel.mesh.ShardLayout of the sharded params, or None
        self._device = next(iter(params.values())).device if params else None
        pin = any(p.is_cuda for p in params.values())
        self.shadow = [p.detach().to("cpu", torch.float32, copy=True) for p in params.values()]
        self._buffers = [torch.empty_like(e, pin_memory=pin) for e in self.shadow]
        self._event: torch.cuda.Event | None = None
        self._staged = False

    def should_update(self, step: int) -> bool:
        return step % self.update_every == 0

    def stage(self, params: dict) -> None:
        """Start asynchronous copies of ``params`` to the host; fold()
        consumes them."""
        if list(params) != self.names:
            raise ValueError(f"param dict changed: {len(params)} entries vs "
                             f"{len(self.names)} in the shadow")
        on_cuda = False
        for buf, p in zip(self._buffers, params.values()):
            buf.copy_(p.detach(), non_blocking=True)
            on_cuda |= p.is_cuda
        self._event = None
        if on_cuda:
            self._event = torch.cuda.Event()
            self._event.record()
        self._staged = True

    def fold(self) -> None:
        """Fold the staged params into the shadow (waits for the copies)."""
        if not self._staged:
            return
        if self._event is not None:
            self._event.synchronize()
        d = self.decay
        for e, p in zip(self.shadow, self._buffers):
            e.mul_(d).add_(p, alpha=1.0 - d)
        self._staged = False

    def materialize(self, whole: bool = False) -> dict:
        """The shadow as a dict matching the source params (live tensors:
        callers that keep it across further updates must copy). With
        ``whole`` and a layout, the sharded entries are gathered over the
        model group (a collective: every model rank calls it)."""
        out = dict(zip(self.names, self.shadow))
        if whole and self.layout is not None:
            out = {k: self.layout.gather(k, e, self._device) for k, e in out.items()}
        return out

    def load(self, tree: dict) -> None:
        """Replace the shadow from a restored checkpoint dict of whole
        tensors (this rank's slices are kept under a layout)."""
        if list(tree) != self.names:
            raise ValueError("restored EMA dict does not match the shadow")
        shard = self.layout.shard if self.layout is not None else (lambda k, x: x)
        self.shadow = [shard(k, x.detach()).to("cpu", torch.float32, copy=True)
                       for k, x in tree.items()]
        self._staged = False

    @property
    def nbytes(self) -> int:
        return sum(e.numel() * e.element_size() for e in self.shadow)
