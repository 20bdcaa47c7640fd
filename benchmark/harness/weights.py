"""Seeded random weights for one configuration, drawn on the device in a
few large calls and handed to both sides: the program under test loads them
(``load_state_dict``) and the plain reference loads the same values.

Rule, by parameter name: a matrix or kernel (2 or more dimensions) is
N(0, 1/fan_in); a norm's scale and the pose encoder's ``scale`` are
1 + 0.05 N(0, 1); a bias is 0.02 N(0, 1). Every value is drawn, the heads
that a trained model starts at zero included, so that every path (pose
features, temporal embedding) reaches the output.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28  # elements per generator call


def spec(modules: dict[str, torch.nn.Module]) -> list[tuple[str, tuple[int, ...]]]:
    """(module key + "." + parameter name, shape), in a fixed order."""
    return [(f"{key}.{name}", tuple(p.shape))
            for key, mod in modules.items() for name, p in mod.named_parameters()]


def _kind(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter before its draw is scaled."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "bias":
        return 0.0, 0.02
    return 1.0, 0.05  # norm scales, the pose encoder's scalar scale


@torch.no_grad()
def make_weights(entries, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """{name: tensor} of ``entries`` (from :func:`spec`), in ``dtype`` on
    ``device``: standard normals from one generator, ``CHUNK`` at a time,
    then scaled and shifted per parameter."""
    total = sum(math.prod(s) for _, s in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        n = min(CHUNK, total - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=device, dtype=torch.float32).to(dtype)
    out, off = {}, 0
    for name, shape in entries:
        n = math.prod(shape)
        mean, std = _kind(name, shape)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def split(weights: dict[str, torch.Tensor], key: str) -> dict[str, torch.Tensor]:
    """The state dict of module ``key`` out of :func:`make_weights`."""
    pre = key + "."
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}
