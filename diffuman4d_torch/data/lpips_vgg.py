"""LPIPS(VGG16) distance in torch (counterpart of
``diffuman4d_tpu/data/lpips_vgg.py``; the reference consumes torchmetrics'
LearnedPerceptualImagePatchSimilarity(net_type='vgg', normalize=True),
metric_utils.py:19).

Weights come from an ``.npz`` of the JAX package's schema
(:func:`expected_schema`, docs/LPIPS_WEIGHTS.md): no torchvision download.
  features.{i}.weight / features.{i}.bias  -- VGG16 conv layers (torch
    indices 0,2,5,7,10,12,14,17,19,21,24,26,28)
  lin{0..4}.weight                          -- LPIPS 1x1 linear heads

Pipeline (normalize=True variant):
  x in [0,1] -> 2x - 1 -> (x - shift)/scale -> VGG features at
  relu{1_2, 2_2, 3_3, 4_3, 5_3} -> channel-unit-normalize -> squared
  difference -> 1x1 lin head -> spatial mean -> sum over layers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torch feature indices of VGG16 conv layers, the relu taps after which
# LPIPS extracts features, and the maxpool positions
_TAPS = (3, 8, 15, 22, 29)
_POOLS = (4, 9, 16, 23)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv channel plan (in_ch -> out_ch per conv layer, torch index order)
_CONV_CHANNELS = {
    0: (3, 64), 2: (64, 64),
    5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256),
    17: (256, 512), 19: (512, 512), 21: (512, 512),
    24: (512, 512), 26: (512, 512), 28: (512, 512),
}
_TAP_CHANNELS = [64, 128, 256, 512, 512]  # lin head input widths


def expected_schema() -> dict[str, tuple[int, ...]]:
    """The exact npz schema ``scripts/extract_lpips_weights.py`` produces
    (docs/LPIPS_WEIGHTS.md)."""
    schema: dict[str, tuple[int, ...]] = {}
    for i, (cin, cout) in _CONV_CHANNELS.items():
        schema[f"features.{i}.weight"] = (cout, cin, 3, 3)  # torch OIHW
        schema[f"features.{i}.bias"] = (cout,)
    for k, c in enumerate(_TAP_CHANNELS):
        schema[f"lin{k}.weight"] = (1, c, 1, 1)
    return schema


def validate_weights(weights: dict) -> None:
    """Raise ValueError unless ``weights`` matches :func:`expected_schema`
    exactly (missing/extra keys or wrong shapes). lin heads are accepted
    in any reshapeable layout with the right element count."""
    schema = expected_schema()
    missing = sorted(set(schema) - set(weights))
    extra = sorted(set(weights) - set(schema))
    if missing or extra:
        raise ValueError(
            f"LPIPS weights npz key mismatch: missing={missing[:4]} "
            f"extra={extra[:4]} (see docs/LPIPS_WEIGHTS.md for the schema)"
        )
    for key, shape in schema.items():
        got = tuple(weights[key].shape)
        ok = got == shape or (
            key.startswith("lin") and int(np.prod(got)) == int(np.prod(shape))
        )
        if not ok:
            raise ValueError(
                f"LPIPS weights: {key} has shape {got}, expected {shape}"
            )


class VGG16LPIPS(nn.Module):
    """VGG16's convolutions up to relu5_3 and the five LPIPS heads, with
    the npz schema's names as its state dict keys."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict(
            {str(i): nn.Conv2d(cin, cout, 3, padding=1) for i, (cin, cout) in _CONV_CHANNELS.items()})
        for k, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{k}", nn.Conv2d(c, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    @classmethod
    def from_weights(cls, weights: dict, device=None) -> "VGG16LPIPS":
        """A module holding ``weights`` (the npz schema, validated)."""
        validate_weights(weights)
        model = cls()
        own = model.state_dict()
        model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)).reshape(own[k].shape)
                               for k, v in weights.items()})
        return model.to(device).eval()

    def _taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for i in range(max(_TAPS) + 1):
            if str(i) in self.features:
                x = F.relu(self.features[str(i)](x))  # every conv is followed by a relu
            elif i in _POOLS:
                x = F.max_pool2d(x, 2)
            if i in _TAPS:
                taps.append(x)
        return taps

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (N, H, W, 3) in [0, 1] -> (N,) distances, in fp32 (no TF32)."""
        def prep(x):
            return ((x.float().permute(0, 3, 1, 2) * 2.0 - 1.0) - self.shift) / self.scale

        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            fa, fb = self._taps(prep(a)), self._taps(prep(b))
        total = 0.0
        for k, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{k}").weight.reshape(1, -1, 1, 1)
            total = total + ((na - nb) ** 2 * lin).sum(dim=1).mean(dim=(1, 2))
        return total


@torch.no_grad()
def lpips_distance(model: VGG16LPIPS, pred: np.ndarray, gt: np.ndarray) -> float:
    """pred/gt: (H, W, 3) in [0, 1], on the model's device."""
    dev = model.shift.device
    a = torch.as_tensor(np.asarray(pred, np.float32), device=dev)[None]
    b = torch.as_tensor(np.asarray(gt, np.float32), device=dev)[None]
    return float(model(a, b)[0])
