"""Model FLOPs the window's work needs (``harness/work.py``: UNet forwards,
VAE encodes and decodes, pose encoder, from the configuration's widths) over
window seconds, as a share of the H100 SXM dense bf16 peak (989 TFLOP/s)."""

from benchmark.harness.work import PEAK_BF16_FLOPS


def read(rec):
    flops = rec.get("flops")
    if not flops:
        return None
    return 100.0 * flops / rec["window_s"] / PEAK_BF16_FLOPS
