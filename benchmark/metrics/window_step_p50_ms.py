"""Median milliseconds of one window step on the card: the ``p50_s`` of the
program's ``denoise/window_step`` spans (a CUDA event pair around each of
the pipeline's denoising steps on one window, read after the window)."""


def read(rec):
    step = rec["spans"].get("denoise/window_step")
    if step is None or "p50_s" not in step:
        return None
    return 1e3 * step["p50_s"]
