"""Shared set-up of the benchmark's CPU tests: the tiny widths, one torch
thread, and the ``cuda`` marker for tests that need the card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_UNET = dict(block_out_channels=[8, 16, 16, 16], num_attention_heads=[1, 2, 2, 2],
                 layers_per_block=1, norm_num_groups=4)
TINY_VAE = dict(block_out_channels=[4, 4, 8, 8], layers_per_block=1)
TINY = {"unet": TINY_UNET, "vae": TINY_VAE}  # overrides of a d4d_multiview configuration
# Limits at the tiny widths, from CPU runs on seeds 100-105 (the bf16
# program's largest reading / the float8 control's smallest): pose-demo3d
# step 0.080 / 0.438, decode 0.733 / 5.76 levels; skel-temporal step
# 0.096 / 0.463, hist 0.097 / 0.464; pose-temporal-stream step 0.108 / 0.462.
TINY_LIMITS = {
    "pose-demo3d": {"start": 0.0, "chain": 0, "step": 0.2, "decode": 2.0},
    "skel-temporal": {"start": 0.0, "chain": 0, "step": 0.22, "hist": 0.22},
    "pose-temporal-stream": {"start": 0.0, "chain": 0, "step": 0.22},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_run(tmp_path):
    """``run(cell, seed, **kw)``: one run of ``cell`` on the CPU at the tiny
    widths and 64^2 images, one task or job, held to ``TINY_LIMITS`` (of
    the cell ``limits_of``, if given; ``root`` may be another checkout)."""
    import time

    from benchmark.harness import runner

    def run(cell, seed=7, **kw):
        return runner.run(cell, seed, 0.5, kw.pop("trace", False), time.perf_counter(),
                          device="cpu", image_size=64, overrides=TINY, cache=str(tmp_path),
                          limits=TINY_LIMITS[kw.pop("limits_of", cell)], **kw)
    return run
