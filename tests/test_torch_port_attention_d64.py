"""The port's d = 64 attention (B1/B2: ``flash_attention_d64``, the
skewed-pipeline kernel) on CPU tensors, against the JAX package's
``flash_attention_v3`` and ``flash_attention_v4`` in Pallas interpret mode.

On the CPU the wrapper takes its plain version at every block size it was
built for; the JAX kernels run their TPU blocking in the interpreter. Both
get the same fp32 inputs from a seed, Sq != Sk, at the JAX package's own
tolerance of 2e-5 (``tests/test_flash_interpret.py``). The kernel itself is
held to the plain version on the card (``tests/test_torch_port_cuda.py``).
Nothing in the JAX package is edited.
"""

from __future__ import annotations

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import diffuman4d_tpu.ops.flash_attention as jfa
from diffuman4d_torch.ops import flash_attention as fa
from tests.torch_port_helpers import j, n, randn, rng, t

JAX_KERNELS = {"v3": jfa.flash_attention_v3, "v4": jfa.flash_attention_v4}


@pytest.mark.parametrize("blocks", fa.SKEW_CONFIGS)
@pytest.mark.parametrize("kernel", sorted(JAX_KERNELS))
def test_flash_d64_matches_jax(kernel, blocks):
    """Every built (block_q, block_k_major, block_k); the JAX kernel at the
    same block_q and block_k (its two score buffers of block_k keys),
    384 queries against 256 keys."""
    block_q, _, block_k = blocks
    r = rng(7)
    q, k, v = randn(r, 1, 384, 2, 64), randn(r, 1, 256, 2, 64), randn(r, 1, 256, 2, 64)
    with pltpu.force_tpu_interpret_mode():
        want = JAX_KERNELS[kernel](j(q), j(k), j(v), block_q=block_q, block_k=block_k)
    got = fa.flash_attention_d64(t(q), t(k), t(v), *blocks)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("kernel", sorted(JAX_KERNELS))
def test_flash_d64_default_blocks_match_jax_at_peaked_logits(kernel):
    """The default blocks (the d = 64 kernel of ``implementation="pallas"``
    and of shapes without a table entry) on peaked logits (q scaled by 4),
    Sq 128 against Sk 640, batch 2."""
    r = rng(8)
    q = randn(r, 2, 128, 3, 64, scale=4.0)
    k, v = randn(r, 2, 640, 3, 64), randn(r, 2, 640, 3, 64)
    with pltpu.force_tpu_interpret_mode():
        want = JAX_KERNELS[kernel](j(q), j(k), j(v), block_q=128, block_k=128)
    got = fa.flash_attention_d64(t(q), t(k), t(v))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


def test_flash_d64_refuses_blocks_it_was_not_built_for():
    q = t(randn(rng(9), 1, 64, 1, 64))
    for blocks in ((64, 256, 64), (256, 256, 64), (128, 128, 128), (192, 256, 128)):
        assert blocks not in fa.SKEW_CONFIGS
        with pytest.raises(ValueError, match="skewed attention"):
            fa.flash_attention_d64(q, q, q, *blocks)
