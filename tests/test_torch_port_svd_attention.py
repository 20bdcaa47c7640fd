"""The attention shapes SVD-xt's UNet brings to the port's dispatch: the
temporal self-attention (S = Sk = 25 over B * H rows up to 92,160, above
gridDim.y's 65,535) and the one-token cross-attention (Sk = 1).

On the CPU: ``route()``'s choice and its gate on Sk (no shape reaches the
skewed or two-level kernel with fewer keys than its ``block_k``), the
launch split, and both shapes through ``dot_product_attention`` against
``attention_plain`` (the one-key route bit for bit). On the card (marked
``cuda``, skipped without one): the same against the kernels."""

import pytest
import torch

from diffuman4d_torch.ops import attention as attn
from diffuman4d_torch.ops import flash_attention as fa

# (B, S, H) of the temporal self-attention at each level, CFG fused
TEMPORAL = [(18432, 25, 5), (4608, 25, 10), (1152, 25, 20), (288, 25, 20)]


@pytest.mark.parametrize("b,s,h", TEMPORAL)
def test_temporal_shapes_route_to_the_single_pass(b, s, h):
    name, params = attn.route((b, s, h, 64), (b, s, h, 64))
    assert name in ("single_pass", "single_pass_batched"), (name, params)
    assert fa.single_pass_ok(s, params["block_q"], 64, params.get("block_b", 1))
    if name == "single_pass_batched":
        assert (b * h) % params["block_b"] == 0


@pytest.mark.parametrize("q_shape", [(50, 9216, 5, 64), (50, 2304, 10, 64), (18432, 25, 5, 64),
                                     (2, 16384, 1, 512)])
def test_one_key_takes_the_single_key_route(q_shape):
    b, s, h, d = q_shape
    assert attn.route(q_shape, (b, 1, h, d)) == ("single_key", {})


def test_gate_keeps_short_key_rows_off_the_tiled_kernels(monkeypatch):
    """Whatever entry the table's nearest match is, a key row shorter than
    a skewed or two-level entry's ``block_k`` goes to the single pass, and
    the default route too."""
    table = [{"name": "t", "b": 2, "s": 4096, "h": 10, "d": 64, "impl": "two_level",
              "block_q": 128, "block_k_major": 256, "block_k": 128},
             {"name": "f", "b": 2, "s": 65536, "h": 10, "d": 64, "impl": "flash_d64",
              "block_q": 128, "block_k_major": 256, "block_k": 128}]
    monkeypatch.setattr(attn, "_TABLE", table)
    for sq in (25, 4096, 65536):
        for sk in (2, 25, 63):
            name, params = attn.route((2, sq, 10, 64), (2, sk, 10, 64))
            assert name == "single_pass" and fa.single_pass_ok(sk, params["block_q"]), (sq, sk)
        # under the entry's block_k of 128, over the default's 64
        assert attn.route((2, sq, 10, 64), (2, 127, 10, 64)) == ("flash_d64", {})
        assert attn.route((2, sq, 10, 64), (2, 128, 10, 64))[0] in ("two_level", "flash_d64")
    monkeypatch.setattr(attn, "_TABLE", [])
    assert attn.route((2, 25, 10, 64), (2, 25, 10, 64)) == ("single_pass", {"block_q": 64})
    assert attn.route((2, 4096, 10, 64), (2, 40, 10, 64)) == ("single_pass", {"block_q": 128})
    assert attn.route((2, 4096, 10, 64), (2, 4096, 10, 64)) == ("flash_d64", {})


@pytest.mark.parametrize("b,h,rows_on_y", [(18432, 5, True), (4608, 10, True), (100, 5, True),
                                           (18432, 5, False), (13107, 5, True), (70000, 1, True)])
def test_only_kernels_with_rows_on_grid_y_refuse_b_times_h_past_it(b, h, rows_on_y):
    """B * H above gridDim.y's 65,535 raises where the kernel puts the rows
    on gridDim.y (B1/B2, B3, B10), not for the single pass's 1-D grid: that
    call goes on to the device check (meta tensors here)."""
    q = torch.empty(b, 25, h, 64, dtype=torch.bfloat16, device="meta")
    fn = fa.flash_attention_single_pass_batched if not rows_on_y else fa.flash_attention_two_level
    msg = "exceeds the grid limit" if rows_on_y and b * h > 65535 else "bf16 CUDA tensor"
    with pytest.raises(ValueError, match=msg):
        fa._launch(fn, q, q, q, "unused", (), rows_on_grid_y=rows_on_y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_key_route_is_attention_plain_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(0)
    b, s, h = 13108, 4, 5  # B * H = 65,540
    q = torch.randn(b, s, h, 64, generator=g).to(dtype)
    k = torch.randn(b, 1, h, 64, generator=g).to(dtype)
    v = torch.randn(b, 1, h, 64, generator=g).to(dtype)
    before = fa.single_key.launches
    out = attn.dot_product_attention(q, k, v)
    assert fa.single_key.launches == before + 1
    assert torch.equal(out, fa.attention_plain(q, k, v))
    assert torch.equal(out, v.expand(b, s, h, 64))


def test_temporal_attention_on_the_cpu_is_attention_plain():
    g = torch.Generator().manual_seed(1)
    b, s, h = 13108, 25, 5
    q, k, v = (torch.randn(b, s, h, 64, generator=g).bfloat16() for _ in range(3))
    assert torch.equal(attn.dot_product_attention(q, k, v), fa.attention_plain(q, k, v))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's attention kernels")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", TEMPORAL)
def test_temporal_shapes_on_the_card(card, b, s, h):
    """The kernel's rows within 2^-7 of the largest output (bf16 P and
    output roundings), every launch within gridDim.y."""
    q, k, v = (torch.randn(b, s, h, 64, generator=card, device="cuda").bfloat16()
               for _ in range(3))
    out = attn.dot_product_attention(q, k, v)
    want = torch.cat([fa.attention_plain(q[i:i + 4096], k[i:i + 4096], v[i:i + 4096])
                      for i in range(0, b, 4096)])
    assert float((out.float() - want.float()).abs().max()) <= 2 ** -7 * float(
        want.float().abs().max())


@pytest.mark.cuda
def test_one_key_on_the_card_is_bit_for_bit(card):
    q = torch.randn(50, 9216, 5, 64, generator=card, device="cuda").bfloat16()
    k, v = (torch.randn(50, 1, 5, 64, generator=card, device="cuda").bfloat16()
            for _ in range(2))
    assert torch.equal(attn.dot_product_attention(q, k, v), fa.attention_plain(q, k, v))
