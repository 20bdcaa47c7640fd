"""LayerNorm and the GEGLU gate of ``diffuman4d_torch/ops/layernorm_geglu.py``.

On the CPU: the plain versions are the expressions ``LayerNorm32`` and
``GEGLU`` ran before the routine (copied here as they were), bit for bit; the
gate's routes and counters are checked on meta tensors, which take the kernel
route without a card; the wrappers' refusals; and a plain-PyTorch mirror of
the LayerNorm kernel's arithmetic (its row layout from the source's
constants, per-lane partials in the kernel's order, their xor-butterfly
combine, the two passes) is held to an fp64 LayerNorm in each dtype.

The tests marked ``cuda`` run the kernels against the plain versions on the
card and skip without one. The file imports neither jax nor the shared test
helpers, so on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_layernorm_geglu.py
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffuman4d_torch.models.layers import GEGLU
from diffuman4d_torch.models.transformer import LayerNorm32
from diffuman4d_torch.ops import cuda_build
from diffuman4d_torch.ops import layernorm_geglu as lg
from diffuman4d_torch.utils.tracing import counters

# the transformer widths of both families, and a tiny width the kernels do
# not take (the test models')
WIDTHS = (320, 640, 1280, 12)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
SIGNIFICAND_BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
SOURCE = cuda_build.CSRC / "layernorm_geglu_hopper.cu"
# the output's absolute error floor in every dtype: bf16's ulp at 2^-6 (the
# fp32 rounding of a row's mean, ~1e-6 of |mean| / std in the output's units)
FLOOR = 2.0 ** -13


def _layernorm_before(x, weight, bias, eps):
    """``LayerNorm32.forward`` as the port ran it before the routine."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                        eps).to(x.dtype)


def _geglu_before(proj):
    """``GEGLU.forward`` after its projection, as the port ran it before."""
    hidden, gate = proj.chunk(2, dim=-1)
    return hidden * F.gelu(gate.float()).to(hidden.dtype)


def _rows(seed: int, shape, dtype, spread: float = 0.0):
    """Normal rows, each shifted by its own mean in [-spread, spread] and
    scaled by its own factor in [0.5, 4]."""
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    lead = shape[:-1] + (1,)
    x = x * (0.5 * 8 ** r.random(lead)) + spread * (2 * r.random(lead) - 1)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _params(seed: int, C: int, dtype):
    r = np.random.default_rng(seed)
    w = torch.from_numpy((1 + 0.3 * r.standard_normal(C)).astype(np.float32))
    b = torch.from_numpy((0.3 * r.standard_normal(C)).astype(np.float32))
    return w.to(dtype), b.to(dtype)


def _ulp(v, dtype):
    """dtype's unit in the last place at |v|."""
    _, e = torch.frexp(v.double())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), e - SIGNIFICAND_BITS[dtype])


def _within_one_ulp(got, ref, dtype=torch.bfloat16) -> bool:
    """|got - ref| at most one ulp of dtype at |ref|, or ``FLOOR`` where that
    is larger, elementwise: near zero the fp32 rounding of a row's mean is
    the error, not the last rounding (in bf16: one ulp of max(|ref|, 2^-6))."""
    err = (got.double() - ref.double()).abs()
    return bool((err <= _ulp(ref.abs(), dtype).clamp_min(FLOOR)).all())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_plain_is_the_expression_of_before(C, dtype):
    """The routine's plain version, through ``LayerNorm32`` and directly, is
    the module's old expression bit for bit."""
    x = _rows(C, (2, 7, C), dtype, spread=3.0)
    w, b = _params(C + 1, C, dtype)
    norm = LayerNorm32(C, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(w.float())
        norm.bias.copy_(b.float())
        norm = norm.to(dtype)
        want = _layernorm_before(x, norm.weight, norm.bias, 1e-5)
        assert want.dtype == dtype
        assert torch.equal(norm(x), want)
        assert torch.equal(lg.layer_norm(x, norm.weight, norm.bias, 1e-5), want)
        assert torch.equal(lg.layer_norm_plain(x, w, b, 1e-5), _layernorm_before(x, w, b, 1e-5))


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_geglu_plain_is_the_expression_of_before(C, dtype):
    """The routine's plain version, through ``GEGLU`` (inner 4C, projection
    8C) and directly, is the module's old expression bit for bit."""
    ff = GEGLU(C, 4 * C).to(dtype)
    x = _rows(2 * C, (2, 5, C), dtype)
    proj = 2 * _rows(2 * C + 1, (3, 4, 8 * C), dtype)
    with torch.no_grad():
        assert torch.equal(ff(x), _geglu_before(ff.proj(x)))
        want = _geglu_before(proj)
        assert want.dtype == dtype and want.shape == (3, 4, 4 * C)
        assert torch.equal(lg.geglu(proj), want)
        assert torch.equal(lg.geglu_plain(proj), want)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{SOURCE.name} declares no constexpr int {name}"
    return int(m.group(1))


def layout(C: int, dtype) -> tuple[int, int]:
    """The LayerNorm kernel's (lanes a row, 16-byte vectors a lane) at width
    C, as its entry works them out from the source's ``MAX_LANES`` and
    ``TARGET_VPT``: the fewest lanes (a power of two) that hold the row in
    ``TARGET_VPT`` vectors a lane, at most ``MAX_LANES``."""
    nv = C * torch.finfo(dtype).bits // 128
    lanes = 1
    while lanes < _constant("MAX_LANES") and _constant("TARGET_VPT") * lanes < nv:
        lanes *= 2
    return lanes, -(-nv // lanes)


BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("C,dtype,want", [
    (320, BF, (8, 5)), (640, BF, (16, 5)), (1280, BF, (32, 5)), (320, F16, (8, 5)),
    (1280, F32, (32, 10)), (8, BF, (1, 1)), (72, BF, (2, 5)), (4096, BF, (32, 16)),
    (2048, F32, (32, 16))])
def test_layernorm_layout_holds_the_row(C, dtype, want):
    """The UNet's widths in bf16 put a row on 8 / 16 / 32 lanes of 5 vectors
    each; every row within ``MAX_ROW_BYTES`` fits the kernel's largest
    register file of 16 vectors a lane."""
    lanes, vpt = layout(C, dtype)
    nv = C * torch.finfo(dtype).bits // 128
    assert (lanes, vpt) == want
    assert lanes * (vpt - 1) < nv <= lanes * vpt
    assert _constant("MAX_LANES") * 16 * 16 == lg.MAX_ROW_BYTES
    assert C * torch.finfo(dtype).bits // 8 <= lg.MAX_ROW_BYTES and vpt <= 16


def kernel_mirror(x, weight, bias, eps):
    """The LayerNorm kernel's arithmetic in plain PyTorch: ``layout(C)``
    lanes a row, lane l holding vectors l, l + lanes, ...; each lane sums
    its values in that order in fp32, the lanes' partials are combined by
    the xor butterfly (each step a lane's partial plus its partner's), the
    mean is that total times fp32(1 / C); the squared deviations likewise
    (each step an fma, here in double rounded to fp32); rsqrt(var + eps),
    then fma((x - mean) * rstd, w, b), one rounding to x's dtype."""
    C = x.shape[-1]
    lanes, vpt = layout(C, x.dtype)
    vec = C // (C * torch.finfo(x.dtype).bits // 128)
    nv = C // vec
    xf = x.float().reshape(-1, nv, vec)
    slots = F.pad(xf, (0, 0, 0, lanes * vpt - nv)).reshape(-1, vpt, lanes, vec)
    live = (torch.arange(lanes * vpt) < nv).reshape(vpt, lanes)
    inv_c = torch.tensor(1.0, dtype=torch.float32) / C

    def butterfly(p):
        off = lanes // 2
        while off:
            p = p + p[:, torch.arange(lanes) ^ off]
            off //= 2
        return p[:, :1]

    s = torch.zeros(slots.shape[0], lanes)
    for k in range(vpt):
        for j in range(vec):
            s = torch.where(live[k], s + slots[:, k, :, j], s)
    mean = butterfly(s) * inv_c
    q = torch.zeros_like(s)
    for k in range(vpt):
        for j in range(vec):
            d = (slots[:, k, :, j] - mean).double()
            q = torch.where(live[k], (d * d + q.double()).float(), q)
    rstd = torch.rsqrt(butterfly(q) * inv_c + eps)
    y = ((xf.reshape(-1, C) - mean) * rstd).double() * weight.double() + bias.double()
    return y.float().to(x.dtype).reshape(x.shape)


@pytest.mark.parametrize("C", [320, 640, 1280, 72])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_mirror_is_within_one_ulp_of_fp64(C, dtype):
    """Rows whose means lie up to 100 from zero, 25 times their spread at
    the least: the kernel's two passes over registers keep the variance, and
    its output is within one ulp (of x's dtype) of an fp64 LayerNorm of the
    same inputs, as the plain version is."""
    x = _rows(3 * C, (37, C), dtype, spread=100.0)
    w, b = _params(3 * C + 1, C, dtype)
    ref = F.layer_norm(x.double(), (C,), w.double(), b.double(), 1e-5)
    assert _within_one_ulp(kernel_mirror(x, w, b, 1e-5), ref, dtype)
    assert _within_one_ulp(lg.layer_norm_plain(x, w, b, 1e-5), ref, dtype)


def _recording(monkeypatch):
    calls = []

    def layernorm_kernel(x, weight, bias, eps):
        calls.append(("layernorm", tuple(x.shape), eps))
        return torch.empty_like(x)

    def geglu_kernel(proj):
        calls.append(("geglu", tuple(proj.shape)))
        return proj.new_empty((*proj.shape[:-1], proj.shape[-1] // 2))

    monkeypatch.setattr(lg, "layernorm_kernel", layernorm_kernel)
    monkeypatch.setattr(lg, "geglu_kernel", geglu_kernel)
    return calls


def _delta(before):
    now = counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in
            ("layernorm/kernel", "layernorm/plain", "geglu/kernel", "geglu/plain")}


def test_dispatch_routes_by_device_grad_and_width(monkeypatch):
    """A tensor off the CPU (a meta tensor stands in for a CUDA one) takes
    the kernels, in fp32, bf16 and fp16 and at any width the kernels'
    wrappers then judge, unless grad is enabled and an input (or the norm's
    weight or bias) requires grad, or the width is not a multiple of 8;
    each call counts once as kernel or plain."""
    calls = _recording(monkeypatch)
    norm = LayerNorm32(64, eps=1e-5).to("meta", torch.bfloat16)
    ff = GEGLU(64, 256).to("meta", torch.bfloat16)
    x = torch.empty(2, 5, 64, device="meta", dtype=torch.bfloat16)
    before = counters()
    with torch.no_grad():
        assert norm(x).shape == x.shape
        assert ff(x).shape == (2, 5, 256)
    assert calls == [("layernorm", (2, 5, 64), 1e-5), ("geglu", (2, 5, 512))]
    assert _delta(before) == {"layernorm/kernel": 1, "layernorm/plain": 0, "geglu/kernel": 1,
                              "geglu/plain": 0}
    norm(x)  # grad enabled, the weights require it: plain
    ff(x)  # the projection's output requires grad: plain
    norm.requires_grad_(False)
    norm(x.clone().requires_grad_())  # x requires it
    assert len(calls) == 2
    assert _delta(before) == {"layernorm/kernel": 1, "layernorm/plain": 2, "geglu/kernel": 1,
                              "geglu/plain": 1}
    norm(x)  # grad enabled, nothing requires it: the kernel
    ff.requires_grad_(False)
    ff(x)
    assert calls[2:] == [("layernorm", (2, 5, 64), 1e-5), ("geglu", (2, 5, 512))]
    with torch.no_grad():
        LayerNorm32(12).to("meta", torch.bfloat16)(x[..., :12])  # width 12: plain
        lg.geglu(torch.empty(3, 24, device="meta", dtype=torch.bfloat16))  # inner 12: plain
        LayerNorm32(12).to(torch.bfloat16)(torch.zeros(1, 12, dtype=torch.bfloat16))  # CPU
        GEGLU(64, 256).to(torch.bfloat16)(torch.zeros(1, 64, dtype=torch.bfloat16))
    assert len(calls) == 4
    assert _delta(before) == {"layernorm/kernel": 2, "layernorm/plain": 4, "geglu/kernel": 2,
                              "geglu/plain": 3}
    with torch.no_grad():  # other dtypes, a row above the kernel's: the kernel route
        for dtype in (torch.float32, torch.float16):
            LayerNorm32(64).to("meta", dtype)(x.to(dtype))
            lg.geglu(torch.empty(3, 64, device="meta", dtype=dtype))
        wide = torch.empty(4104, device="meta", dtype=torch.bfloat16)
        lg.layer_norm(torch.empty(2, 4104, device="meta", dtype=torch.bfloat16), wide, wide,
                      1e-5)
    assert [c[:2] for c in calls[4:]] == [("layernorm", (2, 5, 64)), ("geglu", (3, 64)),
                                          ("layernorm", (2, 5, 64)), ("geglu", (3, 64)),
                                          ("layernorm", (2, 4104))]
    assert _delta(before) == {"layernorm/kernel": 5, "layernorm/plain": 4, "geglu/kernel": 4,
                              "geglu/plain": 3}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A dtype the kernels have no code for, a non-contiguous input, a width
    that is not a multiple of 8, a LayerNorm row above ``MAX_ROW_BYTES``,
    parameters of another dtype or shape, an odd GEGLU projection raise
    before any launch; so does a CPU tensor."""
    w, b = _params(0, 320, torch.bfloat16)
    x = torch.zeros(4, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernel takes"):
        lg.layernorm_kernel(x.double(), w.double(), b.double(), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        lg.layernorm_kernel(torch.zeros(320, 4, dtype=torch.bfloat16).t(), w, b, 1e-5)
    with pytest.raises(ValueError, match="multiple of 8"):
        lg.layernorm_kernel(x[:, :12].contiguous(), w[:12], b[:12], 1e-5)
    with pytest.raises(ValueError, match="above"):
        big = torch.zeros(2056)
        lg.layernorm_kernel(torch.zeros(1, 2056), big, big, 1e-5)  # 8,224 bytes a row
    for wrong in ((w.float(), b.float()), (w, b.float()), (w[:312], b[:312])):
        with pytest.raises(ValueError, match="x's dtype"):
            lg.layernorm_kernel(x, *wrong, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        lg.layernorm_kernel(x, w, b, 1e-5)
    proj = torch.zeros(4, 2560, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="odd"):
        lg.geglu_kernel(proj[:, :2559].contiguous())
    with pytest.raises(ValueError, match="kernel takes"):
        lg.geglu_kernel(proj.double())
    with pytest.raises(ValueError, match="contiguous"):
        lg.geglu_kernel(proj[:, :1280])
    with pytest.raises(ValueError, match="multiple of 8"):
        lg.geglu_kernel(proj[:, :24].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        lg.geglu_kernel(proj)
    assert lg.layernorm_kernel.launches == 0 and lg.geglu_kernel.launches == 0


# ---------------------------------------------------------------- the card


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_rows(gen, rows, C, spread, dtype=torch.bfloat16):
    """Rows on the card, each with its own mean in [-spread, spread] and
    scale in [0.5, 4]."""
    m = spread * (2 * torch.rand((rows, 1), generator=gen, device="cuda") - 1)
    s = 0.5 * 8 ** torch.rand((rows, 1), generator=gen, device="cuda")
    return (torch.randn((rows, C), generator=gen, device="cuda") * s + m).to(dtype)


# the cells' heaviest rows (Diffuman4D's batch 32 at 128^2, SVD-xt's 50
# frames at 96^2, at 320 channels), and ragged row counts at every width
# (32 / 16 / 8 rows a LayerNorm block at 320 / 640 / 1,280; 6 / 12 / 25 rows
# a GEGLU block at inner 1,280 / 640 / 320)
CARD_SHAPES = [(524288, 320), (460800, 320), (1001, 320), (1003, 640), (999, 1280),
               (77, 72), (5, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C", CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spread", [8.0, 100.0])
def test_layernorm_kernel_within_one_ulp(gen, rows, C, dtype, spread):
    """The kernel within one ulp of fp64 (of x's dtype, ``FLOOR`` at the
    least; in bf16 of max(|y|, 2^-6)), on rows with means up to 8 and up to
    100 from zero; at the smaller means also within one ulp of the plain
    version (whose fp32 Welford sums drift further at the larger); a second
    launch gives the same bits; the launch and the kernel route are
    counted."""
    x = _card_rows(gen, rows, C, spread, dtype)
    w = (1 + 0.3 * torch.randn((C,), generator=gen, device="cuda")).to(dtype)
    b = (0.3 * torch.randn((C,), generator=gen, device="cuda")).to(dtype)
    before = (lg.layernorm_kernel.launches, counters().get("layernorm/kernel", 0))
    got = lg.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert (lg.layernorm_kernel.launches, counters().get("layernorm/kernel", 0)) == tuple(
        n + 1 for n in before)
    assert (rows, C) in lg.layernorm_kernel.shapes
    assert got.dtype == dtype and got.shape == x.shape
    if spread <= 8:
        assert _within_one_ulp(got, lg.layer_norm_plain(x, w, b, 1e-5), dtype)
    for lo in range(0, rows, 65536):  # fp64 in slices
        ref = F.layer_norm(x[lo:lo + 65536].double(), (C,), w.double(), b.double(), 1e-5)
        assert _within_one_ulp(got[lo:lo + 65536], ref, dtype)
    assert torch.equal(got, lg.layer_norm(x, w, b, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,C", CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_geglu_kernel_is_bit_equal(gen, rows, C, dtype):
    """The kernel gives the plain version's bits in each dtype (the
    projection 8C wide, normal of scale 3, every seventh row's gates of
    scale 12: GELU's bend and its far tails); a second launch the same; the
    launch and the kernel route are counted."""
    proj = (torch.randn((rows, 8 * C), generator=gen, device="cuda") * 3).to(dtype)
    proj[:: 7, 4 * C:] *= 4
    before = (lg.geglu_kernel.launches, counters().get("geglu/kernel", 0))
    got = lg.geglu(proj)
    torch.cuda.synchronize()
    assert (lg.geglu_kernel.launches, counters().get("geglu/kernel", 0)) == tuple(
        n + 1 for n in before)
    assert (rows, 8 * C) in lg.geglu_kernel.shapes
    assert got.dtype == dtype and got.shape == (rows, 4 * C)
    assert torch.equal(got, lg.geglu_plain(proj))
    assert torch.equal(got, lg.geglu(proj))


@pytest.mark.cuda
def test_modules_under_autograd_take_the_plain_versions(gen):
    """Only an autograd call keeps the eager path: gradients flow and no
    kernel launches; without grad both kernels launch, leading dims kept."""
    norm = LayerNorm32(320, eps=1e-5).cuda().bfloat16()
    ff = GEGLU(320, 1280).cuda().bfloat16()
    x = _card_rows(gen, 2 * 9, 320, 1.0).reshape(2, 9, 320).requires_grad_()
    before = (lg.layernorm_kernel.launches, lg.geglu_kernel.launches)
    ff(norm(x)).float().sum().backward()
    assert (lg.layernorm_kernel.launches, lg.geglu_kernel.launches) == before
    assert x.grad is not None and norm.weight.grad is not None and ff.proj.weight.grad is not None
    with torch.no_grad():
        assert ff(norm(x)).shape == (2, 9, 1280)
    assert (lg.layernorm_kernel.launches, lg.geglu_kernel.launches) == tuple(
        n + 1 for n in before)
