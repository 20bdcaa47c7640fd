"""The port's measured attention dispatch on the CPU, against the JAX package.

* The single-pass (B8), batched single-pass (B9) and two-level (B10)
  wrappers on CPU tensors (their plain version) against JAX
  ``flash_attention_v5`` / ``_v6`` / ``_v2`` in Pallas interpret mode (B1/B2
  in ``test_torch_port_attention_d64.py``), at
  the JAX package's own tolerance of 2e-5 (``tests/test_flash_interpret.py``).
* ``_table_lookup`` and ``route`` against the JAX dispatcher on the same
  entries; the staleness and incomplete-sweep warnings of the port's table
  against those of ``tests/test_dispatch_table.py``.
* The tuner's table merge against ``scripts/tune_attention.py``'s.
* The size of the TPU kernels' bf16 prescale of Q, which the port does not
  copy.

Nothing in the JAX package is edited: its module attributes are replaced
with ``monkeypatch`` only.
"""

from __future__ import annotations

import copy
import importlib.util
import inspect
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffuman4d_tpu.ops.attention as jattn
import diffuman4d_tpu.ops.flash_attention as jfa
from diffuman4d_torch.ops import attention as attn
from diffuman4d_torch.ops import flash_attention as fa
from tests.torch_port_helpers import j, n, randn, rng, t

ROOT = Path(__file__).resolve().parents[1]
# the port's kernel name -> the JAX package's impl name in a table entry
JAX_IMPL = {"flash_d64": "pallas_v4", "flash_d512": "pallas", "two_level": "pallas_v2",
            "single_pass": "pallas_v5", "single_pass_batched": "pallas_v6"}


def _qkv(seed, b, sq, sk, h, d=64):
    r = rng(seed)
    return randn(r, b, sq, h, d), randn(r, b, sk, h, d), randn(r, b, sk, h, d)


# ------------------------------------------------- (a) the kernels' wrappers
@pytest.mark.parametrize("sq,sk,bq", [(256, 256, 64), (128, 256, 128), (256, 128, 128),
                                      (64, 64, 64), (512, 512, 128), (128, 1024, 64),
                                      (100, 1000, 128)])
def test_single_pass_matches_jax_v5(sq, sk, bq):
    """B8, Sq != Sk included, against v5 at the same block_q, out to 1,024
    keys; ragged Sk (1,000) and ragged Sq (100, one block of v5's)."""
    q, k, v = _qkv(0, 2, sq, sk, 2)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_v5(j(q), j(k), j(v), block_q=bq)
    got = fa.flash_attention_single_pass(t(q), t(k), t(v), block_q=bq)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("sq,sk,bq,bb", [(256, 256, 64, 2), (256, 256, 128, 3), (128, 128, 64, 6),
                                         (512, 512, 128, 2), (640, 1000, 64, 3),
                                         (1024, 1024, 128, 6)])
def test_single_pass_batched_matches_jax_v6(sq, sk, bq, bb):
    """B9 with block_b dividing b*h = 6 but not b = 2 (block_b 3, 6) or not
    h = 3 (block_b 2, 6) alone, out to 1,024 keys, ragged Sk (1,000)."""
    q, k, v = _qkv(1, 2, sq, sk, 3)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_v6(j(q), j(k), j(v), block_q=bq, block_b=bb)
    got = fa.flash_attention_single_pass_batched(t(q), t(k), t(v), block_q=bq, block_b=bb)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("blocks", [(64, 128, 64), (64, 256, 128), (128, 256, 64)])
def test_two_level_matches_jax_v2(blocks):
    """B10 against v2 (which runs in interpret mode) at the same stagings,
    Sq != Sk, several k-major tiles."""
    q, k, v = _qkv(2, 2, 256, 512, 2)
    bq, kmaj, kin = blocks
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention_v2(j(q), j(k), j(v), block_q=bq, block_k_major=kmaj,
                                      block_k=kin)
    got = fa.flash_attention_two_level(t(q), t(k), t(v), *blocks)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)


def test_wrappers_refuse_launches_their_kernels_were_not_built_for():
    """On any device: the gates are the kernels' limits, not the device's."""
    q = t(randn(rng(3), 1, 300, 2, 64))
    long = t(randn(rng(3), 1, 4100, 2, 64))
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass(q, long, long)  # Sk 4,100 > 4,096
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass(q[:, :64], q[:, :64], q[:, :64], block_q=48)
    with pytest.raises(ValueError):
        fa.flash_attention_single_pass_batched(q[:, :64], q[:, :64], q[:, :64], 64, 3)
    with pytest.raises(ValueError):
        fa.flash_attention_two_level(q, q, q, 64, 512, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_d64(q, q, q, 64, 256, 128)
    before = {name: (f.launches, dict(f.shapes)) for name, f in fa.KERNELS.items()}
    fa.flash_attention_two_level(q, q, q)
    fa.flash_attention_d64(q, q, q)
    fa.flash_attention_single_pass_batched(q[:, :200], q[:, :200], q[:, :200], 64, 2)
    assert before == {name: (f.launches, dict(f.shapes)) for name, f in fa.KERNELS.items()}


@pytest.mark.parametrize("sk,bq,d,bb,ok", [
    (4096, 64, 64, 1, True), (4097, 64, 64, 1, False), (1, 64, 64, 1, True),
    (0, 128, 64, 1, False), (1024, 128, 64, 8, True), (513, 128, 64, 5, True),
    (256, 32, 64, 1, False), (256, 16, 64, 4, False),  # the mma.sync block_q are gone
    (256, 192, 64, 1, False), (256, 64, 512, 1, False), (256, 128, 64, 0, False),
    (4096, 128, 64, 8, True), (100000, 128, 64, 1, False)])
def test_single_pass_gate(sk, bq, d, bb, ok):
    assert fa.single_pass_ok(sk, bq, d, bb) is ok


# ---------------------------------------------- (b) lookup, (c) routing
def _combined_entries():
    """The committed port table's entries and the JAX package's, with the
    JAX impl names mapped to the port's (the lookup reads only the shape)."""
    port = copy.deepcopy(json.loads(attn.TABLE_PATH.read_text())["entries"])
    tpu = json.loads((Path(jattn.__file__).parent / "attention_table.json").read_text())["entries"]
    return port + [{**e, "name": "tpu_" + e["name"], "impl": "flash_d64"} for e in tpu]


@pytest.mark.parametrize("d", [64, 512])
def test_table_lookup_matches_jax(monkeypatch, d):
    entries = _combined_entries()
    monkeypatch.setattr(attn, "_TABLE", entries)
    monkeypatch.setattr(jattn, "_TABLE", copy.deepcopy(entries))
    for s in (64, 200, 256, 1000, 1024, 3000, 4096, 16384, 30000, 65536, 98304):
        for bh in (1, 2, 20, 40, 160, 640, 3000):
            got, want = attn._table_lookup(s, d, bh), jattn._table_lookup(s, d, bh)
            assert (got and got["name"]) == (want and want["name"]), (s, d, bh)
    assert attn._table_lookup(256, 128, 20) is None


# a table in the port's vocabulary at the port's block sizes
ROUTE_TABLE = [
    {"name": "flash", "b": 2, "s": 65536, "h": 10, "d": 64, "impl": "flash_d64",
     "block_q": 128, "block_k_major": 256, "block_k": 128},
    {"name": "two", "b": 2, "s": 16384, "h": 20, "d": 64, "impl": "two_level", "block_q": 128,
     "block_k_major": 256, "block_k": 128},
    {"name": "sp", "b": 32, "s": 256, "h": 20, "d": 64, "impl": "single_pass", "block_q": 64,
     "block_k": 256},
    {"name": "spb", "b": 32, "s": 128, "h": 5, "d": 64, "impl": "single_pass_batched",
     "block_q": 64, "block_k": 128, "block_b": 2},
    {"name": "vae", "b": 2, "s": 16384, "h": 1, "d": 512, "impl": "flash_d512", "block_q": 64,
     "block_k": 64},
]


@pytest.fixture
def both_routes(monkeypatch):
    """(port route, JAX route) on ROUTE_TABLE. The JAX dispatcher runs as on
    a TPU with its kernel functions replaced by recorders (it imports them
    at call time); each recorded call is named by the port kernel it
    stands for."""
    monkeypatch.setattr(attn, "_TABLE", copy.deepcopy(ROUTE_TABLE))
    monkeypatch.setattr(jattn, "_TABLE", [{**e, "impl": JAX_IMPL[e["impl"]]} for e in ROUTE_TABLE])
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def recorder(kind):
        return lambda q, k, v, **kw: (kind, kw)

    for fn, kind in (("flash_attention", "v1"), ("flash_attention_v2", "v2"),
                     ("flash_attention_v3", "v3"), ("flash_attention_v4", "v4"),
                     ("flash_attention_v5", "v5"), ("flash_attention_v6", "v6"),
                     ("flash_attention_bundled", "bundled")):
        monkeypatch.setattr(jfa, fn, recorder(kind))
    monkeypatch.setattr(jattn, "_xla_attention", recorder("xla"))

    def jax_route(q_shape, k_shape):
        def z(shape):  # shapes without memory: the dispatcher reads only .shape
            return np.broadcast_to(np.float32(0), shape)

        kind, kw = jattn.dot_product_attention(z(q_shape), z(k_shape), z(k_shape))
        if kind == "v1":
            return attn.DEFAULT_KERNEL[q_shape[-1]], {}
        if kind in ("v3", "v4"):
            return "flash_d64", None  # the TPU's blocks; the port's come from the entry
        if kind == "v2":
            return "two_level", None  # the JAX route always takes v2's TPU default blocks
        if kind == "v5":
            return "single_pass", {"block_q": kw["block_q"]}
        if kind == "v6":
            return "single_pass_batched", {"block_q": kw["block_q"], "block_b": kw["block_b"]}
        return kind, kw

    return attn.route, jax_route


# (b, s, h, d) with the query length equal to the key length
ROUTE_SHAPES = [
    (2, 65536, 10, 64), (2, 98304, 10, 64), (1, 32768, 10, 64),
    (2, 16384, 20, 64), (2, 24576, 20, 64), (2, 8192, 20, 64),
    (32, 256, 20, 64), (16, 256, 20, 64), (32, 256, 10, 64),
    (32, 128, 5, 64), (16, 128, 10, 64), (32, 64, 5, 64),
    (2, 16384, 1, 512), (4, 16384, 1, 512), (1, 4096, 1, 512),
]


def test_route_matches_the_jax_dispatcher(both_routes):
    """Wherever both packages have the entry's kernel and both gates admit
    the shape: the same kernel, and the same block sizes (the JAX route
    gives v2 no block sizes of the entry)."""
    route, jax_route = both_routes
    for b, s, h, d in ROUTE_SHAPES:
        shape = (b, s, h, d)
        got, want = route(shape, shape), jax_route(shape, shape)
        assert got[0] == want[0], (shape, got, want)
        if want[1] is not None:
            assert got[1] == want[1], (shape, got, want)


# Where the H100 gates and the JAX package's gates differ: (q shape, k length,
# the JAX route, the port's route)
ROUTE_DIFFERS = [
    # v5_vmem_ok admits 5,120 keys; the port's single pass stops at 4,096
    ((32, 256, 20, 64), 5120, ("single_pass", {"block_q": 64}), ("flash_d64", {})),
    # v2 needs S % 2048 == 0 and falls back to v1; the port's B10 masks ragged tiles
    ((2, 15360, 20, 64), 15360, ("flash_d64", {}),
     ("two_level", {"block_q": 128, "block_k_major": 256, "block_k": 128})),
    # v5 needs S % block_q == 0, else (here) XLA attention by the fallback
    # heuristic; the port's kernels mask ragged rows and keys
    ((32, 200, 20, 64), 200, ("xla", {}), ("single_pass", {"block_q": 64})),
    # v6 takes block_q = min(block_q, S); the port keeps block_q and masks
    ((32, 16, 20, 64), 16, ("single_pass_batched", {"block_q": 16, "block_b": 2}),
     ("single_pass_batched", {"block_q": 64, "block_b": 2})),
]


@pytest.mark.parametrize("q_shape,sk,want_jax,want_port", ROUTE_DIFFERS)
def test_route_where_the_gates_differ(both_routes, q_shape, sk, want_jax, want_port):
    route, jax_route = both_routes
    k_shape = (q_shape[0], sk, q_shape[2], q_shape[3])
    assert route(q_shape, k_shape) == want_port
    assert jax_route(q_shape, k_shape) == want_jax


def test_route_defaults_and_cpu_dispatch(monkeypatch):
    """No entry for the head dim, or a gate that refuses: the kernel of the
    head dim. On the CPU every route takes the plain version."""
    monkeypatch.setattr(attn, "_TABLE", [e for e in ROUTE_TABLE if e["d"] == 64])
    assert attn.route((2, 100, 1, 512), (2, 100, 1, 512)) == ("flash_d512", {})
    assert attn.route((32, 256, 20, 64), (32, 5000, 20, 64)) == ("flash_d64", {})
    assert attn.route((2, 65536, 10, 64), (2, 65536, 10, 64)) == (
        "flash_d64", {"block_q": 128, "block_k_major": 256, "block_k": 128})
    assert attn.route((31, 128, 5, 64), (31, 128, 5, 64)) == ("flash_d64", {})  # 155 % 2
    with pytest.raises(ValueError):
        attn.route((1, 8, 1, 128), (1, 8, 1, 128))
    q, k, v = (t(x) for x in _qkv(4, 32, 32, 32, 2))
    want = fa.attention_plain(q, k, v)
    for impl in ("auto", "pallas"):
        torch.testing.assert_close(attn.dot_product_attention(q, k, v, implementation=impl), want)


# ------------------------------------------- (d) the port's table on disk
def _load_table(monkeypatch, tmp_path, mutate):
    data = json.loads(attn.TABLE_PATH.read_text())
    mutate(data)
    p = tmp_path / "attention_table.json"
    p.write_text(json.dumps(data))
    monkeypatch.setattr(attn, "TABLE_PATH", p)
    monkeypatch.setattr(attn, "_TABLE", None)
    try:
        return attn._dispatch_table()
    finally:
        monkeypatch.setattr(attn, "_TABLE", None)


def _stamp_all(data, kernel_hash, candidates_failed=0):
    data["kernel_hash"] = kernel_hash
    for e in data["entries"]:
        e["kernel_hash"] = kernel_hash
        e["candidates_failed"] = candidates_failed


def test_table_is_stamped_with_current_kernel_hash():
    """The committed table: every entry swept on an H100 against today's
    kernel sources, with no failed candidate, covering every hot shape."""
    from diffuman4d_torch.tune_attention import HOT_SHAPES

    data = json.loads(attn.TABLE_PATH.read_text())
    cur = attn.kernel_source_hash()
    for e in data["entries"]:
        assert e.get("kernel_hash", data.get("kernel_hash")) == cur, (
            f"attention_table.json entry {e['name']} is stale — re-run "
            "python -m diffuman4d_torch.tune_attention after editing the kernels")
        assert e["candidates_failed"] == 0 and e["impl"] in fa.KERNELS
    assert "H100" in data["device"] and data["power_limit"].endswith("W")
    assert {e["name"] for e in data["entries"]} == {sh[0] for sh in HOT_SHAPES}


def test_stale_entries_warn(monkeypatch, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger=attn.__name__):
        entries = _load_table(monkeypatch, tmp_path, lambda d: _stamp_all(d, "deadbeef00000000"))
    assert entries, "table should still load"
    assert any("stale" in r.message for r in caplog.records)


def test_partial_resweep_cannot_launder_staleness(monkeypatch, tmp_path, caplog):
    """A fresh table-level stamp must not mask an entry measured under older
    kernel sources: per-entry hashes win."""
    cur = attn.kernel_source_hash()

    def mutate(d):
        _stamp_all(d, cur)
        d["entries"][0]["kernel_hash"] = "0ld0ld0ld0ld0ld0"

    with caplog.at_level(logging.WARNING, logger=attn.__name__):
        entries = _load_table(monkeypatch, tmp_path, mutate)
    stale = [r for r in caplog.records if "stale" in r.message]
    assert stale and entries[0]["name"] in stale[0].getMessage()


def test_incomplete_sweep_warns(monkeypatch, tmp_path, caplog):
    cur = attn.kernel_source_hash()
    with caplog.at_level(logging.WARNING, logger=attn.__name__):
        entries = _load_table(monkeypatch, tmp_path,
                              lambda d: _stamp_all(d, cur, candidates_failed=2))
    assert entries
    assert any("failed candidates" in r.message for r in caplog.records)


def test_fresh_complete_table_does_not_warn(monkeypatch, tmp_path, caplog):
    cur = attn.kernel_source_hash()
    with caplog.at_level(logging.WARNING, logger=attn.__name__):
        entries = _load_table(monkeypatch, tmp_path, lambda d: _stamp_all(d, cur))
    assert entries
    assert not caplog.records


def test_entry_with_a_kernel_the_port_lacks_raises(monkeypatch, tmp_path):
    def mutate(d):
        d["entries"][0]["impl"] = "bundled"

    with pytest.raises(ValueError, match="bundled"):
        _load_table(monkeypatch, tmp_path, mutate)


# ------------------------------------------------------------ (e) the tuner
def _jax_tuner():
    spec = importlib.util.spec_from_file_location("_jax_tune_attention",
                                                  ROOT / "scripts" / "tune_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports jax only inside its functions
    return mod


@pytest.mark.parametrize("old_table", [True, False])
def test_write_table_merges_like_the_jax_tuner(tmp_path, old_table):
    """Per-shape merge; carried-over entries keep their own stamp,
    backfilled from the old table-level one."""
    from diffuman4d_torch.tune_attention import _write_table

    class StubJax:
        @staticmethod
        def devices():
            return [type("Dev", (), {"device_kind": "stub"})()]

    old = {"kernel_hash": "old0", "entries": [
        {"name": "a", "s": 1, "impl": "flash_d64"},
        {"name": "b", "s": 2, "impl": "flash_d64", "kernel_hash": "b000"},
        {"name": "c", "s": 3, "impl": "flash_d64"}]}
    new = [{"name": "b", "s": 2, "impl": "two_level", "kernel_hash": "cur0"},
           {"name": "d", "s": 4, "impl": "single_pass", "kernel_hash": "cur0"}]
    out_j, out_p = tmp_path / "jax.json", tmp_path / "port.json"
    if old_table:
        for p in (out_j, out_p):
            p.write_text(json.dumps(old))
    _jax_tuner()._write_table(str(out_j), copy.deepcopy(new), StubJax, lambda: "cur0")
    _write_table(str(out_p), copy.deepcopy(new), {"device": "NVIDIA H100", "power_limit": "700 W"},
                 lambda: "cur0")
    got, want = json.loads(out_p.read_text()), json.loads(out_j.read_text())
    assert got["entries"] == want["entries"] and got["kernel_hash"] == want["kernel_hash"]
    assert (got["device"], got["power_limit"]) == ("NVIDIA H100", "700 W")


def test_tuner_shapes_and_candidates():
    """The JAX package's hot shapes plus the per-frame 16^2 mid block; every
    candidate is a port kernel at block sizes its gate admits, with no plain
    or library candidate; the single pass qualifies at S <= 4,096."""
    from diffuman4d_torch import tune_attention as ta

    extra = ("2d@16sq_mid", 32, 256, 20, 64)
    assert sorted(ta.HOT_SHAPES) == sorted(_jax_tuner().HOT_SHAPES + [extra])
    single = set()
    for name, b, s, h, d in ta.HOT_SHAPES:
        cands = ta.candidates(b, s, h, d)
        assert f"flash_d{d}" in {impl for impl, _ in cands.values()}
        for cname, (impl, params) in cands.items():
            assert impl in fa.KERNELS and set(params) == set(fa.BLOCK_PARAMS[impl])
            if impl.startswith("single_pass"):
                single.add(name)
                assert fa.single_pass_ok(s, params["block_q"], d, params.get("block_b", 1))
                assert params.get("block_b", 1) < b * h
            if impl == "two_level":
                assert fa.two_level_ok(d, *params.values())
            if impl == "flash_d64":
                assert fa.skew_ok(d, *params.values())
    assert single == {"2d@16sq_mid", "2d@32sq", "2d@64sq", "3d@16sq_mid"}


def test_tuner_exits_2_without_a_card():
    from diffuman4d_torch import tune_attention

    assert not torch.cuda.is_available()
    assert tune_attention.main(["--quick"]) == 2
    assert tune_attention.main(["--verify"]) == 2


# --------------------------------------------- (f) the TPU kernels' prescale
def test_tpu_prescale_deviation_and_the_exact_scale_port():
    """The TPU v3-v6 kernels fold log2(e)/sqrt(d) into Q in the input dtype:
    qs = bf16(q * bf16(log2e / 8)), a softmax temperature 0.18% off in bf16.
    On bf16 inputs with peaked logits (q scaled by 6), measured on the CPU:
    the fp32 function of that form is 1.2e-2 (of the largest output) away
    from the exact-scale function; JAX v5 in interpret mode is 1.17e-2 from
    the exact-scale function and 2.2e-3 (its bf16 output rounding) from its
    own form; the port's single pass on the same bf16 values in fp32 is
    4.5e-7 from the exact-scale function, which it computes."""
    r = rng(2)
    q, k, v = (randn(r, 2, 256, 2, 64) for _ in range(3))
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q * 6.0, k, v))
    f32 = [np.asarray(x, np.float32) for x in (qb, kb, vb)]
    with pltpu.force_tpu_interpret_mode():
        v5 = n(jfa.flash_attention_v5(qb, kb, vb, block_q=64))
    exact = n(jattn._xla_attention(*(j(x) for x in f32)))
    # the TPU form in fp32: bf16 prescaled Q, then base-2 softmax; as exact
    # attention on qs * sqrt(d) / log2(e)
    log2e = 1.4426950408889634
    qs = np.asarray((qb * jnp.asarray(log2e / 8, jnp.bfloat16)).astype(jnp.bfloat16), np.float32)
    tpu_form = n(jattn._xla_attention(j(qs * 8 / log2e), j(f32[1]), j(f32[2])))
    port = n(fa.flash_attention_single_pass(*(t(x) for x in f32)))
    top = np.abs(exact).max()

    def gap(a, b):
        return np.abs(a - b).max() / top

    assert gap(tpu_form, exact) > 5e-3  # the deviation (1.2e-2 measured)
    assert gap(v5, tpu_form) < 0.5 * gap(v5, exact)  # v5 computes the TPU form
    assert gap(port, exact) < 2e-6  # the port computes the exact one (4.5e-7)


# -------------------------------------------------------- repaired faults
def test_build_models_runs_on_the_card_unless_asked_for_the_cpu():
    from diffuman4d_torch.sampling.loader import build_models

    assert inspect.signature(build_models).parameters["device"].default == "cuda"
