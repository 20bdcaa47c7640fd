"""Static checks of the port's kernel bookkeeping, on the CPU (no card, no
compiler): the C entry points and their ctypes types, the sources that the
dispatch table's stamp covers, the stagings the Hopper forward builds, and
the kernel records of ``chip_smoke.py``.

A kernel edited without a re-sweep must leave the dispatch table stale (the
stamp hashes ``attention.KERNEL_SOURCES``), and every wrapper must launch an
entry that ``cuda_build.ENTRIES`` declares with the C prototype's arguments.
"""

from __future__ import annotations

import ast
import importlib.util
import inspect
import re
import shutil
from pathlib import Path

import pytest

from diffuman4d_torch.ops import attention as attn
from diffuman4d_torch.ops import conv, cuda_build
from diffuman4d_torch.ops import flash_attention as fa
from diffuman4d_torch.ops import flash_backward as fb

ROOT = Path(__file__).resolve().parents[1]
CSRC = cuda_build.CSRC
# entry name -> its library
LIBRARY_OF = {fn: lib for lib, fns in cuda_build.ENTRIES.items() for fn in fns}
ALL_ENTRIES = [(lib, fn) for lib, fns in cuda_build.ENTRIES.items() for fn in fns]
WRAPPERS = {**{f"fa.{n}": f for n, f in fa.KERNELS.items()},
            "fb.flash_fwd_lse": fb.flash_fwd_lse, "fb.flash_bwd": fb.flash_bwd,
            "conv.conv3x3": conv.conv3x3}


def _string_constants(fn) -> set[str]:
    tree = ast.parse(inspect.getsource(fn))
    return {node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)}


def _launched(fn) -> tuple[str, str]:
    """(library, entry) a wrapper launches: the one C entry its source
    names, in the library its source names, else ``_launch``'s default."""
    consts = _string_constants(fn)
    entries = consts & set(LIBRARY_OF)
    assert len(entries) == 1, (fn.__name__, entries)
    libs = consts & set(cuda_build.ENTRIES)
    assert len(libs) <= 1, (fn.__name__, libs)
    lib = libs.pop() if libs else inspect.signature(fa._launch).parameters["lib"].default
    return lib, entries.pop()


def _prototype(lib: str, name: str) -> list[str]:
    """Parameter declarations of ``extern "C" int name(...)`` in the source."""
    src = (CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f'{lib}.cu declares no extern "C" int {name}(...)'
    return [p.strip() for p in m.group(1).split(",")]


def test_entry_names_are_unique_and_every_library_has_its_source():
    assert len(LIBRARY_OF) == len(ALL_ENTRIES)
    for lib in cuda_build.ENTRIES:
        assert (CSRC / f"{lib}.cu").is_file(), lib
    assert cuda_build.SOURCES == tuple(cuda_build.ENTRIES)


@pytest.mark.parametrize("lib,name", ALL_ENTRIES)
def test_ctypes_argument_types_match_the_c_prototype(lib, name):
    """Pointers and the stream as void*, sizes as int: a mismatch would cut
    a pointer to 32 bits or shift every later argument."""
    want = [cuda_build._PTR if "*" in p else cuda_build._INT for p in _prototype(lib, name)]
    for p in _prototype(lib, name):
        assert "*" in p or p.startswith("int "), (name, p)
    assert cuda_build.ENTRIES[lib][name] == want


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_every_wrapper_launches_a_declared_entry(wrapper):
    lib, name = _launched(WRAPPERS[wrapper])
    assert LIBRARY_OF[name] == lib, (wrapper, name, lib)
    assert (CSRC / f"{lib}.cu").is_file()


def test_kernel_sources_cover_the_dispatched_kernels_and_every_header():
    """The table's stamp hashes every source whose library an
    ``implementation="auto"`` candidate launches, and every header."""
    listed = set(attn.KERNEL_SOURCES)
    for name, wrapper in fa.KERNELS.items():
        lib, _ = _launched(wrapper)
        assert f"{lib}.cu" in listed, (name, lib)
    assert {p.name for p in CSRC.glob("*.cuh")} <= listed
    assert all((CSRC / f).is_file() for f in listed)
    assert _launched(fa.flash_attention_two_level)[0] == "flash_attn_hopper"
    assert _launched(fb.flash_fwd_lse) == ("flash_attn_hopper", "flash_attn_fwd_lse")


@pytest.mark.parametrize("source", attn.KERNEL_SOURCES)
def test_kernel_source_hash_moves_with_each_listed_source(monkeypatch, tmp_path, source):
    shutil.copytree(CSRC, tmp_path / "csrc")
    monkeypatch.setattr(fa.cuda_build, "CSRC", tmp_path / "csrc")
    before = attn.kernel_source_hash()
    with open(tmp_path / "csrc" / source, "a") as f:
        f.write("\n// edited\n")
    assert attn.kernel_source_hash() != before


def test_hopper_forward_builds_the_two_level_stagings_and_the_lse_staging():
    """The switch of ``flash_attn_fwd_two_level`` builds exactly
    TWO_LEVEL_CONFIGS; the training forward's staging is FWD_LSE_BLOCKS."""
    src = (CSRC / "flash_attn_hopper.cu").read_text()
    body = src[src.index('extern "C" int flash_attn_fwd_two_level'):]
    body = body[: body.index("default:")]
    built = {(c // 1000000, c // 1000 % 1000, c % 1000)
             for c in map(int, re.findall(r"case (\d+):", body))}
    assert built == set(fa.TWO_LEVEL_CONFIGS)
    m = re.search(r"LSE_BLOCK_Q = (\d+), LSE_BLOCK_K_MAJOR = (\d+), LSE_BLOCK_K = (\d+);", src)
    assert m and tuple(map(int, m.groups())) == fb.FWD_LSE_BLOCKS
    assert fb.FWD_LSE_BLOCKS in fa.TWO_LEVEL_CONFIGS


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports torch only inside its functions
    return mod


def test_chip_smoke_kernel_records():
    """Every kernel's source exists and names the TPU kernel it replaces at
    the line of its ``def``; B5 and B10 come from the Hopper file, B1/B2
    from the skewed-pipeline file, B8/B9 from the single-pass file. The
    attention kernels that the table may route sampling shapes to read
    their launches from demo_4d (budgeted, then resumed by the CLI), the
    main path, then the CLI's production demo_3d, the slice, the
    checkpoint variants and the waves phase's wave run, then the tuner and
    last the measurement tools (the units phase), which route no shape to
    B10; B3 and B4 launch on the same sampling paths and in the tools."""
    mod = _chip_smoke()
    meta = mod.KERNEL_META
    assert len(meta) == 9  # ten TPU kernels; B6 and B7 are one fused kernel
    for name, (source, replaces, *_rest, phases) in meta.items():
        assert (ROOT / source).is_file(), name
        path, line = replaces.split(" ")[0].split(":")
        kernel = replaces.split("(")[1].split(")")[0]
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith(f"def {kernel}("), name
    for name in ("flash_fwd_lse", "flash_fwd_two_level"):
        assert meta[name][0] == "diffuman4d_torch/csrc/flash_attn_hopper.cu"
    for name in ("flash_fwd_d64_window", "flash_fwd_d64_frame"):
        assert meta[name][0] == "diffuman4d_torch/csrc/flash_attn_skew_hopper.cu"
    for name in ("flash_fwd_single_pass", "flash_fwd_single_pass_batched"):
        assert meta[name][0] == "diffuman4d_torch/csrc/flash_attn_single_hopper.cu"
    assert mod.PATHS == ("demo4d", "cli", "slice", "variants", "waves")
    assert meta["flash_fwd_two_level"][-1] == (*mod.PATHS, "tune")
    for name in ("flash_fwd_d64_window", "flash_fwd_d64_frame",
                 "flash_fwd_single_pass", "flash_fwd_single_pass_batched"):
        assert meta[name][-1] == (*mod.PATHS, "tune", "units"), name
    for name in ("flash_fwd_d512", "conv3x3"):
        assert meta[name][-1] == (*mod.PATHS, "units")


def test_chip_smoke_fused_backward_record_names_both_tpu_kernels():
    """The one ``flash_bwd`` row stands for B6 and B7: its ``replaces``
    names ``_dkdv_kernel`` and ``_dq_kernel`` at their lines, and its
    launches are read from the train path, then from the measurement
    tools' (the units phase)."""
    meta = _chip_smoke().KERNEL_META
    assert not {"flash_bwd_dkdv", "flash_bwd_dq"} & set(meta)
    source, replaces, key, _, phase = meta["flash_bwd"]
    assert source == "diffuman4d_torch/csrc/flash_attn_bwd.cu" and key == "flash_bwd"
    assert phase == ("train", "units")
    path = ROOT / "diffuman4d_tpu" / "ops" / "flash_backward.py"
    lines = path.read_text().splitlines()
    for kernel in ("_dkdv_kernel", "_dq_kernel"):
        m = re.search(r"flash_backward\.py:(\d+) \(" + kernel + r"\)", replaces)
        assert m, (kernel, replaces)
        assert lines[int(m.group(1)) - 1].startswith(f"def {kernel}("), kernel


def test_fused_backward_block_sizes_match_the_wrapper():
    """The wrapper sizes the per-query-block semaphores with BWD_BLOCK_Q: it
    must be the kernel's BQ; the kernel is the one fused entry with five
    products (no separate dQ or dK/dV entry is left)."""
    src = (CSRC / "flash_attn_bwd.cu").read_text()
    m = re.search(r"constexpr int BQ = (\d+);", src)
    assert m and int(m.group(1)) == fb.BWD_BLOCK_Q
    assert set(cuda_build.ENTRIES["flash_attn_bwd"]) == {"flash_attn_bwd_fused",
                                                         "flash_attn_bwd_probe"}
    assert "atomicAdd(sems, 1)" in src  # the tile counter: the only atomic
    assert src.count("atomicAdd") == 1


def test_vae_kernels_come_from_their_hopper_sources():
    """B3 and B4 launch the entries of their Hopper sources, which
    ``chip_smoke.py``'s records name; the FA2-era ``mma.sync`` sources are
    retired (``flash_attn.cu``, ``flash_attn_single.cu``, ``conv3x3.cu``)."""
    meta = _chip_smoke().KERNEL_META
    assert meta["flash_fwd_d512"][0] == "diffuman4d_torch/csrc/flash_attn_d512.cu"
    assert meta["conv3x3"][0] == "diffuman4d_torch/csrc/conv3x3_hopper.cu"
    assert _launched(fa.flash_attention_d512) == ("flash_attn_d512", "flash_attn_fwd_d512")
    assert _launched(conv.conv3x3) == ("conv3x3_hopper", "conv3x3_fwd")
    for name in ("flash_attn.cu", "flash_attn_single.cu", "conv3x3.cu"):
        assert not (CSRC / name).exists(), name


def test_skew_and_single_pass_build_what_the_wrappers_admit():
    """The switch of ``flash_attn_fwd_skew`` builds exactly SKEW_CONFIGS (its
    default among them); ``flash_attn_single_pass`` builds the two
    SINGLE_PASS_BLOCK_Q and refuses Sk above SINGLE_PASS_MAX_SK, the limit
    of ``single_pass_ok``; both new kernels use TMA and wgmma, no mma.sync."""
    src = (CSRC / "flash_attn_skew_hopper.cu").read_text()
    body = src[src.index('extern "C" int flash_attn_fwd_skew'):]
    body = body[: body.index("default:")]
    built = {(c // 1000000, c // 1000 % 1000, c % 1000)
             for c in map(int, re.findall(r"case (\d+):", body))}
    assert built == set(fa.SKEW_CONFIGS) and fa.SKEW_DEFAULT in built
    assert _launched(fa.flash_attention_d64) == ("flash_attn_skew_hopper", "flash_attn_fwd_skew")
    sp = (CSRC / "flash_attn_single_hopper.cu").read_text()
    body = sp[sp.index('extern "C" int flash_attn_single_pass'):]
    assert {int(c) for c in re.findall(r"case (\d+):", body)} == set(fa.SINGLE_PASS_BLOCK_Q)
    m = re.search(r"constexpr int MAX_SK = (\d+);", sp)
    assert m and int(m.group(1)) == fa.SINGLE_PASS_MAX_SK and "Sk > MAX_SK" in body
    for name in ("single_pass", "single_pass_batched"):
        assert _launched(fa.KERNELS[name]) == ("flash_attn_single_hopper", "flash_attn_single_pass")
    for text in (src, sp):
        assert "tma_load_4d" in text and "wgmma_m64n" in text and "mma_bf16" not in text
