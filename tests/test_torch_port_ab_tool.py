"""The A/B tool (``python -m diffuman4d_torch.bench_attention_fwd``) asks a
checkout for this tree's C entries only: for each source of
``cuda_build.ENTRIES`` that the checkout has, that library's entries with
this tree's argument types, and its rows call no other entry. No card is
needed: the tool builds nothing until it runs on one."""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import pytest

from diffuman4d_torch import bench_attention_fwd as ab
from diffuman4d_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]


def _checkout(tmp_path: Path, sources) -> Path:
    """A checkout whose csrc holds ``sources`` (copied from this tree, or
    empty files for retired names) and the shared headers."""
    csrc = tmp_path / "diffuman4d_torch" / "csrc"
    csrc.mkdir(parents=True)
    for header in cuda_build.CSRC.glob("*.cuh"):
        shutil.copy(header, csrc)
    for name in sources:
        src = cuda_build.CSRC / f"{name}.cu"
        if src.is_file():
            shutil.copy(src, csrc)
        else:
            (csrc / f"{name}.cu").write_text("// retired\n")
    return tmp_path


@pytest.mark.parametrize("sources", [
    cuda_build.SOURCES,
    ("flash_attn_bwd",),
    ("flash_attn_hopper", "conv3x3_hopper"),
    # a checkout from before the Hopper redesigns: only B10 / B5 and the
    # backward carry over; its FA2 and mma.sync sources have no entry here
    ("flash_attn", "flash_attn_single", "flash_attn_hopper", "flash_attn_bwd", "conv3x3"),
    ()])
def test_entries_asked_of_a_checkout_are_this_trees_for_its_sources(tmp_path, sources):
    root = _checkout(tmp_path, sources)
    want = {lib: cuda_build.ENTRIES[lib] for lib in sources if lib in cuda_build.ENTRIES}
    assert ab.baseline_entries(root) == want


def test_this_tree_as_its_own_baseline_has_every_entry():
    assert ab.baseline_entries(ROOT) == cuda_build.ENTRIES


def test_rows_call_only_entries_this_tree_lists():
    """Every baseline call of the tool names an entry of ``ENTRIES`` (the
    retired two-launch backward, FA2 and mma.sync entries are gone), and the
    backward row times the fused entry."""
    src = (ROOT / "diffuman4d_torch" / "bench_attention_fwd.py").read_text()
    called = set(re.findall(r'call\("(\w+)"', src))
    listed = {fn for entries in cuda_build.ENTRIES.values() for fn in entries}
    assert called and called <= listed
    assert "flash_attn_bwd_fused" in called
    assert not hasattr(ab, "BASELINE_FWD_ENTRIES") and not hasattr(ab, "BASELINE_BWD_ENTRIES")
