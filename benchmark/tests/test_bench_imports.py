"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: each module's top-level name,
compared whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import spec as sp

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "diffuman4d_tpu"}
PROGRAM = "diffuman4d_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in sp.BENCH_DIR.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(sp.BENCH_DIR)))
def test_no_jax_in_the_sources(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((sp.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_imports(path))


def test_loaded_modules_after_importing_the_harness():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.models, "
            "benchmark.reference.data, benchmark.reference.sampling; "
            "assert not [m for m in sys.modules if m.split('.')[0] == %r]; "
            "from benchmark.harness import runner; import diffuman4d_torch.cli; "
            "bad = runner.forbidden_modules(); assert not bad, bad" % (str(sp.ROOT), PROGRAM))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark.harness import runner

    monkeypatch.setitem(sys.modules, "diffuman4d_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_like", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert runner.forbidden_modules() == ["jax.numpy"]


# What only a model family may import: the port's models, schedulers and
# pipeline, and the family's plain reference (``benchmark/families/``)
MODEL_MODULES = ("diffuman4d_torch.models", "diffuman4d_torch.schedulers",
                 "diffuman4d_torch.sampling.pipeline", "benchmark.reference.models",
                 "benchmark.reference.sampling", "benchmark.families")


def _imported_names(path):
    """Every module an import statement of ``path`` names, ``from a import
    b`` as both ``a`` and ``a.b``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", sorted((sp.BENCH_DIR / "harness").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_core_names_no_model_module(path):
    named = [m for m in _imported_names(path)
             if any(m == x or m.startswith(x + ".") for x in MODEL_MODULES)]
    assert not named
