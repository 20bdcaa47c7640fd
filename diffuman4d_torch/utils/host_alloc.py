"""Host allocator tuning for the data path (numpy / glibc only).

Counterpart of ``tune_host_allocator`` in ``diffuman4d_tpu/utils/jax_setup.py``;
nothing else of that module is needed here.
"""

from __future__ import annotations

import os

_ALLOCATOR_TUNED = False


def tune_host_allocator() -> None:
    """Keep multi-MB host buffers on a reusable heap.

    By default glibc serves allocations over 128 KB with a fresh ``mmap``
    and returns them with ``munmap``, so every large numpy temporary (image
    decode, crop/resize, stacking) pays first-touch page faults again.
    Raising the mmap threshold and disabling trim makes the heap's
    high-water mark persistent: each page faults once per process, not once
    per task. Where the ``native/d4dmem`` numpy allocator is built it is
    installed first: big numpy buffers then come from shared anonymous
    mappings with a size-class reuse cache. Those pages have no fork
    copy-on-write, so fork-based multiprocessing must not mutate pre-fork
    arrays (this package only ever spawns fresh interpreters).
    """
    global _ALLOCATOR_TUNED
    if _ALLOCATOR_TUNED:
        return
    _ALLOCATOR_TUNED = True
    try:
        import importlib.util
        import sysconfig

        from numpy._core.multiarray import get_handler_name

        if get_handler_name() == "d4dmem_shared_anon_pool":
            # installed already by another package of this process: loading
            # the extension a second time would re-initialise its pool
            # under live arrays
            raise RuntimeError("d4dmem is installed")
        ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        so = os.path.join(
            os.path.dirname(__file__), "..", "..", "native", "d4dmem",
            f"d4dmem{ext}",
        )
        spec = importlib.util.spec_from_file_location("d4dmem", os.path.abspath(so))
        if spec is not None and os.path.isfile(so):
            d4dmem = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(d4dmem)
            d4dmem.install()
    except Exception:
        pass  # an optimization; fall through to the glibc tuning
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    except Exception:
        pass  # an optimization; never fail over it (non-glibc hosts)
