"""Share of the window in which the sampler's main thread waited for its
saver thread (the program's ``task/save_wait`` spans, ``utils/tracing.phase``:
the decodes and JPEG writes not hidden behind a denoise, joined before a
checkpoint, a grid check or the end of the run)."""


def read(rec):
    wait = rec["spans"].get("task/save_wait")
    if wait is None:
        return None
    return 100.0 * wait["total_s"] / rec["window_s"]
