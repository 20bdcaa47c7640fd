"""Share of the window outside the program's ``task/sliding_denoise`` spans
(``utils/tracing.phase``, reset at the window's start): load waits,
conditions, scatter, round-end checks, decodes and writes not hidden behind a
denoise."""


def read(rec):
    denoise = rec["spans"].get("task/sliding_denoise")
    if denoise is None:
        return None
    return 100.0 * (rec["window_s"] - denoise["total_s"]) / rec["window_s"]
