"""Milliseconds per window step: the program's ``task/sliding_denoise`` spans
summed, over the window steps the schedule gives the tasks that ran (windows
per task x denoising steps). A streamed chunk's conditions fall inside."""


def read(rec):
    denoise = rec["spans"].get("task/sliding_denoise")
    if denoise is None or not rec["window_steps"]:
        return None
    return 1e3 * denoise["total_s"] / rec["window_steps"]
