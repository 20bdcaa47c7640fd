"""Milliseconds of conditions a task: the program's
``task/prepare_conditions`` spans (host clock, the card synchronised at
their end) plus its ``cond/chunk`` spans (a streamed chunk's pose features,
timed on the card), summed over the window, over the tasks run. A program
without the spans inside its conditions (``cond/*``) cannot show a streamed
chunk's, and reads nothing."""


def read(rec):
    spans = rec["spans"]
    prep = spans.get("task/prepare_conditions")
    if prep is None or "cond/upload" not in spans or not rec["tasks"]:
        return None
    chunk = spans.get("cond/chunk", {}).get("total_s", 0.0)
    return 1e3 * (prep["total_s"] + chunk) / rec["tasks"]
