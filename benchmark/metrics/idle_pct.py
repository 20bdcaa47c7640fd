"""Share of the traced window in which no operation ran on the card: one
less the union of the profiler's device intervals over the window."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
