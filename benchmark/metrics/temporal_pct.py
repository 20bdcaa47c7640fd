"""Share of the card's busy time spent in the temporal layers: device
seconds of the kernels launched inside the program's ``op/temporal`` ranges
(each temporal resnet with its mix, each temporal transformer block with its
transposes and mix; the harness's ``device_by_op``) over the traced window's
busy seconds. Main-thread ranges only, so the saver thread's temporal
decoder is not in it."""


def read(rec):
    t = rec.get("trace") or {}
    dev = (t.get("device_by_op") or {}).get("temporal")
    if not dev or not t.get("busy_s"):
        return None
    return 100.0 * dev / t["busy_s"]
