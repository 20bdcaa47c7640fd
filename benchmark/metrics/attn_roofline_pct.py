"""The least time the window's attention work needs (every attention site of
the UNet and VAE, at the bf16 peak or the HBM rate, whichever binds:
``harness/work.py``) over the device time of the kernels launched inside the
port's attention entry (a ``bench/attention`` range, matched by the launches'
correlation ids in the profiler's record)."""


def read(rec):
    t = rec.get("trace") or {}
    dev_s = t.get("attn_device_s")
    if not dev_s or not rec.get("attn_least_s"):
        return None
    return 100.0 * rec["attn_least_s"] / dev_s
