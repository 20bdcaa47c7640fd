"""The temporal self-attention kernels' share of their roofline: the least
time of the frames' self-attention sites that the family's work count gives
(``least_s_by_op["temporal_attention"]``: ops at the bf16 peak or bytes at
the HBM rate, whichever binds) over the device seconds of the kernels
launched inside the program's ``op/temporal_attention`` ranges."""


def read(rec):
    t = rec.get("trace") or {}
    dev = (t.get("device_by_op") or {}).get("temporal_attention")
    least = (rec.get("least_s_by_op") or {}).get("temporal_attention")
    if not dev or not least:
        return None
    return 100.0 * least / dev
