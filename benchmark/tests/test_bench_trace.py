"""The profile reduction on a hand-made event list: busy time as the union
of device intervals within the window, attention device time and the device
time of each of the program's ``op/*`` ranges by the launches' correlation
ids, and the gaps named by the host range open."""

import pytest

from benchmark.harness import trace as tr


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, tid=1, ann=False):
        self._v = (name, dev, start, dur, corr, tid, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_reduce_events_by_hand():
    ev = [
        Ev("bench/window", "CPU", 0, 1000, ann=True),
        Ev("bench/attention", "CPU", 100, 50, ann=True),
        Ev("cudaLaunchKernel", "CPU", 120, 5, corr=7),
        Ev("cudaLaunchKernel", "CPU", 300, 5, corr=8),
        Ev("bench/decode", "CPU", 500, 400, ann=True),
        Ev("attn_kernel", "CUDA", 130, 200, corr=7),
        Ev("other_kernel", "CUDA", 200, 300, corr=8),  # overlaps: union 130..500
        Ev("other_kernel", "CUDA", 800, 100, corr=9),
        Ev("bench/attention", "CUDA", 130, 200, ann=True),  # a device annotation: no work
    ]
    r = tr.reduce_events(ev)
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx((370 + 100) / 1e9)
    assert r["attn_device_s"] == pytest.approx(200 / 1e9)
    assert r["device_by_op"] == {}
    assert r["device_ops"][0] == ["other_kernel", pytest.approx(400 / 1e9)]
    assert r["idle_gaps"] == [["bench/decode", pytest.approx(300 / 1e9)],
                              ["outside bench ranges", pytest.approx(130 / 1e9)],
                              ["outside bench ranges", pytest.approx(100 / 1e9)]]


def test_device_time_by_op_range():
    """Kernels launched inside each ``op/*`` range, by correlation id: a
    launch inside nested ranges counts in each, one inside an outer range of
    the same name after an inner one closed counts, one on a thread with no
    range open does not."""
    ev = [
        Ev("bench/window", "CPU", 0, 1000, ann=True),
        Ev("op/attention", "CPU", 100, 50, ann=True),
        Ev("cudaLaunchKernel", "CPU", 120, 5, corr=7),
        Ev("op/conv3x3", "CPU", 300, 100, ann=True),
        Ev("op/groupnorm", "CPU", 310, 20, ann=True),
        Ev("cudaLaunchKernel", "CPU", 320, 5, corr=8),
        Ev("cudaLaunchKernel", "CPU", 350, 5, corr=9),
        Ev("op/groupnorm", "CPU", 500, 100, ann=True),
        Ev("op/groupnorm", "CPU", 510, 10, ann=True),
        Ev("cudaLaunchKernel", "CPU", 580, 5, corr=10),
        Ev("cudaLaunchKernel", "CPU", 120, 5, corr=11, tid=2),
        Ev("attn_kernel", "CUDA", 130, 200, corr=7),
        Ev("gn_stats", "CUDA", 330, 10, corr=8),
        Ev("conv_kernel", "CUDA", 360, 40, corr=9),
        Ev("gn_apply", "CUDA", 590, 30, corr=10),
        Ev("other_kernel", "CUDA", 700, 50, corr=11),
    ]
    r = tr.reduce_events(ev)
    assert r["device_by_op"] == {"attention": pytest.approx(200e-9),
                                 "conv3x3": pytest.approx(50e-9),
                                 "groupnorm": pytest.approx(40e-9)}
    assert r["attn_device_s"] is None  # no bench/attention range: its reader stays silent
    assert r["idle_gaps"][0][0] == "outside bench ranges"  # op ranges name no gap
