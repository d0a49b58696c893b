"""The device timeline's arithmetic: busy time as the union of device
intervals inside the entry's calls (overlapping kernels counted once), the
idle gaps by the innermost host span, on a timeline made by hand."""
from __future__ import annotations

import pytest
import torch

from lpbench import tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, end, device, annotation=False):
        self._v = (name, start, end - start, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_merge_and_clip():
    assert tracing._merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3],
                                                                 [5, 9]]
    inside, gaps = tracing._clip([[0, 3], [5, 9]], [(1, 6), (8, 12)])
    assert inside == [(1, 3), (5, 6), (8, 9)]
    assert gaps == [(3, 5), (9, 12)]


def test_timeline_by_hand():
    evs = [
        # two calls of the entry: [0, 100) and [200, 260)
        Event("api.solve_batch", 0, 100, CPU, True),
        Event("api.solve_batch", 200, 260, CPU, True),
        Event("ipm.run_batch", 10, 60, CPU, True),
        Event("kernels.a_matvec", 20, 30, CPU, True),
        # its device-side copy is no activity
        Event("kernels.a_matvec", 20, 30, CUDA, True),
        Event("k1", 20, 40, CUDA), Event("k2", 30, 50, CUDA),   # overlap
        Event("k1", 210, 250, CUDA),
        Event("gen", 150, 190, CUDA),       # between the calls
    ]
    out = tracing.timeline(Prof(evs), "api.solve_batch")
    assert out["device"]["window_s"] == pytest.approx(160e-9)
    assert out["device"]["busy_s"] == pytest.approx(70e-9)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops == {"k1": pytest.approx(60e-9), "k2": pytest.approx(20e-9)}
    gaps = dict(out["breakdown"]["idle_gaps"])
    # [0, 20) half in run_batch, [50, 100) mostly api, [200, 210) and
    # [250, 260) in the call alone
    assert gaps["api.solve_batch"] == pytest.approx((50 + 10 + 10) * 1e-9)
    assert gaps["ipm.run_batch"] == pytest.approx(20e-9)
