"""The reading of a trace: kernels to ranges through the host launch's
correlation id, busy time as a union, idle gaps by the range open at their
start; the spans put back."""

import types

import torch

from portbench import trace


class Evt:
    def __init__(self, name, start, end, device=False, corr=0, link=0, annotation=False):
        self._v = (name, start, end, device, corr, link, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_summary_attributes_kernels_to_ranges():
    ms = 1_000_000
    events = [
        Evt("detector.detect", 0, 10 * ms),
        Evt("aten::bmm", 12 * ms, 13 * ms),
        Evt("cudaLaunchKernel", 1 * ms, 2 * ms, corr=1),
        Evt("cudaLaunchKernel", 12 * ms, 13 * ms, corr=2),
        Evt("cudaLaunchKernel", 20 * ms, 21 * ms, corr=3),
        Evt("void nms_sorted_scan<float>(float4 const*)", 3 * ms, 5 * ms, device=True, corr=1),
        Evt("sm90_gemm", 14 * ms, 15 * ms, device=True, corr=2),
        Evt("crops_kernel", 4 * ms, 6 * ms, device=True, link=3),
        Evt("detector.detect", 3 * ms, 9 * ms, device=True, annotation=True),
    ]
    s = trace.summarize(_prof(events), ["detector.detect", "aten::bmm"], 0.03)
    assert s.kernels == {"nms_sorted_scan": [1, 0.002], "sm90_gemm": [1, 0.001],
                         "crops_kernel": [1, 0.002]}
    assert abs(s.busy_s - 0.004) < 1e-12  # [3, 6] and [14, 15] ms
    assert s.ranges["detector.detect"] == {"count": 1, "host_s": 0.01, "device_s": 0.002,
                                           "period_s": None}
    assert s.ranges["aten::bmm"]["device_s"] == 0.001
    assert s.linked == 1.0 and s.device_events == 3
    assert s.kernel_s("nms_") == (1, 0.002)
    assert s.gaps == {"detector.detect": 0.008}  # 6 -> 14 ms: the range open at 10 ms


def test_spans_wrap_and_close():
    class Thing:
        def go(self, x):
            return x + 1

    t = Thing()
    spans = trace.Spans()
    spans.wrap(t, "go", "thing.go")
    assert t.go(1) == 2 and "go" in vars(t) and spans.names == ["thing.go"]
    spans.close()
    assert "go" not in vars(t) and t.go(1) == 2
    mod = types.SimpleNamespace(fn=lambda: 3)
    spans.wrap(mod, "fn", "mod.fn")
    spans.close()
    assert mod.fn() == 3
