"""The profiled part of a window: ``torch.profiler`` over CPU and CUDA,
reduced to the union of device activity, device time by kernel name, and
idle time by the harness span (``portbench.*``) the host was in.

The window's length is the span from the first ``portbench.*`` span's
start to the last one's end, in the profiler's own clock, so device and
host times share one base.
"""
from __future__ import annotations

import bisect
from typing import List, Tuple

from .record import Trace

SPAN_PREFIX = "portbench."
# profiler names kept in a breakdown
NAME_CHARS = 120


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Profiler:
    def __init__(self):
        self._prof = _profile()

    def warm(self):
        """Start and stop once, so that the profiler's own set-up (CUPTI)
        is paid before the window."""
        import torch
        with _profile():
            torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu").sum().item()

    def start(self):
        self._prof.start()

    def stop(self) -> Trace:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        return reduce(self._prof.events())


def _union(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> Trace:
    """A :class:`~.record.Trace` of profiler events (``FunctionEvent``s,
    times in microseconds). Each idle gap of the device is split over the
    harness spans open during it; spans do not nest."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    kernels = {}
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith(SPAN_PREFIX):
                continue        # a span's projection onto the device
            dev.append((s, e))
            kernels[ev.name] = kernels.get(ev.name, 0.0) + (e - s) * 1e-6
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append((s, e, ev.name))
    if not spans:
        raise RuntimeError("the trace holds no portbench span")
    spans.sort()
    w0 = spans[0][0]
    w1 = max(e for _, e, _ in spans)
    busy = _union([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    busy_us = sum(e - s for s, e in busy)
    starts = [s for s, _, _ in spans]
    idle = {}

    def add(name, us):
        if us > 0:
            idle[name] = idle.get(name, 0.0) + us * 1e-6

    def gap(a, b):
        """Split the idle interval ``[a, b)`` over the spans it meets."""
        covered = 0.0
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(spans) and spans[j][0] < b:
            part = min(b, spans[j][1]) - max(a, spans[j][0])
            if part > 0:
                add(spans[j][2], part)
                covered += part
            j += 1
        add("host.outside_spans", (b - a) - covered)

    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gap(prev, s)
        prev = max(prev, e)
    return Trace((w1 - w0) * 1e-6, busy_us * 1e-6, kernels, idle)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the idle time by
    host span, as ``[[name, seconds], ...]``."""
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}
