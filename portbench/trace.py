"""The traced window: ``torch.profiler`` over CPU and CUDA activity, spans
from the benchmark's own files, and the reduction of the trace to device
time by kernel, the device's busy time, and idle gaps named by what the
host was doing.

A span is a ``record_function`` named ``portbench.<name>`` around a call
into one of the program's layers (an epoch, a fit, a ``create_mesh``). An
idle gap is an interval of the window in which no kernel or copy ran on the
device; it is named by the innermost span and the innermost CPU operation
running at its midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."
# gaps named one by one, the longest first; the rest are summed as
# "(shorter gaps)"
NAMED_GAPS = 20000
# spans and CPU operations searched backwards for the innermost one
# around a gap
SPAN_SCAN = 64
OP_SCAN = 256


@dataclass
class Trace:
    """Seconds by device operation name, launches by name, the union of
    device activity (``busy_s``), the traced window (``window_s``), and the
    idle gaps summed by label."""

    device_s: dict = field(default_factory=dict)
    device_count: dict = field(default_factory=dict)
    busy_s: float = 0.0
    window_s: float = 0.0
    gaps_s: dict = field(default_factory=dict)

    def kernel_s(self, pattern: str) -> float:
        return sum(s for name, s in self.device_s.items() if pattern in name)

    def kernel_count(self, pattern: str) -> int:
        return sum(c for name, c in self.device_count.items() if pattern in name)

    def total_device_s(self) -> float:
        return sum(self.device_s.values())

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


class Tracer:
    """Profiles from ``start`` to ``stop`` when ``enabled``; ``span`` marks
    a layer call (a no-op when not enabled)."""

    def __init__(self, enabled: bool, device_type: str):
        self.enabled = enabled
        self.device_type = device_type
        self._prof = self._span = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.autograd.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    @property
    def active(self) -> bool:
        return self._span is not None

    def start(self) -> None:
        """Start the profiler and the window's span (when enabled)."""
        if not self.enabled:
            return
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, record_shapes=False, profile_memory=False, with_stack=False)
        self._prof.__enter__()
        self._span = record_function(SPAN_PREFIX + "window")
        self._span.__enter__()

    def stop(self) -> None:
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._span = None

    def reduce(self) -> Trace | None:
        """The trace of the last window, or None when not traced."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType

        tr = Trace()
        device, cpu = [], []
        w0 = w1 = None
        # the profiler's own records, not ``prof.events()``: building those
        # event trees takes minutes for a window of a million operations
        for e in self._prof.profiler.kineto_results.events():
            name, start, end = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
            on_device = e.device_type() == DeviceType.CUDA
            if name.startswith(SPAN_PREFIX) or e.is_user_annotation():
                # the spans, which the profiler also draws on the device's timeline
                if not on_device:
                    if name == SPAN_PREFIX + "window":
                        w0, w1 = start, end
                    cpu.append((start, end, name))
            elif on_device:
                tr.device_s[name] = tr.device_s.get(name, 0.0) + (end - start) * 1e-6
                tr.device_count[name] = tr.device_count.get(name, 0) + 1
                device.append((start, end))
            else:
                cpu.append((start, end, name))
        if w0 is None:
            return tr
        tr.window_s = (w1 - w0) * 1e-6
        device.sort()
        merged = []
        for s, t in device:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        tr.busy_s = sum(t - s for s, t in merged) * 1e-6
        edges = [w0] + [x for st in merged for x in st] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = sorted(c for c in cpu if c[2].startswith(SPAN_PREFIX))
        ops = sorted(c for c in cpu if not c[2].startswith(SPAN_PREFIX))
        index = (spans, [c[0] for c in spans], ops, [c[0] for c in ops])
        for s, t in gaps[:NAMED_GAPS]:
            label = _label(index, (s + t) / 2)
            tr.gaps_s[label] = tr.gaps_s.get(label, 0.0) + (t - s) * 1e-6
        rest = sum(t - s for s, t in gaps[NAMED_GAPS:]) * 1e-6
        if rest:
            tr.gaps_s["(shorter gaps)"] = rest
        return tr


def _innermost(events, starts, at, scan):
    """Name of the latest-starting of ``events`` (sorted by start) that
    contains ``at``, looking back at most ``scan`` events; or None."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(-1, i - scan), -1):
        if events[j][1] >= at:
            return events[j][2]
    return None


def _label(index, at) -> str:
    """"<innermost span>/<innermost CPU operation>" running at ``at``."""
    spans, span_starts, ops, op_starts = index
    span = _innermost(spans, span_starts, at, SPAN_SCAN)
    op = _innermost(ops, op_starts, at, OP_SCAN)
    return f"{span[len(SPAN_PREFIX):] if span else 'none'}/{op or 'no host operation'}"
