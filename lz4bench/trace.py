"""What a traced window holds, read from ``torch.profiler``'s Chrome trace.

The run wraps its window in a ``record_function`` span named
``lz4bench.window`` and each request in one named after the op's side.
From the trace this module keeps, clipped to the window: the device's
kernels and copies (categories ``kernel``, ``gpu_memcpy``,
``gpu_memset``), and the host events of the thread that sent the requests
(operators, runtime calls and the spans).  The arithmetic the per-layer
metrics share is here: the union of intervals, the idle gaps and what the
host was doing in each.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass

WINDOW = "lz4bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class DeviceOp:
    cat: str
    name: str
    start: float  # microseconds
    end: float
    nbytes: int


@dataclass
class Trace:
    window: tuple[float, float]  # microseconds
    device: list[DeviceOp]
    host: list[tuple[float, float, str]]  # the sending thread's events

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def ops(self, cat: str) -> list[DeviceOp]:
        return [op for op in self.device if op.cat == cat]

    def busy_s(self) -> float:
        """Seconds of the window in which any kernel or copy ran: the union
        of their intervals, so overlapping streams count once."""
        return union([(op.start, op.end) for op in self.device]) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's intervals in which nothing ran on the device."""
        out, at = [], self.window[0]
        for start, end in merged([(op.start, op.end) for op in self.device]):
            if start > at:
                out.append((at, start))
            at = max(at, end)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def device_ops(self, top: int = 10) -> list[list]:
        """``[name, seconds]`` of the device operations that took the most
        time in the window, summed by name."""
        total = defaultdict(float)
        for op in self.device:
            total[op.name] += (op.end - op.start) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """``[name, seconds]``: the device's idle time summed by the innermost
        host event open at the middle of each gap, the names that hold the
        most idle time first."""
        total = defaultdict(float)
        gaps = self.gaps()
        names = innermost([(a + b) / 2 for a, b in gaps], self.host)
        for (a, b), name in zip(gaps, names):
            total[name] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def merged(intervals):
    """Sorted, overlapping intervals merged."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def union(intervals) -> float:
    return sum(end - start for start, end in merged(intervals))


def innermost(points, events) -> list[str]:
    """For each point, the name of the innermost of ``events`` (``(start,
    end, name)``, nested as one thread's are) that holds it, or ``"none"``."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    order = sorted(range(len(points)), key=points.__getitem__)
    out = ["none"] * len(points)
    stack, i = [], 0
    for j in order:
        p = points[j]
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if stack:
            out[j] = stack[-1][2]
    return out


def load(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if len(spans) != 1:
        raise ValueError(f"expected one {WINDOW} span, found {len(spans)}")
    w = spans[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if end <= w0 or start >= w1:
            continue
        if cat in DEVICE_CATS:
            a, b = max(start, w0), min(end, w1)
            nbytes = int(e.get("args", {}).get("bytes", 0))
            if end > start:  # a copy cut at the window's edge keeps its share
                nbytes = round(nbytes * (b - a) / (end - start))
            device.append(DeviceOp(cat, e["name"], a, b, nbytes))
        elif cat in HOST_CATS and e.get("tid") == w["tid"] and e.get("pid") == w["pid"]:
            if e is not w:
                host.append((start, end, e["name"]))
    return Trace((w0, w1), device, host)
