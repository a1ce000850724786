"""Reading the device trace of a traced run (``torch.profiler`` over a part
of the window): device operations as intervals, their union, the idle gaps
between them and what the host was doing in each.

The harness marks its own host phases with ``record_function`` ranges named
``bench.<phase>``; the profiler puts them on the same clock as the device
operations (the host's wall clock in ns), so a gap is labelled by the
innermost phase around its middle. The traced window runs from just after
the profiler starts to just before it stops, read on that clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

Interval = Tuple[str, float, float]          # (name, start s, end s)


def mark(name: str, on: bool):
    """A ``bench.<name>`` range in traced runs, nothing otherwise."""
    return record_function(f"bench.{name}") if on else contextlib.nullcontext()


def _raw(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host ``bench.`` ranges) of a finished profile."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, t1 = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copies of the host ranges are no operations
            user = getattr(e, "is_user_annotation", lambda: False)()
            if name.startswith("bench.") or user:
                continue
            dev.append((name, t0, t1))
        elif name.startswith("bench."):
            host.append((name, t0, t1))
    return dev, host


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no span covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    """What one traced window holds: device operations clipped to the
    window, its length, and the host phases."""

    def __init__(self, dev: List[Interval], host: List[Interval],
                 lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.window_s = hi - lo
        self.ops = [(n, max(a, lo), min(b, hi)) for n, a, b in dev
                    if b > lo and a < hi]
        self.host = host
        self.busy_s = union_s([(a, b) for _, a, b in self.ops])

    def time_of(self, pred) -> float:
        """Union of the intervals of the operations whose name ``pred``
        accepts."""
        return union_s([(a, b) for n, a, b in self.ops if pred(n)])

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, a, b in self.ops:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest idle stretches, each named by the innermost
        host phase around its middle (``host`` where none is open)."""
        out = []
        for a, b in gaps([(x, y) for _, x, y in self.ops], self.lo, self.hi):
            mid = (a + b) / 2
            around = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(around, key=lambda h: h[2] - h[1])[0]
                    if around else "host")
            out.append([name, b - a])
        return sorted(out, key=lambda x: -x[1])[:k]


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started and stopped
    around the traced part of the window."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.lo = self.hi = 0.0

    def start(self) -> float:
        """Start tracing; returns the host monotonic time it began."""
        self.prof.start()
        self.lo = time.time_ns() * 1e-9
        return time.monotonic()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.hi = time.time_ns() * 1e-9
        self.prof.stop()

    def result(self) -> DeviceTrace:
        return DeviceTrace(*_raw(self.prof), self.lo, self.hi)


def warm(device):
    """Load the profiler's device tracing once in set-up: its first start
    takes seconds, which must not fall in the window."""
    kernel_names(lambda: torch.ones(8, device=device).sum())


def kernel_names(fn) -> set:
    """The names of the device operations ``fn()`` launches (profiled
    alone, after one call outside the profile)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, _ = _raw(prof)
    return {n for n, _, _ in dev if not n.startswith("Memcpy")
            and not n.startswith("Memset")}
