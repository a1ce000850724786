"""Open-loop load: hands the generated requests to the engine when
they are due, runs it one iteration at a time (``run(max_steps=steps +
1)``), and in a traced run records what the per-layer metrics read.

In a traced run ``steps.prefill_step`` and ``CompiledPass.run`` (the
decode pass) are wrapped from here and bracketed by synchronisation, with
CUDA events around them; the profiler traces ``trace_s`` seconds in the
middle of the window. A run with ``--trace 0`` wraps nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from bench import devtrace
from bench.window import Served


class _Clock:
    """Device time of a call: CUDA events on a card, the host clock
    elsewhere (CPU test runs)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn):
        if self.cuda:
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            return out, a.elapsed_time(b)
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3


@dataclass
class Records:
    """What a traced run leaves for the per-layer metrics."""
    iters: List[tuple] = field(default_factory=list)    # (host s, inside s)
    prefills: List[dict] = field(default_factory=list)  # tokens, dev_ms, traced
    decodes: List[dict] = field(default_factory=list)   # ctx, dev_ms, traced
    kv0: Optional[dict] = None
    kv1: Optional[dict] = None
    trace: Optional[devtrace.DeviceTrace] = None
    names: dict = field(default_factory=dict)
    shapes: dict = field(default_factory=dict)
    peak: Optional[dict] = None
    seconds: float = 0.0
    window: object = None                               # run.Window


class _Taps:
    """The wrappers of a traced run. ``in_window`` and ``traced`` are set
    by ``drive``; every call's record says whether it fell in the window
    and in the traced part."""

    def __init__(self, eng, rec: Records, device):
        from repro_torch.engine import graphs
        from repro_torch.models import steps
        self.eng, self.rec, self.clock = eng, rec, _Clock(device)
        self.in_window = self.traced = self.traced_once = False
        self.inside = 0.0
        self._steps, self._graphs = steps, graphs
        self._prefill = steps.prefill_step
        self._run = graphs.CompiledPass.run

    def _timed(self, name, fn):
        t = time.perf_counter()
        with devtrace.mark(name, self.traced):
            out, ms = self.clock(fn)
        self.inside += time.perf_counter() - t
        return out, ms

    def install(self):
        taps = self

        def prefill_step(params, batch, cfg, max_len, *a, **k):
            out, ms = taps._timed(
                "prefill", lambda: taps._prefill(params, batch, cfg, max_len,
                                                 *a, **k))
            if taps.in_window:
                n = next(iter(batch.values())).shape[1]
                taps.rec.prefills.append({"tokens": int(n), "dev_ms": ms,
                                          "traced": taps.traced})
            return out

        def run(self_pass, **arrays):
            if self_pass.name != "decode":
                return taps._run(self_pass, **arrays)
            ctx = [len(r.prompt) + len(r.tokens) for r in taps.eng.active
                   if r is not None and (r.ctx is None
                                         or r.prefilled >= len(r.ctx))]
            out, ms = taps._timed("decode",
                                  lambda: taps._run(self_pass, **arrays))
            if taps.in_window:
                taps.rec.decodes.append({"ctx": ctx, "dev_ms": ms,
                                         "traced": taps.traced})
            return out

        self._steps.prefill_step = prefill_step
        self._graphs.CompiledPass.run = run

    def remove(self):
        self._steps.prefill_step = self._prefill
        self._graphs.CompiledPass.run = self._run


def _busy(eng) -> bool:
    return bool(eng.waiting) or any(a is not None for a in eng.active)


def drive(eng, reqs, ramp: float, seconds: float, drain_s: float,
          device, rec: Optional[Records] = None, trace_s: float = 0.0):
    """Serve ``reqs`` (``traffic.Request``, due times from the start) open
    loop. The window is ``[start + ramp, start + ramp + seconds)``; after
    it the run goes on, arrivals included, until every request due in the
    window has its first token or ``drain_s`` has passed. Returns
    (served, start, w0, w1, end). With ``rec`` the run is traced."""
    device = torch.device(device)
    taps = None
    if rec is not None:
        taps = _Taps(eng, rec, device)
        taps.install()
    prof = devtrace.Profiler() if (rec is not None and trace_s > 0
                                   and device.type == "cuda") else None
    served: List[Served] = []
    stats = getattr(eng, "kv_stats", None)
    start = time.monotonic()
    w0, w1 = start + ramp, start + ramp + seconds
    p0 = w0 + max(0.0, (seconds - trace_s) / 2)
    state = "ramp"
    i = 0
    try:
        while True:
            now = time.monotonic()
            while i < len(reqs) and start + reqs[i].due <= now:
                r = reqs[i]
                i += 1
                try:
                    served.append(Served(start + r.due,
                                         eng.submit(r.prompt, r.max_new)))
                except ValueError:
                    served.append(Served(start + r.due, refused=True))
            if state == "ramp" and now >= w0:
                state = "window"
                if rec is not None:
                    taps.in_window = True
                    rec.kv0 = stats() if stats else None
            if state == "window" and prof is not None and now >= p0 \
                    and rec.trace is None and not taps.traced_once:
                taps.traced_once = True
                p0 = prof.start()
                taps.traced = True
                state = "traced"
            if state == "traced" and now >= p0 + trace_s:
                prof.stop()
                taps.traced = False
                state = "window"
            if now >= w1 and state != "drain":
                if state == "traced":
                    prof.stop()
                    taps.traced = False
                state = "drain"
                if rec is not None:
                    taps.in_window = False
                    rec.kv1 = stats() if stats else None
            if state == "drain":
                pending = any(w0 <= s.due < w1 and not s.refused
                              and s.first is None for s in served)
                if not pending or now >= w1 + drain_s:
                    break
            if _busy(eng):
                taps_on = taps is not None and state in ("window", "traced")
                t = time.perf_counter()
                if taps_on:
                    taps.inside = 0.0
                with devtrace.mark("iteration", taps_on and taps.traced):
                    eng.run(max_steps=eng.steps + 1)
                if taps_on:
                    rec.iters.append((time.perf_counter() - t, taps.inside))
            else:
                nxt = start + reqs[i].due if i < len(reqs) else w1 + drain_s
                with devtrace.mark("wait", taps is not None and taps.traced):
                    time.sleep(max(0.0, min(nxt - now, 0.002)))
    finally:
        if taps is not None:
            taps.remove()
    end = time.monotonic()
    if prof is not None:
        rec.trace = prof.result()
    return served, start, w0, w1, end
