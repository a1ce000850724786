"""Reductions the per-layer metrics share, from a traced run's
``drive.Records``. Each returns None where it finds nothing to read;
shares are in percent."""
from __future__ import annotations

from typing import Optional

from bench import work
from bench.window import gaps_ms, percentile


def prefill_ms_per_ktok(rec) -> Optional[float]:
    """Device ms of ``steps.prefill_step`` per 1,000 prompt tokens over
    the window (CUDA events around each call)."""
    toks = sum(p["tokens"] for p in rec.prefills)
    if not toks:
        return None
    return sum(p["dev_ms"] for p in rec.prefills) / toks * 1e3


def decode_flops(rec, decodes) -> float:
    return sum(work.decode_flops(rec.shapes, d["ctx"]) for d in decodes)


def prefill_flops(rec, prefills) -> float:
    return sum(work.prefill_flops(rec.shapes, p["tokens"]) for p in prefills)


def mfu(rec, flops: float, seconds: float) -> Optional[float]:
    if rec.peak is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * rec.peak["flops"])


def kernel_time(rec, pred) -> Optional[float]:
    """Seconds of the traced window in which a device operation that
    ``pred`` accepts ran."""
    if rec.trace is None:
        return None
    t = rec.trace.time_of(pred)
    return t if t > 0 else None


def roofline(rec, least_s: float, pred) -> Optional[float]:
    t = kernel_time(rec, pred)
    if t is None or rec.peak is None or least_s <= 0:
        return None
    return 100.0 * least_s / t


def host_ms_per_iter(rec) -> Optional[float]:
    """Host ms of each ``run(max_steps=steps + 1)`` iteration in the
    window outside ``steps.prefill_step`` and the decode pass's
    ``CompiledPass.run``."""
    if not rec.iters:
        return None
    return sum(t - inside for t, inside in rec.iters) / len(rec.iters) * 1e3


def decode_pass_ms(rec) -> Optional[float]:
    """Mean CUDA-event ms of a decode pass's replay in the window."""
    if not rec.decodes:
        return None
    return sum(d["dev_ms"] for d in rec.decodes) / len(rec.decodes)


def decode_pass_mfu(rec) -> Optional[float]:
    """Model FLOPs of the window's decode passes over their device time x
    the bf16 peak."""
    return mfu(rec, decode_flops(rec, rec.decodes),
               sum(d["dev_ms"] for d in rec.decodes) / 1e3)


def device_idle_share(rec) -> Optional[float]:
    """Share of the traced window with no operation on the card: the
    union of the device intervals, not their sum."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def itl_ms(rec, p: float) -> Optional[float]:
    """The ``p``-th percentile of the traced run's gaps between streamed
    tokens that end in the window (host clock)."""
    g = gaps_ms(rec.window.served, rec.window.w0, rec.window.w1)
    return percentile(g, p) if g else None
