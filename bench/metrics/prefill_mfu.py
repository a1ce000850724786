"""Whole prefill step: model FLOPs of the window's prefills (2 x the
weights a token multiplies, and causal attention) over their device time
x the card's bf16 peak."""
from bench.reduce import mfu, prefill_flops


def read(rec):
    return mfu(rec, prefill_flops(rec, rec.prefills),
               sum(p["dev_ms"] for p in rec.prefills) / 1e3)
