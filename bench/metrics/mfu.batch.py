"""Whole step: model FLOPs of every prefill and decode token of the window
over the window's seconds x the card's bf16 peak."""
from bench.reduce import decode_flops, mfu, prefill_flops


def read(rec):
    return mfu(rec, decode_flops(rec, rec.decodes)
               + prefill_flops(rec, rec.prefills), rec.seconds)
