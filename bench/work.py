"""The work the benchmark counts from shapes, whatever implements it, and
the card's peaks. FLOPs count a multiply-add as 2; bytes count each input
read once and each output written once, in bf16.

``shapes`` is a family reference's ``work(hf)``: ``matmul_params`` (the
weights a token multiplies, the head included, the experts it is routed
to), ``attn_layers``, ``heads``, ``kv_heads``, ``dq``, ``dv``.
"""
from __future__ import annotations

from typing import Iterable, Optional

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAKS = {"H100": {"flops": 989e12, "bytes_s": 3.35e12}}
BF16 = 2


def peaks(device_name: str) -> Optional[dict]:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def attn_flops_per_ctx(shapes: dict) -> float:
    """Attention FLOPs of one query against one context position, over
    every layer: Q.K and P.V."""
    return 2.0 * shapes["heads"] * (shapes["dq"] + shapes["dv"]) \
        * shapes["attn_layers"]


def prefill_flops(shapes: dict, s: int) -> float:
    """A causal prefill of ``s`` tokens: the weights for every token, and
    query i against positions 0..i."""
    return (2.0 * shapes["matmul_params"] * s
            + attn_flops_per_ctx(shapes) * s * (s + 1) / 2)


def decode_flops(shapes: dict, ctx: Iterable[int]) -> float:
    """One decode pass over rows whose contexts (the new token included)
    are ``ctx``."""
    ctx = list(ctx)
    return (2.0 * shapes["matmul_params"] * len(ctx)
            + attn_flops_per_ctx(shapes) * sum(ctx))


def flash_flops(shapes: dict, s: int) -> float:
    """One layer's causal attention over ``s`` tokens."""
    return 2.0 * shapes["heads"] * (shapes["dq"] + shapes["dv"]) \
        * s * (s + 1) / 2


def flash_bytes(shapes: dict, s: int) -> float:
    """q, k, v read once and o written once, one layer, ``s`` tokens."""
    h, kvh, dq, dv = (shapes["heads"], shapes["kv_heads"], shapes["dq"],
                      shapes["dv"])
    return BF16 * s * (h * dq + kvh * dq + kvh * dv + h * dv)


def paged_decode_bytes(shapes: dict, ctx: Iterable[int]) -> float:
    """One layer's decode attention: each row's K and V up to its length,
    its query read and its output written."""
    h, kvh, dq, dv = (shapes["heads"], shapes["kv_heads"], shapes["dq"],
                      shapes["dv"])
    ctx = list(ctx)
    return BF16 * (sum(ctx) * kvh * (dq + dv) + len(ctx) * h * (dq + dv))


def roofline_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take."""
    return max(flops / peak["flops"], nbytes / peak["bytes_s"])
