"""Kernels (``kernels/csrc/flash_attention.cu``): the least time of the
traced window's prefill attention (per layer the larger of causal Q.K and
P.V FLOPs over the bf16 peak and q, k, v, o bytes over HBM bandwidth)
over the device time of the kernels named ``flash_fwd_kernel``."""
from bench import work
from bench.reduce import roofline


def read(rec):
    if rec.peak is None:
        return None
    sh = rec.shapes
    least = sum(work.roofline_s(work.flash_flops(sh, p["tokens"]),
                                work.flash_bytes(sh, p["tokens"]), rec.peak)
                for p in rec.prefills if p["traced"]) * sh["attn_layers"]
    return roofline(rec, least, lambda n: "flash_fwd_kernel" in n)
