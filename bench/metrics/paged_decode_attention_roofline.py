"""Kernels (``kernels/csrc/paged_attention.cu``, split and merge): the
least time of the traced window's decode attention (each live row's K and
V up to its length, its q and out, over HBM bandwidth; or its FLOPs over
the bf16 peak) over the device time of ``paged_decode_kernel`` and
``decode_merge_kernel``."""
from bench import work
from bench.reduce import roofline


def read(rec):
    if rec.peak is None:
        return None
    sh = rec.shapes
    least = sum(work.roofline_s(
        2.0 * sh["heads"] * (sh["dq"] + sh["dv"]) * sum(d["ctx"]),
        work.paged_decode_bytes(sh, d["ctx"]), rec.peak)
        for d in rec.decodes if d["traced"]) * sh["attn_layers"]
    return roofline(rec, least, lambda n: "paged_decode_kernel" in n
                    or "decode_merge_kernel" in n)
