#!/usr/bin/env python3
"""Time the flash_attention kernel at several depths of its K/V ring.

    python3 tools/flash_ring_depth.py [--depths 1 2 3] [--no-time]

Builds ``csrc/flash_attention.cu`` once per ring depth (its ``kStages``,
all builds started together) into ``build/kernels/variants/``. Depth 1 is
a single K/V buffer: the producer refills it only after the consumers are
done with it, so copies and products take turns; from depth 2 the next
tiles' copies run under the current tile's products. Prints each build's
registers and spills, holds each depth against the plain version at the
path's prefill shape and at two ragged shapes, then times the depths in
turns (depth order, then reversed) at (1, s, 8 heads, 1 kv head, 256)
causal over ``chip_smoke.FLASH_SWEEP``, beside one
``scaled_dot_product_attention`` call, each on the device with the host
queue held (``chip_smoke.cuda_time_ms``). Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

RING = re.compile(r"constexpr int kStages = \d+;")


def build(depths):
    """{depth: (entry point, ptxas lines)}, one nvcc per depth at once."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    if len(RING.findall(src)) != 1:
        raise RuntimeError("flash_attention.cu: no single kStages constant")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for depth in depths:
        cu = out / f"flash_attention_ring{depth}.cu"
        cu.write_text(RING.sub(f"constexpr int kStages = {depth};", src))
        so = cu.with_suffix(".so")
        procs[depth] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for depth, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ring depth {depth} build failed:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[depth] = (fn, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built


def caller(fn, q, k, v):
    """A no-argument launch of entry ``fn`` on q, k, v (causal)."""
    b, s, nh, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, t, nh, kvh, d, d, 1, d ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention variant")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ring_depth: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    built = build(args.depths)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for depth, (fn, report) in built.items():
        for ln in report:
            print(f"[ring {depth}] {ln}")
        for shape in ((1, 1024, 8, 1, 256), (2, 65, 8, 2, 256),
                      (2, 1000, 8, 8, 128)):
            q, k, v = cs._flash_case(gen, *shape)
            err, rel = cs.compare(f"ring {depth} {shape}",
                                  caller(fn, q, k, v)(),
                                  ref.flash_attention(q, k, v))
            print(f"[ring {depth}] {shape} causal: max_abs_err={err:.3g} "
                  f"max_row_rel_err={rel:.3g}", flush=True)
    if args.no_time:
        return 0
    order = list(built) + list(reversed(built))
    for s in cs.FLASH_SWEEP:
        q, k, v = cs._flash_case(gen, 1, s, 8, 1, 256)
        ms = {depth: [] for depth in built}
        for depth in order:
            ms[depth].append(cs.cuda_time_ms(
                caller(built[depth][0], q, k, v), hold=True))
        lib = cs.cuda_time_ms(cs._sdpa_flash(q, k, v), hold=True)
        bound_ms, bound_by = cs.bound(*cs._flash_work(1, s, 8, 1, 256),
                                      cs.PEAK_BF16_FLOPS)
        print(f"[time] (1, {s}, 8, 1, 256) causal: " + ", ".join(
            f"ring {depth} " + " / ".join(f"{x:.4f}" for x in xs) + " ms"
            for depth, xs in ms.items())
            + f"; sdpa {lib:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
