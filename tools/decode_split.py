#!/usr/bin/env python3
"""Time the decode body at several split widths.

    python3 tools/decode_split.py [--splits 64 128 256] [--no-time]

Builds ``csrc/paged_attention.cu`` and ``csrc/decode_attention.cu`` once per
split width T (``-DDECODE_SPLIT=T``, a define that ``_build``'s hash covers;
all builds started together) and prints each build's registers and spills.
For each T it holds paged decode, dense decode and verify against their
plain versions at the path shape (``chip_smoke.DEC_LENGTHS``, b = 8, 8
heads, 1 kv head, head dim 256, bt = 16) and at lengths straddling T's
boundaries, and checks both bitwise contracts (dense == paged decode,
verify position j == paged decode at lengths + j + 1) with
``torch.equal``. Then it times the widths in turns (T order, then
reversed), each on the device with the host queue held
(``chip_smoke.cuda_time_ms``): paged decode at b = 1, 8 and 32, dense
decode and verify at b = 8, beside one ``scaled_dot_product_attention``
call. Last, the cost of a chunk: at the largest T, one row (b = 1) of
64, 128, ... T tokens, so that one block walks 1, 2, ... chunks; the
slope is one 64-token chunk's time in a block, the intercept the fixed
cost (launch, Q, the table lookup, the merge). Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

NH, KVH, D, BT, MB = 8, 1, 256, 16, 128
S_VER = cs.SPEC_K + 1


def build(splits):
    """{T: (paged decode, verify, dense decode entries)}, every build at
    once; prints each one's registers and spills."""
    paths, failed = {}, []

    def one(split):
        try:
            paths[split] = _build.build_all(
                ("paged_attention", "decode_attention"),
                (f"-DDECODE_SPLIT={split}",))
        except RuntimeError as err:
            failed.append(str(err))
    threads = [threading.Thread(target=one, args=(t,)) for t in splits]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise RuntimeError("\n".join(failed))
    for key, report in sorted(_build.ptxas_reports.items()):
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print(f"[build] {key}: {ln.strip()}")
    out = {}
    for split in splits:
        paged = ctypes.CDLL(str(paths[split]["paged_attention"]))
        dense = ctypes.CDLL(str(paths[split]["decode_attention"]))
        for lib in (paged, dense):
            fn = lib.decode_split_tokens
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != split:
                raise RuntimeError(f"split {split}: library reports {fn()}")
        fns = (paged.paged_decode_attention_bf16,
               paged.paged_verify_attention_bf16, dense.decode_attention_bf16)
        for fn, (n_ptr, n_int) in zip(fns, ((7, 6), (7, 7), (6, 5))):
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
                + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        out[split] = fns
    return out


def paged_caller(fn, split, q, kp, vp, tab, lens, verify=False):
    """A no-argument launch of a paged entry point built at ``split``."""
    b, s, nh, d = q.shape
    bt, kvh, mb = kp.shape[1], kp.shape[2], tab.shape[1]
    out = torch.empty_like(q)
    scratch = _build.decode_scratch(b * s * nh, mb * bt, d, q.device, split)
    ints = (b, s, nh, kvh, d, bt, mb) if verify else (b, nh, kvh, d, bt, mb)

    def run():
        _build.check(fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        tab.data_ptr(), lens.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), *ints, d ** -0.5,
                        torch.cuda.current_stream().cuda_stream),
                     f"split {split} paged")
        return out
    return run


def dense_caller(fn, split, q, k, v, lens):
    b, _, nh, d = q.shape
    S, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    scratch = _build.decode_scratch(b * nh, S, d, q.device, split)

    def run():
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        b, S, nh, kvh, d, d ** -0.5,
                        torch.cuda.current_stream().cuda_stream),
                     f"split {split} dense")
        return out
    return run


def cases(gen, rng, lengths, vlengths, b=8):
    """(paged decode case, verify case, dense case on the paged decode
    case's gathered cache)."""
    pc = cs._paged_case(gen, rng, b, NH, KVH, D, BT, MB, lengths)
    vc = cs._paged_case(gen, rng, b, NH, KVH, D, BT, MB, vlengths, s=S_VER)
    q, kp, vp, tab, lens = pc
    dc = (q, ref.gather_paged_kv(kp, tab), ref.gather_paged_kv(vp, tab),
          lens)
    return pc, vc, dc


def check(split, fns, gen, rng):
    """Each kernel against its plain version and the two contracts, at
    the path's and at straddling lengths."""
    dec, ver, den = fns
    strad = cs.straddle_lengths(split) + [2048, 1537]
    vstrad = cs.straddle_lengths(split) + [2043, 1000]
    for tag, dl, vl in (("path", cs.DEC_LENGTHS, cs.VER_LENGTHS),
                        ("straddling", strad, vstrad)):
        pc, vc, dc = cases(gen, rng, dl, vl)
        got = paged_caller(dec, split, *pc)().clone()
        e1 = cs._check_rows(f"T={split} paged {tag}", got,
                            ref.paged_decode_attention(*pc), dl)
        dense = dense_caller(den, split, *dc)().clone()
        e2 = cs._check_rows(f"T={split} dense {tag}", dense,
                            ref.decode_attention(*dc), dl)
        out = paged_caller(ver, split, *vc, verify=True)().clone()
        e3 = cs.compare(f"T={split} verify {tag}", out,
                        ref.paged_verify_attention(*vc))
        q, kp, vp, tab, vlen = vc
        same = torch.equal(dense, got) and all(
            torch.equal(out[:, j:j + 1], paged_caller(
                dec, split, q[:, j:j + 1].contiguous(), kp, vp, tab,
                vlen + j + 1)()) for j in range(S_VER))
        print(f"[check] T={split} {tag}: max_abs_err / max_row_rel_err "
              f"paged {e1[0]:.3g} / {e1[1]:.3g}, dense {e2[0]:.3g} / "
              f"{e2[1]:.3g}, verify {e3[0]:.3g} / {e3[1]:.3g}; bitwise "
              f"contracts hold: {same}", flush=True)
        if not same:
            raise AssertionError(f"T={split} {tag}: a contract fails")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    built = build(args.splits)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for split, fns in built.items():
        check(split, fns, gen, rng)
    if args.no_time:
        return 0
    order = list(built) + list(reversed(built))
    for b in cs.DEC_BATCHES:
        lens = (cs.DEC_LENGTHS * 4)[:b]
        pc, vc, dc = cases(gen, rng, lens, (cs.VER_LENGTHS * 4)[:b], b)
        runs = {"paged decode": (lambda t: paged_caller(
            built[t][0], t, *pc), cs._sdpa_paged(*pc), cs._decode_work(
                lens, NH, KVH, D, MB * BT, b * MB))}
        if b == 8:
            runs["dense decode"] = (lambda t: dense_caller(
                built[t][2], t, *dc), cs._sdpa_dense(*dc),
                cs._decode_work(lens, NH, KVH, D, MB * BT))
            runs["verify"] = (lambda t: paged_caller(
                built[t][1], t, *vc, verify=True), cs._sdpa_paged(*vc),
                cs._decode_work(cs.VER_LENGTHS, NH, KVH, D, MB * BT, b * MB,
                                S_VER))
        for kernel, (make, library, work) in runs.items():
            ms = {t: [] for t in built}
            for t in order:
                ms[t].append(cs.cuda_time_ms(make(t), iters=50, hold=True))
            lib = cs.cuda_time_ms(library, iters=50, hold=True)
            bound_ms, bound_by = cs.bound(*work, cs.PEAK_BF16_FLOPS)
            print(f"[time] {kernel} b={b}: " + ", ".join(
                f"T={t} " + " / ".join(f"{x:.4f}" for x in xs) + " ms"
                for t, xs in ms.items())
                + f"; sdpa {lib:.4f} ms; bound {bound_ms:.4f} ms "
                f"({bound_by})", flush=True)
        del pc, vc, dc
    top = max(built)
    times = []
    for n in range(64, top + 1, 64):
        pc = cs._paged_case(gen, rng, 1, NH, KVH, D, BT, MB, [n])
        times.append(cs.cuda_time_ms(paged_caller(built[top][0], top, *pc),
                                     iters=50, hold=True))
    chunks = np.arange(1, len(times) + 1)
    fit = ""
    if len(times) > 1:
        slope, icept = np.polyfit(chunks, times, 1)
        fit = (f"; fit {slope * 1e3:.2f} us a chunk + {icept * 1e3:.2f} us "
               f"fixed")
    print(f"[chunk] paged decode T={top}, b=1, one block walking 1.."
          f"{len(times)} chunks: " + ", ".join(
              f"{c * 64} tokens {t:.4f} ms" for c, t in zip(chunks, times))
          + fit, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
