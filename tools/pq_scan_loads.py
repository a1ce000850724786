#!/usr/bin/env python3
"""The pq_scan kernel's two ways of reading a row, timed against each other
on the card.

    python3 tools/pq_scan_loads.py

``csrc/pq_scan.cu`` reads a row of codes as 16-byte vectors when the row is
a multiple of 16 bytes and the codes start 16-byte aligned, and code by
code otherwise. For uint8 codes at M = 16 the wrapper always hands it an
aligned buffer, so the vector path is the one that runs; this script
reaches the code-by-code path of the same build by passing codes that
start one byte past an aligned address. Each path's output is held against
the plain version, and the two are timed in the order vector, code by code,
code by code, vector at two shapes:

1. one query's scan at ``IVFPQConfig``'s sizes (250,000 rows x 16 uint8
   codes, K = 256), cold: 16 distinct code arrays per path in turn, the
   host queue held as in ``chip_smoke.py``;
2. a shard of 2^28 rows x 16 uint8 codes (4 GiB), as ``chip_smoke.py``
   scans it.

Prints one JSON line with the card and every reading; needs one CUDA card
and the CUDA toolkit (the kernel builds at first use).
"""
from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import pq_scan as pq  # noqa: E402
from repro_torch.perfmodel.rag_model import IVFPQConfig  # noqa: E402

ORDER = ("vector", "bytes", "bytes", "vector")


def _codes(gen, n, m, k, offset):
    """An (n, m) uint8 code array whose first byte lies ``offset`` bytes
    past a 16-byte boundary."""
    buf = torch.empty(n * m + 16, device="cuda", dtype=torch.uint8)
    codes = buf[offset:offset + n * m].view(n, m)
    for i in range(0, n, cs.SHARD_CHUNK):
        codes[i:i + cs.SHARD_CHUNK].random_(0, k, generator=gen)
    if codes.data_ptr() % 16 != offset:
        raise AssertionError("allocator gave a buffer off 16-byte alignment")
    return codes


def _scan(codes, lut, out):
    n, m = codes.shape
    err = pq._entry()(codes.data_ptr(), 1, lut.data_ptr(), out.data_ptr(),
                      n, m, lut.shape[1],
                      torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pq_scan")
    return out


def _held(name, codes, lut, rows):
    """Max abs error of the kernel on ``codes`` over its first ``rows``
    rows against the plain version."""
    out = _scan(codes, lut, torch.empty(codes.shape[0], device="cuda"))
    return cs.compare_fp32(name, out[:rows], ref.pq_scan(codes[:rows], lut))


def _race(arrays, lut, iters, hold, warmup=3):
    """ms of each path in ORDER; ``arrays[path]`` cycled between launches."""
    out = torch.empty(arrays["vector"][0].shape[0], device="cuda")
    times = {"vector": [], "bytes": []}
    for path in ORDER:
        turn = itertools.cycle(arrays[path])
        times[path].append(cs.cuda_time_ms(
            lambda: _scan(next(turn), lut, out), iters=iters, warmup=warmup,
            hold=hold))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("pq_scan_loads: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(13)
    cfg = IVFPQConfig()
    n, m, k = cfg.n_probe * cfg.points_per_probe, cfg.pq_m, cfg.pq_k
    lut = torch.rand(m, k, generator=gen, device="cuda")
    result = {"card": cs.card_line()}

    arrays = {path: [_codes(gen, n, m, k, off)
                     for _ in range(cs.COLD_ARRAYS)]
              for path, off in (("vector", 0), ("bytes", 1))}
    err = {p: _held(f"query {p}", a[0], lut, n) for p, a in arrays.items()}
    result["query"] = dict(rows=n, max_abs_err=err, **_race(
        arrays, lut, iters=3 * cs.COLD_ARRAYS, hold=True))
    del arrays
    print(f"[query] {json.dumps(result['query'])}", flush=True)

    arrays = {path: [_codes(gen, cs.SHARD_ROWS, m, k, off)]
              for path, off in (("vector", 0), ("bytes", 1))}
    err = {p: _held(f"shard {p}", a[0], lut, cs.SHARD_CHUNK)
           for p, a in arrays.items()}
    result["shard"] = dict(rows=cs.SHARD_ROWS, max_abs_err=err, **_race(
        arrays, lut, iters=5, hold=False, warmup=1))
    del arrays
    torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
