#!/usr/bin/env python3
"""Sweep the pq_scan kernel's builds on the card and time them in turns.

    python3 tools/pq_scan_design.py [--baseline TREE] [--no-time]

Builds ``csrc/pq_scan.cu`` at its compile-time knobs through ``-D``
defines (``_build.build_all``, all builds started together) into
``build/kernels/variants/`` (the defaults into ``build/kernels/``, where
the wrapper loads them) and prints each build's registers, spills and
shared memory (``BUILDS``): 16-byte row loads a thread a batch (R1, R2,
R4, R8; one more batch is in flight), 128, 256, 512 and 1024 threads a
block (the defaults: 256 threads, R1), and a diagnostic build that streams
the codes and writes ``out`` without reading the LUT
(``-DPQ_NO_GATHER=1``). Every build has the same C entry,
``pq_scan_f32(codes, code_bytes, lut, out, n, m, k, stream)``, which plans
its own launch. An empty kernel measures the launch floor. With
``--baseline``, an earlier checkout of the repository (put it under
``build/``, which git ignores): its ``csrc/pq_scan.cu`` is built beside
them, and its wrapper ``kernels/pq_scan.py`` is loaded over that build
(its ``_build.load`` answered with it).

Each build (an arm) is checked with ``torch.equal`` against the in-order
plain version (``ref.pq_scan_in_order``) at N = 1, 31, 513, 1037 and
250,000, M = 8, 16, 32, 227, uint8 and int32, codes aligned and one
element off, and out-of-range codes; the diagnostic against the in-order
sum of the codes. Then the arms are timed in turns (arm order, then
reversed), on the device with the host queue held
(``chip_smoke.cuda_time_ms``):

1. one query's scan at ``IVFPQConfig``'s sizes (250,000 rows x 16 codes,
   K = 256), uint8 cold (16 code arrays in turn, 64 MB > the 50 MB L2),
   uint8 warm (one array, L2-resident) and int32 cold;
2. a 2^28-row shard of 16 uint8 codes (4 GiB), as ``chip_smoke.py`` scans
   it, with each arm's share of 3.35 TB/s (back to back: a launch is ~2 ms);
3. with ``--baseline``, the two wrappers, this tree's ``pq_scan.pq_scan``
   and the baseline's, paced by the host's launches as ``chip_smoke.py``
   times them (one query, uint8 cold, no hold), in turns over ROUNDS
   rounds: what a caller of the wrapper waits per scan.

The diagnostics are timed in the same turns: the launch floor (the empty
kernel at the default plan's grid, threads and shared memory) at one
query, the no-gather build on the shard (what streaming the codes alone
reaches), and the defaults and the baseline on codes one byte off
alignment (code-by-code loads, against their 16-byte row loads). Prints
one JSON line with every reading last. Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import subprocess
import sys
import threading
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import pq_scan as pq  # noqa: E402
from repro_torch.perfmodel.rag_model import IVFPQConfig  # noqa: E402

VARIANTS = _build.BUILD_DIR / "variants"
# build: -D defines; each build is one arm
BUILDS = {
    "256 threads R1 (defaults)": (),
    "256 threads R2": ("-DPQ_LOADS=2",),
    "256 threads R4": ("-DPQ_LOADS=4",),
    "256 threads R8": ("-DPQ_LOADS=8",),
    "128 threads R4": ("-DPQ_THREADS=128", "-DPQ_LOADS=4"),
    "512 threads R1": ("-DPQ_THREADS=512",),
    "512 threads R2": ("-DPQ_THREADS=512", "-DPQ_LOADS=2"),
    "1024 threads R1": ("-DPQ_THREADS=1024",),
}
DEFAULTS = "256 threads R1 (defaults)"
DIAGNOSTIC = ("no gather", ("-DPQ_NO_GATHER=1",))
ROUNDS = 4           # host-paced wrapper turns: ABBA, ROUNDS times
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void pq_empty() {}
extern "C" int pq_empty_launch(int grid, int threads, int smem, void* s) {
  static bool done = false;
  if (!done) {
    cudaFuncSetAttribute(pq_empty,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    done = true;
  }
  pq_empty<<<grid, threads, smem, (cudaStream_t)s>>>();
  return (int)cudaGetLastError();
}
"""


def _nvcc(src: Path, so: Path):
    return subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(baseline):
    """({build: library}, baseline library or None, empty-kernel entry),
    every nvcc at once; prints each build's ptxas lines."""
    paths, failed = {}, []

    def one(name, defines):
        try:
            paths[name] = _build.build_all(
                ("pq_scan",), defines,
                _build.BUILD_DIR if name == DEFAULTS else VARIANTS)["pq_scan"]
        except RuntimeError as err:
            failed.append(str(err))
    threads = [threading.Thread(target=one, args=kv)
               for kv in (*BUILDS.items(), DIAGNOSTIC)]
    for t in threads:
        t.start()
    VARIANTS.mkdir(parents=True, exist_ok=True)
    empty_cu = VARIANTS / "pq_empty.cu"
    empty_cu.write_text(EMPTY_CU)
    procs = {"empty": (VARIANTS / "pq_empty.so", _nvcc(
        empty_cu, VARIANTS / "pq_empty.so"))}
    if baseline:
        procs["baseline"] = (VARIANTS / "pq_scan_baseline.so", _nvcc(
            baseline / "src/repro_torch/kernels/csrc/pq_scan.cu",
            VARIANTS / "pq_scan_baseline.so"))
    for t in threads:
        t.join()
    logs = {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, defines in (*BUILDS.items(), DIAGNOSTIC):
        _report(name, _build.ptxas_reports.get(
            " ".join(("pq_scan", *defines)), ""))
    _report("baseline", logs.get("baseline", ""))
    libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
    base = ctypes.CDLL(str(procs["baseline"][0])) if baseline else None
    empty = ctypes.CDLL(str(procs["empty"][0])).pq_empty_launch
    empty.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return libs, base, empty


def _report(name, log):
    for ln in log.splitlines():
        if any(w in ln for w in ("entry function", "registers", "spill",
                                 "smem")):
            print(f"[build] {name}: {ln.strip()}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def arm_fn(lib):
    """A launch of ``lib``'s C entry into a given ``out``."""
    entry = lib.pq_scan_f32
    entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def run(codes, lut, out):
        (n, m), k = codes.shape, lut.shape[1]
        _build.check(entry(codes.data_ptr(), pq.CODE_BYTES[codes.dtype],
                           lut.data_ptr(), out.data_ptr(), n, m, k,
                           _stream()), "pq_scan")
        return out
    return run


def baseline_wrapper(tree: Path, lib: ctypes.CDLL):
    """The baseline tree's ``pq_scan.pq_scan``, its ``_build.load``
    answered with the baseline's build."""
    spec = importlib.util.spec_from_file_location(
        "baseline_pq_scan", tree / "src/repro_torch/kernels/pq_scan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(load=lambda name: lib,
                                       aligned=_build.aligned,
                                       check=_build.check)
    return mod.pq_scan


def codes_at(gen, n, m, k, dtype, offset=0, high=None):
    """(n, m) codes in [0, high or k) whose first element lies ``offset``
    elements past a 16-byte boundary."""
    buf = torch.empty(n * m + 16, device="cuda", dtype=dtype)
    codes = buf[offset:offset + n * m].view(n, m)
    for i in range(0, n, cs.SHARD_CHUNK):
        codes[i:i + cs.SHARD_CHUNK].random_(0, high or k, generator=gen)
    if codes.data_ptr() % 16 != offset * codes.element_size():
        raise AssertionError("allocator gave a buffer off 16-byte alignment")
    return codes


CHECKS = [  # (n, m, k, dtype, offset)
    (1, 16, 256, torch.uint8, 0), (31, 16, 256, torch.uint8, 0),
    (513, 16, 256, torch.uint8, 0), (1037, 16, 256, torch.uint8, 0),
    (250_000, 16, 256, torch.uint8, 0), (250_000, 16, 256, torch.int32, 0),
    (513, 16, 256, torch.int32, 0), (31, 16, 256, torch.int32, 1),
    (4096, 8, 256, torch.uint8, 0), (513, 32, 64, torch.int32, 0),
    (513, 32, 256, torch.uint8, 0), (513, 227, 256, torch.uint8, 0),
    (1000, 16, 256, torch.uint8, 1), (200_000, 16, 256, torch.int32, 0),
]


def check(name, fn, gen, no_gather=False):
    """torch.equal against the in-order plain version over CHECKS and on
    out-of-range codes; the no-gather build against the in-order sum of
    the codes."""
    cases = [(c, torch.randn(c[1], c[2], generator=gen, device="cuda"))
             for c in CHECKS]
    for (n, m, k, dtype, off), lut in cases:
        codes = codes_at(gen, n, m, k, dtype, off)
        got = fn(codes, lut, torch.empty(n, device="cuda"))
        if no_gather:
            want = torch.zeros(n, device="cuda")
            for j in range(m):
                want = want + codes[:, j].float()
        else:
            want = ref.pq_scan_in_order(codes, lut)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: differs from the in-order plain "
                                 f"version at {(n, m, k, dtype, off)}")
    if not no_gather:
        for dtype, k, high in ((torch.int32, 64, 300), (torch.uint8, 64, 256)):
            codes = codes_at(gen, 777, 16, k, dtype, high=high)
            if dtype == torch.int32:
                codes[::3, ::2] = -7
            codes[0] = k                              # a row all out of range
            lut = torch.randn(16, k, generator=gen, device="cuda")
            got = fn(codes, lut, torch.empty(777, device="cuda"))
            if not (torch.equal(got, ref.pq_scan_in_order(codes, lut))
                    and float(got[0]) == 0.0):
                raise AssertionError(f"{name}: out-of-range codes")
    torch.cuda.synchronize()
    print(f"[check] {name}: equal to the in-order plain version on "
          f"{len(CHECKS)} shapes" + ("" if no_gather else
                                     " and out-of-range codes"), flush=True)


def race(arms, inputs, iters, warmup, hold, rounds=1):
    """{arm: [ms, ...]}: each arm in turn, then in reverse, ``rounds``
    times; ``inputs[arm]`` is a list of (codes, lut) cycled between
    launches."""
    times = {a: [] for a in arms}
    for a in (list(arms) + list(reversed(list(arms)))) * rounds:
        fn = arms[a]
        turn = itertools.cycle(inputs[a])
        out = torch.empty(inputs[a][0][0].shape[0], device="cuda")
        times[a].append(cs.cuda_time_ms(
            lambda: fn(*next(turn), out), iters=iters, warmup=warmup,
            hold=hold))
    return times


def show(tag, times, bound_ms):
    for a, xs in times.items():
        print(f"[time] {tag} {a}: " + " / ".join(f"{x:.4f}" for x in xs)
              + f" ms ({bound_ms / min(xs):.3f} of the bound {bound_ms:.4f} "
              f"ms)", flush=True)


def host_paced(baseline, gen, n, m, k, lut):
    """The two wrappers paced by the host's launches at one query, uint8
    cold, in turns; first both held to the in-order plain version."""
    arrays = [codes_at(gen, n, m, k, torch.uint8)
              for _ in range(cs.COLD_ARRAYS)]
    wrappers = {"wrapper (this tree)": pq.pq_scan,
                "wrapper (baseline)": baseline}
    want = ref.pq_scan_in_order(arrays[0], lut)
    for a, fn in wrappers.items():
        if not torch.equal(fn(arrays[0], lut), want):
            raise AssertionError(f"{a}: differs from the in-order plain "
                                 f"version")
    timed = {a: (lambda fn: lambda c, lut_, out: fn(c, lut_))(fn)
             for a, fn in wrappers.items()}
    inputs = {a: [(c, lut) for c in arrays] for a in timed}
    times = race(timed, inputs, iters=10 * len(arrays), warmup=3,
                 hold=False, rounds=ROUNDS)
    show("one query uint8 cold, host-paced", times, cs.bound(
        n * m + 4 * n + 4 * m * k, n * m, cs.PEAK_FP32_FLOPS)[0])
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier checkout to time beside")
    ap.add_argument("--no-time", action="store_true",
                    help="build and check only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pq_scan_design: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    libs, base, empty = build(args.baseline)
    gen = torch.Generator(device="cuda").manual_seed(17)
    arms = {a: arm_fn(libs[a]) for a in BUILDS}
    if base is not None:
        arms["baseline"] = arm_fn(base)
    for a, fn in arms.items():
        check(a, fn, gen)
    no_gather = {DIAGNOSTIC[0]: arm_fn(libs[DIAGNOSTIC[0]])}
    check(DIAGNOSTIC[0], no_gather[DIAGNOSTIC[0]], gen, no_gather=True)
    if args.no_time:
        return 0

    cfg = IVFPQConfig()
    n, m, k = cfg.n_probe * cfg.points_per_probe, cfg.pq_m, cfg.pq_k
    lut = torch.rand(m, k, generator=gen, device="cuda")
    result = {"card": card, "plans": {}}
    for dtype in (torch.uint8, torch.int32):
        for a in BUILDS:
            result["plans"][f"{a} {dtype}"] = pq.plan(
                codes_at(gen, n, m, k, dtype), lut, libs[a])
    print(f"[plan] one query: {json.dumps(result['plans'])}", flush=True)

    def floor(codes, lut_, out):
        p = pq.plan(codes, lut_, libs[DEFAULTS])
        _build.check(empty(p["grid"], p["threads"], p["smem"], _stream()),
                     "empty kernel")
        return out

    for dtype, temp in ((torch.uint8, "cold"), (torch.uint8, "warm"),
                        (torch.int32, "cold")):
        arrays = [codes_at(gen, n, m, k, dtype)
                  for _ in range(cs.COLD_ARRAYS if temp == "cold" else 1)]
        timed = dict(arms)
        inputs = {a: [(c, lut) for c in arrays] for a in timed}
        if dtype == torch.uint8:
            timed["launch floor"] = floor
            inputs["launch floor"] = inputs[next(iter(arms))]
            if temp == "cold":
                off = [codes_at(gen, n, m, k, dtype, 1)
                       for _ in range(cs.COLD_ARRAYS)]
                for a in (DEFAULTS, "baseline"):
                    if a in arms:
                        timed[f"{a}, one byte off"] = arms[a]
                        inputs[f"{a}, one byte off"] = [(c, lut) for c in off]
        nbytes = n * m * arrays[0].element_size() + 4 * n + 4 * m * k
        bound_ms = cs.bound(nbytes, n * m, cs.PEAK_FP32_FLOPS)[0]
        times = race(timed, inputs, iters=3 * len(arrays) if temp == "cold"
                     else 48, warmup=3, hold=True)
        tag = f"one query {dtype} {temp}"
        show(tag, times, bound_ms)
        result[tag] = dict(bound_ms=bound_ms, **times)
        del arrays, inputs

    codes = codes_at(gen, cs.SHARD_ROWS, m, k, torch.uint8)
    off = codes_at(gen, cs.SHARD_ROWS, m, k, torch.uint8, 1)
    timed = dict(arms, **no_gather)
    inputs = {a: [(codes, lut)] for a in timed}
    for a in (DEFAULTS, "baseline"):
        if a in arms:
            timed[f"{a}, one byte off"] = arms[a]
            inputs[f"{a}, one byte off"] = [(off, lut)]
    chunk = slice(0, cs.SHARD_CHUNK)
    want = {c.data_ptr(): ref.pq_scan_in_order(c[chunk], lut)
            for c in (codes, off)}
    for a, fn in timed.items():
        if a == DIAGNOSTIC[0]:
            continue
        c, _ = inputs[a][0]
        got = fn(c, lut, torch.empty(cs.SHARD_ROWS, device="cuda"))
        if not torch.equal(got[chunk], want[c.data_ptr()]):
            raise AssertionError(f"{a}: the shard's first chunk differs")
    del want, got
    nbytes = cs.SHARD_ROWS * m + 4 * cs.SHARD_ROWS + 4 * m * k
    bound_ms = cs.bound(nbytes, cs.SHARD_ROWS * m, cs.PEAK_FP32_FLOPS)[0]
    times = race(timed, inputs, iters=5, warmup=1, hold=False)
    show("shard", times, bound_ms)
    result["shard"] = dict(bound_ms=bound_ms, **times)
    del codes, off, inputs
    torch.cuda.empty_cache()
    if base is not None:
        result["host-paced"] = host_paced(
            baseline_wrapper(args.baseline, base), gen, n, m, k, lut)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
