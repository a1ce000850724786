#!/usr/bin/env python3
"""Build, check and time variants of flash attention's backward kernel.

    python3 tools/flash_bwd_variants.py VARIANT.cu [VARIANT.cu ...]
                                        [--smoke-only]

Each VARIANT.cu is a copy of ``csrc/flash_attention_bwd.cu`` with one
design change (the C entries unchanged). Builds every variant with the
library's flags and headers (one nvcc each, all started together) into
``build/kernels/variants/`` and prints each kernel's registers and spills
and any ptxas note that ``wgmma``s were serialized (C75xx). Then, one
variant at a time, holds it against ``ref.flash_attention_bwd`` at two
small shapes (d 256 with a group of 8 split over blocks, d 80); with
``--smoke-only`` it stops there. Else it checks and times the variants in
turns (in order, then reversed) at ``chip_smoke.BWD_SHAPES``: the gates
of phase ``train`` (``compare_grads``), two launches ``torch.equal``,
device time with the host queue held (``chip_smoke.cuda_time_ms``)
beside sdpa's backward and the bound, each variant's launch plan, and its
device time by kernel from ``torch.profiler``. A variant is loaded in
place of the library under the unchanged wrapper. Needs one card and
nvcc; run a new variant's first check under ``timeout``: a kernel that
never finishes holds the card until the command is killed.
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
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

OUT = _build.BUILD_DIR / "variants"
SMOKE_SHAPES = ((1, 200, 8, 1, 256, 256), (2, 100, 4, 4, 80, 80))


def build(paths):
    """{name: loaded library}, one nvcc per variant at once; prints each
    kernel's registers and spills and the serialization notes."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {p.stem: subprocess.Popen(
        [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
         str(OUT / f"{p.stem}.so"), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in paths}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (OUT / f"{name}.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        notes = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
        print(f"== {name}: ptxas notes {notes or 'none'}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            m = re.search(r"Function properties for .*?(bwd_\w+?kernel)"
                          r"(?:ILi(\d)ELi(\d))?", ln)
            if m and i + 2 < len(lines):
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
                regs = re.search(r"Used (\d+) registers", lines[i + 2])
                print(f"   {m.group(1)}<{m.group(2)},{m.group(3)}>: "
                      f"{regs.group(1) if regs else '?'} registers, "
                      f"{spill.group(1) if spill else '?'} B spilled")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def use(lib):
    """Load ``lib`` in place of the library under the wrapper."""
    _build._libs["flash_attention_bwd"] = lib
    tfa._fn_bwd = tfa._fn_plan = None


def case(gen, b, s, nh, kvh, dq, dv, causal):
    mk = lambda *shape: torch.randn(                          # noqa: E731
        *shape, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = mk(b, s, nh, dq), mk(b, s, kvh, dq), mk(b, s, kvh, dv)
    do = mk(b, s, nh, dv)
    o, lse = tfa.flash_attention_lse(q, k, v, causal=causal)
    return q, k, v, o, lse, do


def by_kernel(args, causal):
    """Device ms a call by backward kernel, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            tfa.flash_attention_bwd(*args, causal=causal)
        torch.cuda.synchronize()
    return {re.search(r"bwd_[a-z]+", e.key).group(0):
            round(e.device_time_total / e.count / 1e3, 4)
            for e in prof.key_averages() if "bwd_" in e.key}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", type=Path)
    ap.add_argument("--smoke-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    libs = build(args.variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        use(lib)
        for shape in SMOKE_SHAPES:
            inputs = case(gen, *shape, True)
            got = tfa.flash_attention_bwd(*inputs)
            want = ref.flash_attention_bwd(*inputs, True)
            errs = [cs.compare_grads(f"{name} {shape} {n}", g, w)
                    for n, g, w in zip(("dq", "dk", "dv"), got, want)]
            print(f"{name} {shape}: within the gates, (max abs, slab) "
                  f"errors {errs}")
    if args.smoke_only:
        return 0
    print(cs.card_line())
    order = list(libs) + list(libs)[::-1]
    for tag, (b, s, nh, kvh, dq, dv), causal in cs.BWD_SHAPES:
        inputs = case(gen, b, s, nh, kvh, dq, dv, causal)
        want = ref.flash_attention_bwd(*inputs, causal)
        times = {name: [] for name in libs}
        for name in order:
            use(libs[name])
            run = lambda: tfa.flash_attention_bwd(            # noqa: E731
                *inputs, causal=causal)
            got = run()
            for n, g, w in zip(("dq", "dk", "dv"), got, want):
                cs.compare_grads(f"{name} {tag} {n}", g, w)
            if not all(torch.equal(x, y) for x, y in zip(got, run())):
                raise AssertionError(f"{name} {tag}: two launches differ")
            times[name].append(round(cs.cuda_time_ms(run, hold=True), 4))
        sdpa = cs.cuda_time_ms(cs._sdpa_bwd(*inputs[:3], inputs[5], causal),
                               hold=True)
        b_ms, b_by = cs.bound(*cs._bwd_work(b, s, nh, kvh, dq, dv, causal),
                              cs.PEAK_BF16_FLOPS)
        print(f"{tag} ({b}, {s}, {nh}/{kvh}, {dq}/{dv}, causal={causal}): "
              f"sdpa backward {sdpa:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        for name, lib in libs.items():
            use(lib)
            plan = tfa.backward_plan(b, s, s, nh, kvh, dq, dv,
                                     inputs[0].device)
            print(f"   {name}: ms {times[name]}, by kernel "
                  f"{by_kernel(inputs, causal)}, plan {plan}")
        del inputs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
