#!/usr/bin/env python3
"""What one card cannot show, on a host with two or more H100s:

    python3 tools/disagg_cards.py [--parent TREE]

1. every kernel (flash, paged decode, verify, dense decode, paged chunk
   attention, the PQ scan) launched on card 0 and then on cards 1 and
   n - 1 with card 0 current, each held against its plain version (the
   scan bit for bit against the in-order one): the per-device opt-ins of
   the C entries (``csrc/per_device.cuh``) and the wrappers' device scope;
2. with ``--parent``, an earlier checkout's flash and paged decode
   wrappers in the same situation, in a subprocess (unpack it with ``git
   archive`` under ``build/``, which is git-ignored);
3. the disaggregated engine at the full width of ``gemma_2b.CONFIG`` with
   each role on cards of its own (``handoff_devices``): 1+1 with full
   handoffs and 1+2 global with layerwise ones, each against the single
   paged Engine's streams on card 0, with its handoff bytes and seconds,
   the link fitted to its samples, tok/s, TTFT and TPOT.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PARENT = r'''
import sys, torch, numpy as np
sys.path.insert(0, "src")
from repro_torch.kernels import ops, ref
g = torch.Generator(device="cuda").manual_seed(0)
mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
q, k, v = mk(1, 256, 8, 256), mk(1, 256, 1, 256), mk(1, 256, 1, 256)
tab = torch.arange(64, device="cuda", dtype=torch.int32).view(4, 16)
lens = torch.tensor([250, 1, 100, 17], device="cuda", dtype=torch.int32)
cases = {
    "flash": (ops.flash_attention, ref.flash_attention, (q, k, v)),
    "paged decode": (ops.paged_decode_attention, ref.paged_decode_attention,
                     (mk(4, 1, 8, 256), mk(65, 16, 1, 256),
                      mk(65, 16, 1, 256), tab, lens)),
}
for name, (kernel, plain, args) in cases.items():
    kernel(*args); torch.cuda.synchronize()
    print(f"parent {name} on cuda:0 (current): ok", flush=True)
    args1 = [t.to("cuda:1") for t in args]
    try:
        out = kernel(*args1)
        torch.cuda.synchronize(1)
        err = float((out.float() - plain(*args1).float()).abs().max())
        print(f"parent {name} on cuda:1, current cuda:0: ran, max abs err "
              f"{err}", flush=True)
    except Exception as e:
        print(f"parent {name} on cuda:1, current cuda:0: raised "
              f"{type(e).__name__}: {e}", flush=True)
'''


def kernels_on(dev, gen, rng):
    """Each kernel on ``dev`` (current device stays cuda:0) against its
    plain version on the same inputs."""
    to = lambda xs: [x.to(dev) for x in xs]  # noqa: E731
    q, k, v = to(cs._flash_case(gen, 1, 1024, 8, 1, 256))
    rows = {"flash_attention": cs.compare(
        "flash", ops.flash_attention(q, k, v), ref.flash_attention(q, k, v))}
    lens = cs.DEC_LENGTHS
    case = to(cs._paged_case(gen, rng, 8, 8, 1, 256, 16, 128, lens))
    rows["paged_decode_attention"] = cs.compare(
        "paged decode", ops.paged_decode_attention(*case),
        ref.paged_decode_attention(*case))
    case = to(cs._paged_case(gen, rng, 8, 8, 1, 256, 16, 128,
                             cs.VER_LENGTHS, s=5))
    rows["paged_verify_attention"] = cs.compare(
        "verify", ops.paged_verify_attention(*case),
        ref.paged_verify_attention(*case))
    case = to(cs._dense_case(gen, 8, 2048, 8, 1, 256, lens))
    rows["decode_attention"] = cs.compare(
        "dense decode", ops.decode_attention(*case),
        ref.decode_attention(*case))
    case = to(cs._chunk_case(gen, rng, 256))
    rows["paged_chunk_attention"] = cs.compare(
        "chunk", ops.paged_chunk_attention(*case),
        ref.paged_chunk_attention(*case))
    codes = torch.randint(0, 256, (250_000, 16), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.uint8)
    lut = torch.randn(16, 256, generator=gen, device="cuda")
    codes, lut = codes.to(dev), lut.to(dev)
    got = ops.pq_scan(codes, lut)
    torch.cuda.synchronize(dev)
    rows["pq_scan"] = torch.equal(got, ref.pq_scan_in_order(codes, lut))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier checkout to hold against")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"needs two cards or more, found {n}")
    cs.log(f"[cards] {n} cards: " + ", ".join(
        torch.cuda.get_device_name(i) for i in range(n)))
    cs.log(cs.card_line())
    cs.phase_build()
    torch.cuda.set_device(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for dev in ("cuda:0", "cuda:1", f"cuda:{n - 1}"):
        rows = kernels_on(torch.device(dev), gen, rng)
        cs.log(f"[cards] kernels on {dev} (current cuda:"
               f"{torch.cuda.current_device()}): {rows}")
        if rows["pq_scan"] is not True:
            raise AssertionError(f"pq_scan on {dev} differs from in-order")
    if args.parent:
        out = subprocess.run([sys.executable, "-c", PARENT], cwd=args.parent,
                             capture_output=True, text=True, timeout=600)
        cs.log(out.stdout.strip())
        cs.log(f"[cards] parent subprocess exit {out.returncode}; stderr "
               f"tail: {out.stderr.strip()[-600:]}")

    from repro_torch.configs import gemma_2b
    from repro_torch.perfmodel.regression import fit_link_spec
    cfg = gemma_2b.CONFIG
    params = cs.full_width_params(cfg)
    prompts = cs._requests(cfg)
    cs._serve(cs._engine(cfg, params), prompts[:1], max_new=2)
    t0 = time.monotonic()
    done = cs._serve(cs._engine(cfg, params), prompts)
    wall = time.monotonic() - t0
    want = cs._streams(done)
    toks = sum(len(r.tokens) for r in done)
    t, p = cs._means_ms(done)
    cs.log(f"[cards] single paged Engine (cuda:0, graphed): tok/s "
           f"{toks / wall:.2f}, TTFT mean {t:.2f} ms, TPOT mean {p:.2f} ms")
    for tag, kw in (("1+1 full", {}),
                    ("1+2 global layerwise",
                     dict(n_decode=2, mode="global",
                          granularity="layerwise"))):
        tag = f"cards {tag}"
        eng = cs._disagg(cfg, params, own_cards=True, **kw)
        cs._serve(eng, prompts[:1], max_new=2)                 # warm-up
        eng = cs._disagg(cfg, params, own_cards=True, **kw)
        t0 = time.monotonic()
        done = cs._serve(eng, prompts)
        for d in range(n):
            torch.cuda.synchronize(d)
        wall = time.monotonic() - t0
        ts = eng.transfer_stats()
        cs.log(f"[{tag}] prefill on "
               f"{[str(w.device) for w in eng.prefill]}, decode on "
               f"{[str(w.device) for w in eng.decode]}; passes "
               f"{sorted(eng.passes())}")
        cs._handoff_line(tag, ts)
        cs._check_streams(tag, cfg, params, prompts, want, cs._streams(done))
        t, p = cs._means_ms(done)
        cs.log(f"[{tag}] tok/s {toks / wall:.2f}, TTFT mean {t:.2f} ms, "
               f"TPOT mean {p:.2f} ms")
        link = fit_link_spec(ts["samples"], "peer")
        cs.log(f"[{tag}] link fitted to {len(ts['samples'])} samples: "
               f"latency {link.latency * 1e6:.2f} us, bandwidth "
               f"{link.bandwidth / 1e9:.3f} GB/s")
        if not ts["cross_device"]:
            raise AssertionError(f"{tag}: no handoff crossed cards")
        del eng
    cs.log("[cards] ok")


if __name__ == "__main__":
    main()
