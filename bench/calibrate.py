"""One-off readings that set a cell's parameters; the benchmark's own runs
do not run them. Every rate and seed in one process, one line of JSON each.

    python3 bench/calibrate.py --workload <cell> --sweep R1 R2 ... \\
        --seeds A B C --seconds S
        the knee: the cell's mix at each rate (requests a second) on each
        seed; the tails, and the waiting queue (requests due and without a
        first token) averaged over each third of the window. A rate's
        queue grows where the last third's mean exceeds the first third's
        on every seed; the knee is the highest rate tried below the
        lowest one whose queue grows.
    python3 bench/calibrate.py --workload <cell> --control \\
        --seeds A B C ... --seconds S
        ``correct``'s readings on each seed: the program's numbers and the
        fp8 control's on the same requests, each judged at the cell's
        limits as a run judges them (``check.control``)

Needs a CUDA card, as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import check, drive, traffic, weights  # noqa: E402
from bench.run import build_engine, load_cell, port_config, warm_up  # noqa: E402
from bench.window import gaps_ms, percentile, ttfts_ms  # noqa: E402

SWEEP_DRAIN_S = 10.0


def _model(cell, seed, device, cfg=None):
    from repro_torch.models import transformer
    cfg = port_config(cell.hf, cfg)
    return cfg, weights.make(transformer.param_shapes(cfg), seed, device,
                             getattr(torch, cfg.param_dtype))


def _serve(cell, eng, mix, seed, seconds, device):
    horizon = mix["ramp_s"] + seconds + mix["drain_s"]
    reqs = traffic.generate(mix, seed, horizon, cell.hf["vocab_size"])
    warm_up(eng, max(len(r.prompt) for r in reqs), cell.hf["vocab_size"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return drive.drive(eng, reqs, mix["ramp_s"], seconds, mix["drain_s"],
                       device)


def queue_thirds(served, w0: float, w1: float, step: float = 0.05):
    """Mean number of requests due and without a first token (refused
    ones left out) over each third of ``[w0, w1)``, sampled every
    ``step`` seconds."""
    t = np.arange(w0, w1, step)
    due = np.array([s.due for s in served if not s.refused])
    first = np.array([np.inf if s.first is None else s.first
                      for s in served if not s.refused])
    q = ((due[None, :] <= t[:, None]) & (first[None, :] > t[:, None])).sum(1)
    return [float(x.mean()) for x in np.array_split(q, 3)]


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def sweep(cell, rates, seeds, seconds, device="cuda", port_cfg=None):
    """One line a (rate, seed), then one a rate: whether its queue grew
    on every seed."""
    cfg, params = _model(cell, seeds[0], device, port_cfg)
    out = []
    for rate in rates:
        thirds = []
        for seed in seeds:
            eng = build_engine(cell.hf, cfg, params, device)
            mix = copy.deepcopy(cell.mix)
            mix["arrivals"]["rate"] = rate
            mix["drain_s"] = min(mix["drain_s"], SWEEP_DRAIN_S)
            served, start, w0, w1, end = _serve(cell, eng, mix, seed,
                                                seconds, device)
            tt = ttfts_ms(served, w0, w1, end)
            g = gaps_ms(served, w0, w1)
            q = queue_thirds(served, w0, w1)
            thirds.append(q)
            print(json.dumps({
                "rate": rate, "seed": seed, "due_in_window": len(tt),
                "ttft_p50_ms": percentile(tt, 50),
                "ttft_p90_ms": percentile(tt, 90),
                "itl_p50_ms": percentile(g, 50),
                "itl_p99_ms": percentile(g, 99),
                "queue_thirds": q, "drain_s": end - w1}), flush=True)
            del eng, served
            _free(device)
        grows = all(q[2] > q[0] for q in thirds)
        out.append((rate, grows))
        print(json.dumps({"rate": rate, "queue_grows": grows}), flush=True)
    return out


def control(cell, seeds, seconds, device="cuda", port_cfg=None):
    """One line a seed: ``check.control`` at the cell's limits."""
    out = []
    for seed in seeds:
        cfg, params = _model(cell, seed, device, port_cfg)
        eng = build_engine(cell.hf, cfg, params, device)
        served, *_ = _serve(cell, eng, cell.mix, seed, seconds, device)
        fin = [s.req for s in served
               if s.req is not None and s.req.finish_time is not None]
        del eng
        _free(device)
        reqs = check.sample(fin, seed, cell.mix["check"])
        got = check.control(cell.ref, cell.hf, params, reqs,
                            cell.hf["limits"])
        got = {"seed": seed, **got, "requests": len(reqs)}
        out.append(got)
        print(json.dumps(got), flush=True)
        del params, served, fin, reqs
        _free(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sweep", type=float, nargs="*")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="*", default=[1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if args.sweep:
        sweep(cell, args.sweep, args.seeds, args.seconds)
    if args.control:
        control(cell, args.seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
