"""End-to-end example on the PyTorch port (the twin of
``examples/serve_e2e.py``): the port's paged ``Engine`` serves 10 batched
requests at ``gemma_2b``'s full width on the card, then the same schedule
(10 requests) is replayed in the shared simulator (``repro.core``, which
imports no JAX), and the measured TTFT and TPOT are printed beside the
simulated ones.

    PYTHONPATH=src python examples/serve_e2e_torch.py             # card
    PYTHONPATH=src python examples/serve_e2e_torch.py --device cpu --reduced

The weights are the port's init (``transformer.init_model``, seeded); on
the card the engine's fixed-shape passes run as CUDA graphs through the
hand-written attention kernels. One warm-up request goes first and is not
counted: the kernels build with nvcc at their first use.
"""
import argparse
import subprocess
import time

import numpy as np
import torch

from repro.core import SystemSpec, WorkloadConfig, build_system, generate
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.engine.runner import Engine


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced gemma_2b (a quick run on the CPU)")
    args = ap.parse_args(argv)
    arch = "gemma_2b"
    cfg = get_reduced_config(arch) if args.reduced else get_config(arch)
    where = _card() if args.device.startswith("cuda") else args.device
    eng = Engine(cfg, max_batch=4, max_len=256, device=args.device)
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        eng.params))
    print(f"[1] real execution: {cfg.name} ({n_params / 1e9:.3f}B params) "
          f"on {where}")
    eng.submit(np.arange(1, 24), max_new_tokens=16)
    eng.run()
    warm, warm_steps = len(eng.finished), eng.steps
    rng = np.random.default_rng(0)
    n_requests = 10
    t0 = time.monotonic()
    for _ in range(n_requests):
        eng.submit(rng.integers(0, cfg.vocab_size, int(rng.integers(8, 40))),
                   max_new_tokens=16)
    done = eng.run()[warm:]
    wall = time.monotonic() - t0
    toks = sum(len(r.tokens) for r in done)
    print(f"    served {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s, {eng.steps - warm_steps} engine "
          "steps)")
    ttfts = [r.ttft for r in done]
    tpots = [r.tpot for r in done if r.tpot]
    print(f"    ttft mean={np.mean(ttfts) * 1e3:.1f}ms "
          f"p50={np.median(ttfts) * 1e3:.1f}ms  "
          f"tpot mean={np.mean(tpots) * 1e3:.2f}ms "
          f"p50={np.median(tpots) * 1e3:.2f}ms")

    print("[2] simulator replay of an equivalent system")
    coord = build_system(SystemSpec(n_llm_clients=1, with_pre_post=False))
    wl = WorkloadConfig(rate=100.0, n_requests=n_requests, seed=0,
                        postprocess=False)
    coord.submit(generate(wl))
    s = coord.run().summary()
    print(f"    simulated {s['n_serviced']} requests "
          f"ttft_p50={s['ttft_p50'] * 1e3:.1f}ms "
          f"tpot_p50={s['tpot_p50'] * 1e3:.2f}ms")
    print(f"[3] measured ({where}) against simulated: ttft p50 "
          f"{np.median(ttfts) * 1e3:.1f} | {s['ttft_p50'] * 1e3:.1f} ms, "
          f"tpot p50 {np.median(tpots) * 1e3:.2f} | "
          f"{s['tpot_p50'] * 1e3:.2f} ms (the simulator prices its own "
          "workload's prompts and model on its H100 cluster; the schedule's "
          "structure is what matches)")
    return done, s


if __name__ == "__main__":
    main()
