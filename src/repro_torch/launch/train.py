"""Training launcher with checkpoint/restart (twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \
        --steps 50 --reduced --ckpt-dir ckpts/gemma
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert_xlarge \
        --reduced --device cpu --param-dtype float32

Every registered config trains (``--arch``, one of ``ARCH_IDS``): the
dense, vlm and audio GQA models, MLA in the dense and moe families (with
the routers' aux loss), the hybrid and the ssm family. Runs on the card
unless ``--device cpu`` asks for the host. The flags are the JAX
launcher's plus ``--device``; as there, the model trains with
``remat="none"``. On the card a config whose train state alone (bf16
parameters and gradients, fp32 AdamW moments: 12 B a parameter) exceeds
the card's memory raises ``ValueError`` with that reckoning before
anything is allocated. Restart resumes from the newest complete checkpoint
under ``--ckpt-dir`` and replays the deterministic data stream from that
step, so a resumed run's losses are the uninterrupted run's. Parameters
start from ``init_train_state`` with seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import steps
from repro_torch.models import transformer as tf
from repro_torch.models.optim import OptConfig


def param_count(cfg) -> int:
    """The config's parameters, counted on the meta device (no memory)."""
    params = tf.init_model(cfg, torch.Generator(), "meta")
    return sum(t.numel() for t in tree.leaves(params))


def check_fits(cfg, have: int):
    """Raise ``ValueError`` when the train state alone (parameter and
    gradient in the parameter dtype, fp32 m and v) exceeds ``have`` bytes
    (the card's memory); activations come on top."""
    n = param_count(cfg)
    width = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    need = n * (2 * width + 8)
    if need > have:
        raise ValueError(
            f"{cfg.name}: {n / 1e9:.2f}B parameters x {2 * width + 8} B of "
            f"train state (parameter and gradient at {width} B, fp32 m and "
            f"v) = {need / 2**30:.1f} GiB, more than the card's "
            f"{have / 2**30:.1f} GiB before any activation")


def main(argv=None):
    """Train and return the loss of every step run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b", choices=ARCH_IDS,
                    help="any registered config: every family trains")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default=None,
                    help="parameter and compute dtype; default bfloat16 on "
                         "the card (its attention kernels take bf16 and "
                         "raise on anything else), float32 on the CPU (the "
                         "JAX launcher's default)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    dtype = args.param_dtype or ("float32" if device.type == "cpu"
                                 else "bfloat16")
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype, remat="none")
    opt = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                    total_steps=args.steps)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    if device.type == "cuda":
        check_fits(cfg, torch.cuda.get_device_properties(device).total_memory)

    gen = torch.Generator(device=device).manual_seed(0)
    state = steps.init_train_state(cfg, gen, device)
    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, man = ckpt.restore(args.ckpt_dir, state)
            start = man["step"]
            print(f"[train] restored step {start} from {args.ckpt_dir}")

    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch_at(dc, i).items()}
        state, metrics = steps.train_step(state, batch, cfg, opt)
        losses.append(float(metrics["loss"]))
        if (i + 1) % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {i+1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt/max(1,len(losses)):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, state)
    if len(losses) > 10:
        print(f"[train] loss first10={np.mean(losses[:10]):.4f} "
              f"last10={np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
