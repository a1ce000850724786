"""Fault-tolerant training on the PyTorch port (the twin of
``examples/train_ft.py``): train a small LM, stop it, restart from the
newest atomic checkpoint, and check that the run goes on where it stopped
(the deterministic data stream replays from the restored step).

    PYTHONPATH=src python examples/train_ft_torch.py                # card
    PYTHONPATH=src python examples/train_ft_torch.py --device cpu \
        --arch deepseek_v2_lite_16b

Phase 1 trains ``--steps`` steps with a checkpoint every ``--every``;
phase 2 asks for ``--more`` steps beyond them and runs only those.
"""
import argparse
import shutil
import tempfile

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import train


def main(argv=None):
    """Returns (phase 1's losses, phase 2's losses)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--more", type=int, default=20)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", args.arch, "--reduced", "--batch", str(args.batch),
              "--seq", str(args.seq), "--device", args.device,
              "--ckpt-dir", ckpt_dir, "--ckpt-every", str(args.every)]
    try:
        print(f"== phase 1: train {args.steps} steps, checkpoint every "
              f"{args.every} ==")
        losses1 = train.main(common + ["--steps", str(args.steps)])

        total = args.steps + args.more
        print(f"== phase 2: 'crash' and restart; resumes from step "
              f"{args.steps} ==")
        losses2 = train.main(common + ["--steps", str(total)])
        assert len(losses2) == args.more, (
            f"restart should only run steps {args.steps}..{total}")
        print(f"resumed cleanly: phase1 end loss={losses1[-1]:.4f}, "
              f"phase2 end loss={losses2[-1]:.4f}")
        assert losses2[-1] < losses1[0], "loss should improve across restart"
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return losses1, losses2


if __name__ == "__main__":
    main()
