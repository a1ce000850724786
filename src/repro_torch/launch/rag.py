"""The RAG retrieval hot loop: one query's IVF-PQ ADC scan and its top-5.

    PYTHONPATH=src python -m repro_torch.launch.rag
    PYTHONPATH=src python -m repro_torch.launch.rag --device cpu

The twin of the live half of ``examples/rag_pipeline.py``: the same seeded
codes and LUT, scanned through ``ops.pq_scan``, the 5 nearest ids printed.
Runs on the card by default (the CUDA kernel); ``--device cpu`` runs the
plain version on the host.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.kernels import ops

TOP = 5


def make_inputs(n: int, m: int, k: int, seed: int, codes: str = "int32",
                device="cuda"):
    """The example's inputs: ``default_rng(seed)``, then codes
    ``integers(0, k, (n, m))`` as int32, then the LUT ``random((m, k))`` as
    float32, in that order. ``codes="uint8"`` stores the same values in one
    byte each (k <= 256)."""
    if codes == "uint8" and k > 256:
        raise ValueError(f"uint8 codes need k <= 256, got {k}")
    rng = np.random.default_rng(seed)
    c = rng.integers(0, k, (n, m)).astype(np.int32)
    lut = rng.random((m, k)).astype(np.float32)
    dtype = torch.uint8 if codes == "uint8" else torch.int32
    return (torch.from_numpy(c).to(device=device, dtype=dtype),
            torch.from_numpy(lut).to(device))


def nearest(dist: torch.Tensor, top: int = TOP) -> List[int]:
    """Ids of the ``top`` smallest distances, nearest first."""
    return torch.topk(dist, top, largest=False).indices.tolist()


def main(argv=None) -> List[int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codes", choices=("int32", "uint8"), default="int32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    codes, lut = make_inputs(args.n, args.m, args.k, args.seed, args.codes,
                             args.device)
    ids = nearest(ops.pq_scan(codes, lut))
    where = (torch.cuda.get_device_name(codes.device) if codes.is_cuda
             else "cpu")
    print(f"[rag] device={args.device} ({where}) scanned {args.n} codes x "
          f"{args.m} subquantizers (K={args.k}, {args.codes}); top-{TOP} "
          f"ids={ids}")
    return ids


if __name__ == "__main__":
    main()
