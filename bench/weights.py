"""Weights from the seed, made on the device in the type they are served
in, in the port's parameter layout (the leaves and shapes the program
declares for a configuration), and in a few large calls: one normal draw
over one flat bf16 buffer from a ``torch.Generator`` on the card, every
leaf a view of it scaled in place.

Every weight is drawn (the port's own initializer starts output
projections at zero, which would leave attention and the MLPs out of the
logits): fan-in scaled, so activations keep unit size through the depth;
norm gammas (applied as ``1 + gamma``) at 0.1.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ALIGN = 128          # elements between leaves: 256-byte aligned views


def scale(path: str, shape: Tuple[int, ...]) -> float:
    """The standard deviation of leaf ``path`` (dotted, the port's keys)
    of ``shape`` (with the stack dim ``L`` in front for stacked layers)."""
    keys = path.split(".")
    name = keys[-1]
    body = shape[1:] if keys[0] in ("layers", "dense_layers") else shape
    if name == "gamma" or name == "beta":
        return 0.1
    if name == "embed":
        return body[-1] ** -0.5
    if "moe" in keys and "shared" not in keys and name in ("wi", "wo"):
        body = body[1:]                                   # (E, ...) experts
    if name == "wo":
        return math.prod(body[:-1]) ** -0.5               # (..., d) out
    return body[0] ** -0.5                                # (d_in, ...)


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         dtype=torch.bfloat16) -> Dict:
    """The nested parameter dict of ``shapes`` (dotted path -> shape),
    drawn from ``seed``."""
    offs, n = {}, 0
    for path, shape in shapes.items():
        offs[path] = n
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(n, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    fill(flat, gen)
    params: Dict = {}
    for path, shape in shapes.items():
        t = flat[offs[path]:offs[path] + math.prod(shape)].view(shape)
        t.mul_(scale(path, shape))
        node = params
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return params


def fill(flat: torch.Tensor, gen: torch.Generator, chunk: int = 1 << 30):
    """Standard normals into ``flat``, in chunks of ``chunk`` elements."""
    for i in range(0, flat.numel(), chunk):
        part = flat[i:i + chunk]
        part.normal_(generator=gen)
