"""Weight bridge between the JAX package's parameter pytree and the port's
parameter dict.

Both are nested dicts with the same keys and the same stacked ``(L, ...)``
layer layout, so the bridge is a tree map. The JAX side hands over numpy
arrays (``jax.tree.map(np.asarray, params)``); bf16 arrays arrive with
numpy's ``bfloat16`` extension dtype and cross bit for bit. A whole train
state crosses the same way: params, AdamW's fp32 ``m`` and ``v``, and the
0-d int32 step.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device, dtype: Optional[torch.dtype]):
    # np.array(order="C") keeps a 0-d array 0-d (a train state's step);
    # np.ascontiguousarray would make it (1,)
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX pytree of numpy arrays -> the port's nested dict of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def to_numpy(params) -> Dict:
    """The port's parameter dict -> nested dict of numpy arrays on the
    host; bf16 becomes float32 (exact), as numpy has no bf16 of its own."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
