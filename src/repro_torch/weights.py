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


def shard_params(full, specs, mesh, device=None) -> Dict:
    """This rank's shards of a whole tree: each leaf sliced along each dim
    its spec (a tree of ``sharding.PartitionSpec`` of the same structure)
    gives a mesh-axis group, at the rank's coordinate in that group, in
    the group's axis order (the order JAX lays shards out). Each shard is
    a copy (on ``device`` when given), so the whole tree can be freed.
    A ``distributed.HeadsRead`` entry takes the kv heads the rank's query
    heads read, a ``distributed.Mamba2Read`` entry its heads' Mamba2
    channels and B and C whole. It serves caches as well as params
    (``transformer.cache_specs``). Every rank calls it alike (its first
    use of an axis group creates the group on every rank)."""
    from repro_torch import distributed
    if isinstance(full, dict):
        return {k: shard_params(v, specs[k], mesh, device)
                for k, v in full.items()}
    t = full
    for dim, e in enumerate(specs):
        if isinstance(e, (distributed.HeadsRead, distributed.Mamba2Read)):
            t = e.take(t, dim, distributed.axis(mesh, ("model",)))
        elif e is not None:
            ax = distributed.axis(mesh, (e,) if isinstance(e, str) else e)
            t = distributed.local_slice(t, dim, ax)
    return t.to(device=device or t.device, copy=True)


@torch.no_grad()
def gather_params(local, specs, mesh) -> Dict:
    """The whole tree from every rank's shards (``shard_params``'s
    inverse), on every rank, as new tensors; for checks and tests."""
    from repro_torch import distributed
    if isinstance(local, dict):
        return {k: gather_params(v, specs[k], mesh) for k, v in local.items()}
    t = local.clone()             # a copy even where nothing is gathered
    for dim, e in enumerate(specs):
        if isinstance(e, (distributed.HeadsRead, distributed.Mamba2Read)):
            t = e.whole(t, dim, distributed.axis(mesh, ("model",)))
        elif e is not None:
            ax = distributed.axis(mesh, (e,) if isinstance(e, str) else e)
            t = distributed.gather(t, dim, ax)
    return t
