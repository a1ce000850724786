"""Logical-axis sharding rules -> concrete partition specs (twin of
``repro.models.sharding``).

Every parameter dimension carries a *logical* axis name
(``transformer.param_axes``). ``ShardingRules`` resolves logical axes to
mesh axes with JAX's divisibility-aware fallbacks, priorities and "taken"
set, so the port shards a leaf exactly where JAX would. A spec is a
``PartitionSpec``: a tuple of ``None | str | tuple[str, ...]``, one entry
a dimension, equal entry for entry to JAX's ``P(...)``.

The mesh may be a ``torch.distributed.device_mesh.DeviceMesh`` or any
object with JAX's ``axis_names`` and a ``devices`` array (its ``shape``
read only), so the production meshes (256 and 512 positions) resolve
without their processes. ``tree_shardings`` gives DTensor placements
(``Shard(dim)`` / ``Replicate()`` a mesh dimension) to describe and check
layouts; the sharded train step runs on local shards with explicit
collectives (``repro_torch.distributed``), not on DTensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

# Ordered fallback chains: the first mesh-axis group that (a) exists in the
# mesh and (b) evenly divides the dimension wins. ``None`` => replicate.
# "fsdp" is a virtual mesh-axis group resolved to the data-parallel axes when
# FSDP weight sharding is enabled (large archs / training).
LOGICAL_RULES: Dict[str, Sequence[Optional[Tuple[str, ...]]]] = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": (None,),                      # seq replicated by default
    "seq_shard": (("pod", "data"), ("data",)),  # long-context: shard sequence
    "embed": (None,),
    "act_ff": (("model",),),
    "act_heads": (("model",),),
    # weights
    "w_embed": (None,),                  # overridden to dp axes under FSDP
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (None,),
    # fallback: if the heads dim could not take "model" (not divisible), the
    # taken-set is free and head_dim takes it instead (MQA / small-head archs)
    "head_dim_shard": (("model",),),
    "ff": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "kv_lora": (("model",),),
    "q_lora": (("model",),),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "attn_qseq": (("model",),),          # seq-sharded attention fallback
    # v2 KV-cache layout: grab every free axis for the cache sequence dim
    "cache_seq": (("pod", "data", "model"), ("data", "model"), ("model",), None),
    "state": (None,),
    "conv": (None,),
    "scan": (None,),                     # stacked-layer leading dim
    "norm": (None,),
}


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dimension, ``None`` (replicated),
    a mesh axis name, or a tuple of axis names (sharded over their
    product, in that order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_shape(mesh) -> Tuple[int, ...]:
    """The mesh's extent along each axis: a JAX-style ``devices`` array's
    shape, or a ``DeviceMesh``'s rank grid's."""
    devices = getattr(mesh, "devices", None)
    if devices is not None and hasattr(devices, "shape"):
        return tuple(int(n) for n in devices.shape)
    return tuple(int(n) for n in mesh.mesh.shape)


class ShardingRules:
    """Resolves logical axes against a mesh (+ optional FSDP override)."""

    def __init__(self, mesh, fsdp: bool = False, seq_sharded: bool = False):
        self.mesh = mesh
        self.axis_sizes = dict(zip(axis_names(mesh), mesh_shape(mesh)))
        self.fsdp = fsdp
        self.seq_sharded = seq_sharded
        self.rules = dict(LOGICAL_RULES)
        if fsdp:
            # ZeRO-3 style: shard the d_model dim of weights over the DP axes.
            self.rules["w_embed"] = (("pod", "data"), ("data",), None)
        if seq_sharded:
            # long-context single-request: batch cannot shard; shard seq.
            self.rules["seq"] = (("pod", "data"), ("data",), None)
            self.rules["batch"] = (None,)

    def _axis_group_size(self, group: Tuple[str, ...]) -> int:
        return math.prod(self.axis_sizes[a] for a in group)

    def _resolve_axis(self, logical: Optional[str], dim: int, taken: set):
        if logical is None:
            return None
        for group in self.rules.get(logical, (None,)):
            if group is None:
                return None
            if not all(a in self.axis_sizes for a in group):
                continue
            if any(a in taken for a in group):
                continue
            if dim % self._axis_group_size(group) != 0:
                continue
            return group if len(group) > 1 else group[0]
        return None

    # primary TP dims claim the mesh axis before fallback dims get a chance,
    # regardless of their position in the shape
    _PRIORITY = {"heads": 0, "kv_heads": 0, "ff": 0, "vocab": 0, "experts": 0,
                 "ssm_inner": 0, "batch": 0, "head_dim_shard": 1,
                 "kv_lora": 1, "q_lora": 1, "attn_qseq": 1, "cache_seq": 1}

    def spec(self, shape: Sequence[int],
             logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        assert len(shape) == len(logical_axes), (shape, logical_axes)
        taken: set = set()
        entries: list = [None] * len(shape)
        order = sorted(range(len(shape)),
                       key=lambda i: (self._PRIORITY.get(logical_axes[i], 2), i))
        for i in order:
            r = self._resolve_axis(logical_axes[i], shape[i], taken)
            if r is not None:
                taken.update((r,) if isinstance(r, str) else r)
            entries[i] = r
        return PartitionSpec(*entries)


def tree_specs(rules: ShardingRules, params, axes: Dict[str, tuple]):
    """The port's param tree (or any nested dict of tensors or shapes) and
    its flat axes (``transformer.param_axes``) -> the same tree of
    ``PartitionSpec``s."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in t.items()}
        return rules.spec(tuple(getattr(t, "shape", t)), axes[prefix])
    return walk(params, "")


def placements(rules: ShardingRules, spec: PartitionSpec):
    """DTensor placements of one spec: per mesh axis, ``Shard(dim)`` for
    the dimension it shards, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(rules.mesh):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tree_shardings(rules: ShardingRules, params, axes: Dict[str, tuple]):
    """``tree_specs`` as DTensor placements, one tuple a leaf."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return placements(rules, t)
    return walk(tree_specs(rules, params, axes))


def constrain(x, rules: ShardingRules, logical_axes):
    """The name JAX's forward calls (``with_sharding_constraint`` by logical
    axes). The port's sharded forward runs an explicit schedule on local
    shards, in which every activation already has the layout the
    constraint asks for, so this returns ``x``."""
    return x
