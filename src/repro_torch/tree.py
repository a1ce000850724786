"""Nested dicts of tensors (the port's parameter and train-state trees),
walked as ``jax.tree`` walks a dict pytree: keys sorted at every level, so
leaves come in the JAX package's order and a path joins its keys with
``/`` as ``repro.checkpoint.ckpt`` does."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in sorted-key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def leaves(tree) -> List[Any]:
    return list(flatten(tree).values())


def unflatten(like, flat: Dict[str, Any], prefix: str = ""):
    """The tree of ``like``'s structure whose leaves are ``flat``'s (paths
    as ``flatten`` makes them)."""
    if not isinstance(like, dict):
        return flat[prefix]
    return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
