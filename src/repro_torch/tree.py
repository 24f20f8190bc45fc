"""Trees of tensors: nested dicts and lists, flattened in the JAX package's
order (dict keys sorted, list items by index), each leaf's path written as
``jax.tree_util.keystr`` writes it: ``['params']['seg0']['sub0']['wq']``,
``['opt']['f'][3]['vr']``, ``['step']``.

The optimizer's per-leaf state list, the global gradient norm and the
checkpoint's keys all follow this order, as the reference's do."""
from __future__ import annotations

from typing import Any, Callable


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """-> [(keystr path, leaf)] in flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` (flatten order)."""
    it = iter(new_leaves)

    def build(x):
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return [build(v) for v in x]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
