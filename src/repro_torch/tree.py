"""Trees of tensors — the port's pytrees: nested dicts, lists and tuples
(NamedTuples such as the training state) of tensors. Dict keys are taken
in sorted order, as a JAX pytree orders them, so the leaves line up with
the reference's `jax.tree.leaves`; None is an empty node. `is_leaf` stops
the descent at a node (an int8 moment's `QTensor`)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def flatten_with_paths(tree, is_leaf: IsLeaf = None,
                       path: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in tree order, paths as "a/b/0"."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        return [(path, tree)]
    return [x for n, t in items for x in flatten_with_paths(
        t, is_leaf, f"{path}/{n}" if path else str(n))]


def leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [t for _, t in flatten_with_paths(tree, is_leaf)]


def unflatten(tree, it: Iterator) -> Any:
    """`tree`'s structure with its leaves, in tree order, from `it`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: unflatten(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        vals = [unflatten(t, it) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return next(it)


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of a dict / list tree (and the matching nodes
    of `rest`, which may be deeper), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)
