"""State trees: nested dicts, lists and tuples of tensors, flattened in the
JAX pytree's order (a dict's entries by sorted key, lists and tuples in
order, ``None`` no leaf), so a leaf list lines up with the reference's
``jax.tree_util.tree_leaves`` of the same tree."""

from __future__ import annotations

from typing import Any, List


def tree_flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in the JAX pytree's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_flatten(x)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """A tree shaped as ``template`` whose leaves are ``leaves``, taken in
    :func:`tree_flatten`'s order; raises unless their counts agree."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    try:
        out = build(template)
    except StopIteration:
        raise ValueError("fewer leaves than the template has") from None
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, *trees) -> Any:
    """``fn`` applied leaf by leaf across trees of one structure (the first
    tree's)."""
    flat = [tree_flatten(t) for t in trees]
    return tree_unflatten(trees[0], [fn(*xs) for xs in zip(*flat)])
