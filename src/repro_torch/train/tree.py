"""Nested dicts of tensors, and the optimizer state over them, as the
JAX package's pytrees: leaves in JAX's flatten order (dict keys sorted,
a namedtuple's fields in order), so parameters, gradients, moments and
checkpoint keys line up leaf for leaf with the JAX package's."""
from __future__ import annotations

__all__ = ["tree_items", "tree_leaves", "tree_map", "tree_unflatten"]


def _children(tree):
    """A node's (key, child) pairs in JAX's flatten order — a dict's by
    sorted key, a namedtuple's (``OptState``) as ``.field`` — or None for
    a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{name}", sub) for name, sub in zip(tree._fields, tree)]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return None


def tree_items(tree, prefix=()):
    """(path, leaf) in JAX's flatten order, a path the tuple of keys from
    the root."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, sub in kids:
        yield from tree_items(sub, prefix + (key,))


def tree_leaves(tree) -> list:
    """The leaves in JAX's flatten order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(template, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``template``'s structure."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        vals = [build(sub) for _, sub in kids]
        if isinstance(node, dict):
            return dict(zip((k for k, _ in kids), vals))
        return type(node)(*vals)
    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which share its structure), as a tree of the same structure."""
    leaves = zip(tree_leaves(tree), *map(tree_leaves, rest), strict=True)
    return tree_unflatten(tree, [fn(*xs) for xs in leaves])
