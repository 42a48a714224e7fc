"""Nested parameter and state trees: leaves, paths, map, detach.

The port's parameters are nested dicts of tensors, its vertex state and
int8 optimizer moments are NamedTuples, and its optimizer state is a dict
of such trees. These helpers walk them in the reference's pytree order:
dict keys sorted, NamedTuple fields and sequence items in order, ``None``
an empty subtree. A leaf's path is the reference checkpoint's
(``distributed/checkpoint.py::_leaf_paths``): the dict keys, field names
and sequence indices along the way, joined by ``"."``. The optimizer, the
checkpoint and the trainer's detach between batches all walk trees here,
so a tree flattens to the same leaves, in the same order, in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list | None:
    """``[(key, child), ...]`` of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_path(tree: Tree, is_leaf: Callable | None = None,
                      prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` in the reference's leaf order. ``is_leaf``
    stops the walk at the nodes it accepts (e.g. an int8 moment)."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if kids is None:
        return [(".".join(str(p) for p in prefix), tree)]
    out = []
    for k, child in kids:
        out.extend(flatten_with_path(child, is_leaf, prefix + (k,)))
    return out


def leaves(tree: Tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def leaf_paths(tree: Tree) -> list[str]:
    return [path for path, _ in flatten_with_path(tree)]


def unflatten(like: Tree, new_leaves, is_leaf: Callable | None = None
              ) -> Tree:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf
    order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = None if is_leaf is not None and is_leaf(node) else \
            _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(child) for _, child in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree: Tree, *rest: Tree,
        is_leaf: Callable | None = None) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    columns = [leaves(tree, is_leaf)] + [leaves(r, is_leaf) for r in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)], is_leaf)


def detach(tree: Tree) -> Tree:
    """Every tensor leaf cut from the autograd graph (the reference's
    ``stop_gradient`` over a tree)."""
    return map(lambda x: x.detach(), tree)
