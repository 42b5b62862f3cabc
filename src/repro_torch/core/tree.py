"""Parameter trees: nested dicts of tensors, walked in sorted-key order.

``repro`` flattens its parameter pytrees with ``jax.tree.flatten``, which
visits dict keys in sorted order.  The port uses the same order everywhere a
tree becomes a sequence (flat vectors, coded slices, update norms), so those
line up element for element with the reference.

An empty dict is a node with no leaves (the LM tree's ``"rem"`` when the
layer pattern tiles the depth exactly).  ``empty_paths`` records where such
nodes sit, so that ``tree_unflatten`` rebuilds the same structure.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Sequence, Tuple

Path = Tuple[str, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def empty_paths(tree, prefix: Path = ()) -> List[Path]:
    """Paths of the empty dicts inside ``tree``."""
    if not isinstance(tree, dict):
        return []
    if not tree:
        return [prefix]
    return [p for k in sorted(tree) for p in empty_paths(tree[k],
                                                         prefix + (k,))]


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure, visiting the
    leaves in sorted-key order (the order of ``tree_leaves``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(paths: List[Path], leaves: List,
                   empties: Sequence[Path] = ()):
    out: dict = {}
    for path in empties:
        node = out
        for k in path:
            node = node.setdefault(k, {})
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_replace_leaves(tree, leaves: Sequence):
    """``tree`` with its leaves, in ``tree_leaves`` order, replaced."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
