"""Parameter trees: nested dicts of tensors, walked in sorted-key order.

``repro`` flattens its parameter pytrees with ``jax.tree.flatten``, which
visits dict keys in sorted order.  The port uses the same order everywhere a
tree becomes a sequence (flat vectors, coded slices, update norms), so those
line up element for element with the reference.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten(paths: List[Path], leaves: List):
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
