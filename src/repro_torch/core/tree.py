"""Parameter and state trees: nested dicts, tuples, lists, NamedTuples
and :class:`~repro_torch.core.bfp.BFPTensor` nodes over tensor leaves.

The order and the key paths are those of ``jax.tree_util``: dict keys
sorted, a NamedTuple's fields in order, ``None`` an empty subtree, and
a BFPTensor a node of two children (mantissa, exponent).  So an
optimizer state or a checkpoint written by one package lines up leaf
for leaf with the other's, and :func:`flatten_with_paths` gives each
leaf the reference's key path (``['opt'].mu['a'][<flat index 0>]``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from .bfp import BFPTensor

Leaf = Any
_END = object()


def children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(key piece, child)]`` of a node, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, BFPTensor):
        return [("[<flat index 0>]", node.mantissa),
                ("[<flat index 1>]", node.exponent)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def _rebuild(node, values: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), values))
    if isinstance(node, BFPTensor):
        m, e = values
        return BFPTensor(m, e, node.mantissa_bits, node.block_size,
                         node.axis)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*values)
    if isinstance(node, tuple):
        return tuple(values)
    if isinstance(node, list):
        return list(values)
    return None


def flatten_with_paths(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> List[Tuple[str, Leaf]]:
    """``[(keystr, leaf)]`` in ``jax.tree_util`` order."""
    out: List[Tuple[str, Leaf]] = []

    def walk(node, path):
        kids = None if is_leaf is not None and is_leaf(node) \
            else children(node)
        if kids is None:
            out.append((path, node))
            return
        for piece, child in kids:
            walk(child, path + piece)

    walk(tree, "")
    return out


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Leaf]:
    return [v for _, v in flatten_with_paths(tree, is_leaf)]


def unflatten(like, values, is_leaf: Optional[Callable[[Any], bool]] = None):
    """A tree shaped like ``like`` with ``values`` as its leaves, in
    :func:`leaves` order."""
    it = iter(values)

    def walk(node):
        kids = None if is_leaf is not None and is_leaf(node) \
            else children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [walk(c) for _, c in kids])

    out = walk(like)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more values than leaves")
    return out



def tree_map(fn: Callable, tree, *rest,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    each tree in ``rest``), keeping ``tree``'s structure."""
    flat = leaves(tree, is_leaf)
    others = [leaves(r, is_leaf) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(flat)}")
    return unflatten(tree, [fn(*vs) for vs in zip(flat, *others)], is_leaf)
