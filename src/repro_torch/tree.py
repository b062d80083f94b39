"""Nested parameter trees: dicts, lists and tuples whose leaves are
tensors (or any other non-container value).

The order of :func:`leaves` is ``jax.tree.flatten``'s: a dict's entries
in sorted key order, a list's or tuple's in their own order, depth
first; ``None`` is an empty subtree.  The LLM-scale transports bind
their random draws to this order (one quantizer draw and one bit-channel
stream per leaf), so a tree flattened in another order (a module's
``named_parameters()``, say) passes every shape check and fails parity.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple


def _items(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield str(key), tree[key]
    else:
        for i, sub in enumerate(tree):
            yield str(i), sub


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [tree]
    out = []
    for _, sub in _items(tree):
        out.extend(leaves(sub))
    return out


def paths(tree, prefix: str = '') -> List[str]:
    """Dotted paths of the leaves (``groups.b0.attn.wq``), in the order
    of :func:`leaves`."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [prefix]
    out = []
    for key, sub in _items(tree):
        out.extend(paths(sub, f'{prefix}.{key}' if prefix else key))
    return out


def unflatten(tree, new_leaves: Sequence[Any]):
    """A tree of ``tree``'s structure holding ``new_leaves`` (in the order
    of :func:`leaves`)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return type(node)(build(sub) for sub in node)

    out = build(tree)
    if next(it, it) is not it:
        raise ValueError('more leaves than the tree holds')
    return out


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure)."""
    others = [leaves(t) for t in rest]
    base = leaves(tree)
    if any(len(o) != len(base) for o in others):
        raise ValueError('trees of different structure')
    return unflatten(tree, [fn(*xs) for xs in zip(base, *others)])
