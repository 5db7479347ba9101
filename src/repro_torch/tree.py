"""Trees of dicts, lists, tuples and NamedTuples of leaves, as the port
keeps parameters, optimizer state, batches and caches.

Leaves are visited in JAX's `tree_util` order (dict keys sorted, a
NamedTuple's fields in order), so a vector flattened here has the
reference's coordinates and a sum over leaves runs in its order.
`tree_leaves`, `tree_map` and `tree_unflatten` keep None as a leaf;
`flatten_with_paths` and `unflatten` treat None as an empty subtree, as
`jax.tree_util.tree_flatten_with_path` does, and name each leaf by its
path: dict keys and sequence indices joined by '/', a NamedTuple's field
as '.field' (the checkpoint format's names, the paths the sharding rules
match).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def is_namedtuple(node: Any) -> bool:
    # a NamedTuple takes its fields as arguments, a plain tuple or list
    # one iterable
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in tree_leaves(c)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (same structure), called in `tree_leaves` order, rebuilt in `tree`'s
    structure (dicts keep their key order; a NamedTuple such as
    `optim.adamw.AdamWState` stays one)."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        children = [tree_map(fn, c, *(r[i] for r in rest))
                    for i, c in enumerate(tree)]
        return (type(tree)(*children) if is_namedtuple(tree)
                else type(tree)(children))
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """`like`'s structure holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any], Any]:
    """(names, leaves, treedef) in JAX's `tree_flatten_with_path` order.
    `treedef` is the tree itself, the template `unflatten` refills."""
    names: List[str] = []
    leaves: List[Any] = []
    _walk(tree, (), names, leaves)
    return names, leaves, tree


def _walk(node, path, names, leaves) -> None:
    # a module function, as `_build` is: no reference cycle holds `leaves`
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), names, leaves)
    elif is_namedtuple(node):
        for f, child in zip(node._fields, node):
            _walk(child, path + ("." + f,), names, leaves)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _walk(child, path + (str(i),), names, leaves)
    else:
        names.append("/".join(path))
        leaves.append(node)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """`treedef`'s structure (a tree, as `flatten_with_paths` returns it)
    holding `leaves` in its order."""
    return _build(treedef, iter(leaves))


def _build(node, it):
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle that would keep `leaves` alive until the
    # garbage collector runs
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)
