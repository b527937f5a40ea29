"""Trees of tensors: the nested dicts, tuples, lists and NamedTuples the
port keeps parameters, optimizer state and checkpoints in (the
reference's pytrees).

Leaves are visited in the reference's order (``jax.tree_util``): a
dict's keys sorted, a NamedTuple's fields and a sequence's items in
order. A leaf's path is the tuple of its keys as strings, in the
reference's spelling: a dict key or a NamedTuple field by name, a
sequence item as ``[i]``; ``"/".join(path)`` is the string the
reference's checkpoints and weight-decay rule read (``opt/mu/blocks/
in_proj``). ``None`` is an empty subtree, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of the same structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if _is_namedtuple(t):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return fn(*trees)


def _children(t) -> Iterator[tuple[str, Any]]:
    if isinstance(t, dict):
        for k in sorted(t):
            yield str(k), t[k]
    elif _is_namedtuple(t):
        yield from zip(t._fields, t)
    else:
        for i, v in enumerate(t):
            yield f"[{i}]", v


def tree_leaves_with_path(tree, prefix: tuple[str, ...] = ()
                          ) -> list[tuple[tuple[str, ...], Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    if tree is None:
        return []
    if not isinstance(tree, (dict, tuple, list)):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += tree_leaves_with_path(child, prefix + (key,))
    return out


def tree_leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn: Callable, tree, prefix: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the leaves, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        keys = [k for k, _ in _children(tree)]
        items = [tree_map_with_path(fn, v, prefix + (k,))
                 for k, v in zip(keys, tree)]
        if _is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(prefix, tree)


def path_str(path: tuple[str, ...]) -> str:
    """``opt/mu/blocks/in_proj``: the reference's ``_path_str``."""
    return "/".join(path)
