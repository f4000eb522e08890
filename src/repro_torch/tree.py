"""Nested dicts and lists of tensors: the port's parameter and cache trees,
where the reference uses JAX pytrees."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf; dicts stay dicts, lists and tuples
    become lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree
