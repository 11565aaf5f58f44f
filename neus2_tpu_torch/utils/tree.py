"""Minimal pytree helpers over nested dicts, lists and tuples.

Parameters and optimizer state are plain nested containers with the JAX
package's layout (dict keys visited in sorted order, as JAX flattens
them), so the two packages' trees line up leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten_like(tree: Any, leaves: list) -> Any:
    """Rebuild ``tree``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(tree)
