"""Nested containers of tensors ("trees") walked as the JAX package walks
its pytrees.

``jax.tree_util`` visits dict keys in *sorted* order and names a leaf by
its ``keystr`` path, e.g. ``['blocks']['l0']['ssm']['in_proj']``.  The
checkpoint manifest records those names in that order, so the port walks
the same way (``torch.utils._pytree`` keeps insertion order instead):
dicts by sorted key, lists and tuples by index, ``None`` as an empty
subtree, anything else as a leaf.  A manifest written by either package
is then byte-identical to the other's and readable by it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def leaf_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) for every leaf of ``tree``, in jax.tree_util order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """A tree of the same structure with every leaf replaced by
    ``fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return map_with_path(lambda _, leaf: fn(leaf), tree)
