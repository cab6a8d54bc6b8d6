"""Trees of tensors: nested dicts with tensor (or other) leaves, the
port's counterpart of the pytrees the JAX package passes around.

Leaves are visited in sorted-key order, the order ``jax.tree.flatten``
gives a dict, so a flattened tree lines up leaf for leaf with the JAX
package's (parameters, optimizer state, checkpoints).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


def leaves(tree: dict, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in sorted-key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def build(pairs: Iterable[tuple[tuple, Any]]) -> dict:
    """The tree of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the nodes of ``rest`` at
    the same paths: a node of ``rest`` may be a subtree where ``tree`` has
    a leaf (an optimizer's per-parameter state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def keystr(path: tuple) -> str:
    """A path as ``jax.tree_util.keystr`` spells a dict path:
    ``['params']['layers']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)
