"""Trees of tensors: nested dicts and lists with tensor (or other)
leaves, the port's counterpart of the pytrees the JAX package passes
around.

Leaves are visited in sorted-key order for a dict and in index order for
a list, the order ``jax.tree.flatten`` gives them, so a flattened tree
lines up leaf for leaf with the JAX package's (parameters, optimizer
state, checkpoints).  A tuple is a leaf (a logical-axes entry, a spec).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


def _items(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def leaves(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) pairs in sorted-key order (a list's items by index)."""
    for k, v in _items(tree):
        if isinstance(v, (dict, list)):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _lists(node):
    """Nodes whose keys are 0 .. n-1 (a list's paths) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out) and sorted(out) == list(range(len(out))):
        return [out[i] for i in range(len(out))]
    return out


def build(pairs: Iterable[tuple[tuple, Any]]) -> dict:
    """The tree of (path, leaf) pairs; integer keys make lists."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _lists(out)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the nodes of ``rest`` at
    the same paths: a node of ``rest`` may be a subtree where ``tree`` has
    a leaf (an optimizer's per-parameter state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def keystr(path: tuple) -> str:
    """A path as ``jax.tree_util.keystr`` spells it: ``['params']['layers']
    ['wq']`` for dict keys, ``[0]`` for a list index."""
    return "".join(f"[{k!r}]" for k in path)
