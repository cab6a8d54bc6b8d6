"""Collectives over the axes of a mesh that one process drives.

A value on a mesh is a sequence with one entry a mesh position (a
:class:`~repro_torch.dist.sharding.Sharded`'s ``parts``).  A collective
over mesh ``axes`` reduces, within each group of positions that differ
only in those axes, the group's entries in the order of their block index
over ``axes``.  It runs on the device of the group's first position and
is copied to every other device of the group, once a device; where the
devices repeat it runs once and every position gets the same tensor.

Positions whose inputs are the same objects compute once: :func:`per_position`
calls its function once a (device, inputs) and :func:`reduce_over` once a
(device, group entries), so a replicated value on a repeated device is
computed, stored and reduced once, not once a position.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.dist.sharding import block_index, coords


def groups(mesh, axes) -> list[tuple[int, ...]]:
    """The positions of each group over ``axes``: equal coordinates on every
    other axis, ordered by their block index over ``axes``."""
    axes = tuple(axes)
    rest = [a for a in mesh.axis_names if a not in axes]
    by_key: dict = {}
    for pos in range(len(mesh.devices)):
        c = coords(mesh, pos)
        by_key.setdefault(tuple(c[a] for a in rest), []).append(pos)
    return [tuple(sorted(g, key=lambda p: block_index(mesh, p, axes))) for g in by_key.values()]


def _key(v):
    """Identity of an entry (a tensor, a tuple of them, or a plain value)."""
    if isinstance(v, torch.Tensor):
        return ("t", id(v))
    if isinstance(v, tuple):
        return tuple(_key(x) for x in v)
    return ("v", v)


def _to(v, dev):
    if isinstance(v, torch.Tensor):
        return v if v.device == dev else v.to(dev)
    if isinstance(v, tuple):
        return tuple(_to(x, dev) for x in v)
    return v


def per_position(fn: Callable, mesh, *args: Sequence) -> tuple:
    """``fn(*entries)`` for each position, ``args`` being per-position
    sequences; positions on one device whose entries are the same objects
    (or equal plain values) share one call and its result."""
    memo: dict = {}
    out = []
    for pos, dev in enumerate(mesh.devices):
        vals = [a[pos] for a in args]
        key = (dev, tuple(_key(v) for v in vals))
        if key not in memo:
            memo[key] = fn(*vals)
        out.append(memo[key])
    return tuple(out)


def reduce_over(parts: Sequence, mesh, axes, combine: Callable) -> tuple:
    """``combine(entries)`` of each group over ``axes``, on the group's
    first device, then given to every position of the group (a copy a
    further device).  No axes: ``parts`` unchanged."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    out: list = [None] * len(parts)
    memo: dict = {}
    copies: dict = {}
    for grp in groups(mesh, axes):
        lead = mesh.devices[grp[0]]
        vals = [parts[p] for p in grp]
        key = (lead, tuple(_key(v) for v in vals))
        if key not in memo:
            memo[key] = combine([_to(v, lead) for v in vals])
        res = memo[key]
        for p in grp:
            dev = mesh.devices[p]
            if dev == lead:
                out[p] = res
            else:
                if (key, dev) not in copies:
                    copies[key, dev] = _to(res, dev)
                out[p] = copies[key, dev]
    return tuple(out)


def sum_in_order(vals):
    """The sum of ``vals`` in order; a float type narrower than f32 is
    summed in f32 and rounded once."""
    dt = vals[0].dtype
    wide = dt.is_floating_point and torch.finfo(dt).bits < 32
    acc = vals[0].float() if wide else vals[0].clone()
    for v in vals[1:]:
        acc = acc + (v.float() if wide else v)
    return acc.to(dt)


def _max(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = torch.maximum(acc, v)
    return acc


def psum(parts: Sequence, mesh, axes) -> tuple:
    """Sum over ``axes`` (bf16 summed in f32 and rounded once)."""
    return reduce_over(parts, mesh, axes, sum_in_order)


def pmax(parts: Sequence, mesh, axes) -> tuple:
    """Elementwise maximum over ``axes``."""
    return reduce_over(parts, mesh, axes, _max)


def all_gather(parts: Sequence, mesh, axes, dim: int) -> tuple:
    """Concatenation along ``dim`` over ``axes``, in block order."""
    return reduce_over(parts, mesh, axes, lambda vals: torch.cat(vals, dim=dim))
