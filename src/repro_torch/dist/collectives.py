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
computed, stored and reduced once, not once a position.  While such a call
runs, :func:`served` names the positions it serves (every position that
takes its result), so the dry run (``launch/dryrun.py``) can count what it
stores for each of them, as distinct cards would hold it.

The graph collectives (:func:`halo_gather`, :func:`summed_scatter`) and
:func:`reduce_scatter` are autograd functions with the SPMD backward of
their kind: a gather's is a reduce-scatter of the gradients, a
reduce-scatter's an all-gather.

Every collective over a group of ``g > 1`` positions adds, for each position
of the group, the bytes a ring algorithm would send to :data:`WIRE` (the
JAX package's factors: all-reduce ``2(g-1)/g``, all-gather and
reduce-scatter ``(g-1)/g`` of the full tensor), whether the positions share
a device or not: what the layout would move between distinct cards.  A
gather's backward adds its reduce-scatter when it runs, once a group (groups
whose entries are the same objects share one call, not one count).

The rule of the count: every sum that joins values computed at different
mesh positions counts as the collective distinct cards would run for it,
wherever the sum is made: by a function here, by autograd adding up the
gradient of one tensor that several positions read, or by the trainer
adding a replicated parameter's gradients over its holders
(``train/trainer.py``).  The implicit sums are counted, never made anew:
:func:`replicated` (a value equal over a group that the group's positions
then read differently: Megatron's copy to the model-parallel region, whose
backward is an all-reduce of the gradient) and :func:`split` (each position
taking its block of such a value, whose backward assembles the whole
gradient: an all-gather) pass their tensors through unchanged and count
from a gradient hook when the gradient arrives; :func:`count_over` counts a
sum the caller makes itself (a loss summed over the data slices, a norm's
partial sums of squares).  A value that positions only read alike (the same
work at each, as a norm of the whole residual) needs no sum and counts none.
Under a layer recomputed in the backward (``transformer_mesh._Remat``) the
recomputation counts its forward collectives again, as the JAX HLO's
recompute runs them, and the hooks count the backward once: they are set
only where a gradient will flow, so in the recomputation, not in the
forward without a graph.
"""

from __future__ import annotations

from typing import Callable, Sequence

import collections
import contextlib
import threading

import torch

from repro_torch.dist.sharding import block_index, coords

_REGION = threading.local()


@contextlib.contextmanager
def _collective():
    """Marks the ops of a collective's combine (``in_collective``): a flop
    count takes their sums for wire work, not flops."""
    prev = getattr(_REGION, "on", False)
    _REGION.on = True
    try:
        yield
    finally:
        _REGION.on = prev


def in_collective() -> bool:
    return getattr(_REGION, "on", False)


_SERVING = threading.local()


class _Serving:
    """Within it, :func:`served` is ``positions``."""

    __slots__ = ("positions", "prev")

    def __init__(self, positions: tuple):
        self.positions = positions

    def __enter__(self):
        self.prev = getattr(_SERVING, "at", None)
        _SERVING.at = self.positions

    def __exit__(self, *exc):
        _SERVING.at = self.prev


def served() -> tuple | None:
    """The mesh positions the running :func:`per_position` call or
    collective combine serves (in order), None outside one."""
    return getattr(_SERVING, "at", None)


# wire bytes a kind of collective has moved, summed over mesh positions; and the part of
# them the graph collectives moved, by collective, both directions
WIRE: dict[str, float] = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0}
GRAPH_WIRE: dict[str, float] = {"halo": 0.0, "scatter": 0.0}
_WIRE_LOCK = threading.Lock()
_FACTOR = {"all-reduce": lambda g: 2.0 * (g - 1) / g, "all-gather": lambda g: (g - 1) / g,
           "reduce-scatter": lambda g: (g - 1) / g}


def reset_wire() -> None:
    for tally in (WIRE, GRAPH_WIRE):
        for k in tally:
            tally[k] = 0.0


def wire_bytes() -> dict[str, float]:
    """A copy of :data:`WIRE` (bytes over every position, by kind)."""
    return dict(WIRE)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, tuple):
        return sum(_nbytes(x) for x in v)
    return 0


def count_wire(kind: str, full_bytes: float, g: int, graph: str | None = None) -> None:
    """A ``kind`` collective of a ``full_bytes`` tensor over ``g`` positions:
    each of them sends ``factor(g)`` of it (``graph``: the graph collective
    it belongs to, for :data:`GRAPH_WIRE`)."""
    if g > 1:
        nbytes = full_bytes * _FACTOR[kind](g) * g
        with _WIRE_LOCK:  # backward hooks run on each device's autograd thread
            WIRE[kind] += nbytes
            if graph is not None:
                GRAPH_WIRE[graph] += nbytes


def count_over(kind: str, nbytes: float, mesh, axes) -> None:
    """A ``kind`` collective of ``nbytes`` in every group over ``axes``
    (a sum the caller makes itself, e.g. on one device)."""
    for grp in groups(mesh, axes):
        count_wire(kind, nbytes, len(grp))


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
    (or equal plain values) share one call and its result, the call made
    while :func:`served` names them."""
    calls: dict = {}
    keys = []
    for pos, dev in enumerate(mesh.devices):
        vals = [a[pos] for a in args]
        key = (dev, tuple(_key(v) for v in vals))
        calls.setdefault(key, (vals, []))[1].append(pos)
        keys.append(key)
    done = {}
    for key, (vals, positions) in calls.items():
        with _Serving(tuple(positions)):
            done[key] = fn(*vals)
    return tuple(done[k] for k in keys)


def _count_backward(res, kind: str, g: int) -> None:
    """Count ``kind`` over ``g`` positions when the gradient of ``res``
    arrives (a gather's backward is a reduce-scatter of the same bytes);
    nothing where no gradient will flow."""
    if isinstance(res, torch.Tensor) and res.requires_grad:
        res.register_hook(lambda grad: count_wire(kind, _nbytes(grad), g))


def _marked(parts: Sequence, mesh, axes, kind: str) -> None:
    """One ``kind`` counted a group over ``axes`` when the gradient of the
    group's first entry arrives."""
    for grp in groups(mesh, axes):
        _count_backward(parts[grp[0]], kind, len(grp))


def replicated(parts: Sequence, mesh, axes) -> tuple:
    """``parts``, equal within each group over ``axes``, handed to work that
    differs by position over those axes (a product with a weight split over
    them): the same tensors, and the gradient's sum over the group, which
    autograd makes where the positions share the tensor, counted as the
    all-reduce it would be on distinct cards.  No axes: ``parts``."""
    axes = tuple(axes)
    if axes and mesh.size(axes) > 1:
        _marked(parts, mesh, axes, "all-reduce")
    return tuple(parts)


def split(parts: Sequence, mesh, axes, dim: int) -> tuple:
    """Each position's block over ``axes`` along ``dim`` of its whole value
    (equal within each group over ``axes``), a storage of its own; the
    backward assembles the whole value's gradient from the blocks, counted
    as the all-gather it would be on distinct cards.  No axes: ``parts``."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    _marked(parts, mesh, axes, "all-gather")
    n = parts[0].shape[dim] // mesh.size(axes)
    starts = [block_index(mesh, p, axes) * n for p in range(len(mesh.devices))]
    return per_position(lambda t, s0: t.narrow(dim, s0, n).clone(), mesh, parts, starts)


def reduce_over(parts: Sequence, mesh, axes, combine: Callable, kind: str = "all-reduce"
                ) -> tuple:
    """``combine(entries)`` of each group over ``axes``, on the group's
    first device, then given to every position of the group (a copy a
    further device).  No axes: ``parts`` unchanged.  ``kind`` names the
    collective for :data:`WIRE` (an all-gather's backward counts as a
    reduce-scatter)."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    out: list = [None] * len(parts)
    memo: dict = {}
    copies: dict = {}
    for grp, key, lead, served_by in _grouped(parts, mesh, axes):
        if key not in memo:
            with _collective(), _Serving(served_by):
                memo[key] = combine([_to(parts[p], lead) for p in grp])
        res = memo[key]
        count_wire(kind, _nbytes(res), len(grp))
        if kind == "all-gather":
            _count_backward(res, "reduce-scatter", len(grp))
        for p in grp:
            dev = mesh.devices[p]
            if dev == lead:
                out[p] = res
            else:
                if (key, dev) not in copies:
                    with _Serving(tuple(q for q in served_by if mesh.devices[q] == dev)):
                        copies[key, dev] = _to(res, dev)
                out[p] = copies[key, dev]
    return tuple(out)


def _grouped(parts: Sequence, mesh, axes) -> list[tuple]:
    """(group, key, lead device, positions served) of each group over
    ``axes``: groups whose entries are the same objects on the same lead
    share a key, and the positions served by it are every such group's."""
    out = []
    served_by: dict = {}
    for grp in groups(mesh, axes):
        lead = mesh.devices[grp[0]]
        key = (lead, tuple(_key(parts[p]) for p in grp))
        served_by.setdefault(key, []).extend(grp)
        out.append((grp, key, lead))
    return [(grp, key, lead, tuple(sorted(served_by[key]))) for grp, key, lead in out]


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
    """Concatenation along ``dim`` over ``axes``, in block order.  Its
    backward (autograd's, through the one concatenation a group) gives each
    entry its block of the gathered value's gradient, summed over every
    position that took it."""
    return reduce_over(parts, mesh, axes, lambda vals: torch.cat(vals, dim=dim), "all-gather")


class _ReduceScatter(torch.autograd.Function):
    """A group's entries summed in order on ``lead`` (:func:`sum_in_order`)
    and split along ``dim`` into one block an entry; block ``b`` delivered
    to each device of ``targets``' ``(b, device)`` as a storage of its own
    (a view would keep the whole sum alive), made while :func:`served`
    names ``at[i]``, the positions that take target ``i`` (the sum: all of
    them).  Backward: the blocks' gradients concatenated on ``lead`` (an
    all-gather, counted for each of the ``times`` groups the call serves)
    and given to every entry."""

    @staticmethod
    def forward(ctx, dim, lead, targets, at, times, *entries):
        with _collective(), _Serving(tuple(sorted(q for ps in at for q in ps))):
            total = sum_in_order([_to(e, lead) for e in entries])
        blocks = total.chunk(len(entries), dim)
        ctx.dim, ctx.lead, ctx.targets, ctx.times = dim, lead, targets, times
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(e.device, e.dtype) for e in entries]
        out = []
        for (b, dev), positions in zip(targets, at):
            with _Serving(positions):
                out.append(blocks[b].clone() if dev == lead else blocks[b].to(dev))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        by_block: dict = {}
        for (b, _), g in zip(ctx.targets, grads):
            if g is not None:
                by_block.setdefault(b, []).append(g.to(ctx.lead))
        ref = next(g for gs in by_block.values() for g in gs)
        with _collective():
            full = torch.cat([sum_in_order(by_block[b]) if len(by_block.get(b, ())) > 1
                              else by_block[b][0] if b in by_block else ref.new_zeros(shape)
                              for b, shape in enumerate(ctx.block_shapes)], ctx.dim)
        count_wire("all-gather", _nbytes(full) * ctx.times, len(ctx.part))
        made: dict = {}
        out = []
        for dev, dt in ctx.part:
            if (dev, dt) not in made:
                made[dev, dt] = full.to(device=dev, dtype=dt)
            out.append(made[dev, dt])
        return (None, None, None, None, None, *out)


def reduce_scatter(parts: Sequence, mesh, axes, dim: int) -> tuple:
    """Each group's entries over ``axes`` summed (:func:`sum_in_order` on
    the group's lead device, as :func:`psum`) and each position given its
    block of the sum along ``dim`` over ``axes``, in block order: a storage
    of its own a (device, block).  The backward all-gathers the blocks'
    gradients to every entry.  No axes: ``parts`` unchanged."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    out: list = [None] * len(parts)
    memo: dict = {}
    grouped = _grouped(parts, mesh, axes)
    times = collections.Counter(key for _, key, _, _ in grouped)
    for grp, key, lead, served_by in grouped:
        if key not in memo:
            at: dict = {}
            for q in served_by:
                at.setdefault((block_index(mesh, q, axes), mesh.devices[q]), []).append(q)
            res = _ReduceScatter.apply(dim, lead, tuple(at), tuple(map(tuple, at.values())),
                                       times[key], *(parts[p] for p in grp))
            memo[key] = dict(zip(at, res))
        count_wire("reduce-scatter", _nbytes(parts[grp[0]]), len(grp))
        for p in grp:
            out[p] = memo[key][block_index(mesh, p, axes), mesh.devices[p]]
    return tuple(out)


# ---------------------------------------------------------------------------
# graph collectives: node states to every edge, edge sums to node blocks
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """A group's entries concatenated along ``dim`` on ``lead``, one copy a
    further device of ``devs``; backward: the copies' gradients summed on
    ``lead`` and split back to the entries (a reduce-scatter).  Both
    counted for each of the ``times`` groups the call serves."""

    @staticmethod
    def forward(ctx, dim, lead, devs, times, *entries):
        full = torch.cat([e.to(lead) for e in entries], dim)
        ctx.dim, ctx.lead, ctx.times = dim, lead, times
        ctx.sizes = [e.shape[dim] for e in entries]
        ctx.entry_devs = [e.device for e in entries]
        count_wire("all-gather", _nbytes(full) * times, len(entries), "halo")
        return tuple(full if d == lead else full.to(d) for d in devs)

    @staticmethod
    def backward(ctx, *grads):
        got = [g.to(ctx.lead) for g in grads if g is not None]
        with _collective():
            total = sum_in_order(got) if len(got) > 1 else got[0]
        count_wire("reduce-scatter", _nbytes(total) * ctx.times, len(ctx.sizes), "halo")
        pieces = total.split(ctx.sizes, ctx.dim)
        return (None, None, None, None, *(p.to(d) for p, d in zip(pieces, ctx.entry_devs)))


def halo_gather(parts: Sequence, mesh, axes, dim: int = 0) -> tuple:
    """Each position's node block (``parts``) gathered over ``axes`` into
    the whole array along ``dim``, given to every position of the group:
    the states an edge reads at either end, wherever its node lives.  The
    backward reduce-scatters the gradients to the blocks.  Groups with the
    same entries on the same devices share one gather."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    out: list = [None] * len(parts)
    memo: dict = {}
    keyed = []
    for grp in groups(mesh, axes):
        devs = tuple(dict.fromkeys(mesh.devices[p] for p in grp))
        keyed.append((grp, devs, (devs, tuple(_key(parts[p]) for p in grp))))
    times = collections.Counter(key for _, _, key in keyed)
    for grp, devs, key in keyed:
        if key not in memo:
            memo[key] = dict(zip(devs, _Gather.apply(dim, devs[0], devs, times[key],
                                                     *(parts[p] for p in grp))))
        for p in grp:
            out[p] = memo[key][mesh.devices[p]]
    return tuple(out)


class _SummedScatter(torch.autograd.Function):
    """Distinct partials (whole arrays) summed in order on ``lead`` (a float
    type narrower than f32 in f32), then split along ``dim`` into
    ``n_blocks`` blocks, block ``b`` delivered to each device of
    ``targets``' ``(b, device)``; backward: the blocks' gradients
    concatenated (an all-gather) and given to every partial."""

    @staticmethod
    def forward(ctx, dim, n_blocks, lead, targets, out_dtype, *partials):
        with _collective():
            total = sum_in_order([p.to(lead) for p in partials]) if len(partials) > 1 \
                else partials[0].to(lead)
        total = total.to(out_dtype)
        blocks = total.chunk(n_blocks, dim)
        ctx.dim, ctx.lead, ctx.targets = dim, lead, targets
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(p.device, p.dtype) for p in partials]
        count_wire("reduce-scatter", _nbytes(partials[0]), len(partials), "scatter")
        return tuple(blocks[b] if d == lead else blocks[b].to(d) for b, d in targets)

    @staticmethod
    def backward(ctx, *grads):
        by_block: dict = {}
        for (b, _), g in zip(ctx.targets, grads):
            if g is not None:
                by_block.setdefault(b, []).append(g.to(ctx.lead))
        ref = next(g for gs in by_block.values() for g in gs)
        with _collective():
            full = torch.cat([sum_in_order(by_block[b]) if len(by_block.get(b, ())) > 1
                              else by_block[b][0] if b in by_block else ref.new_zeros(shape)
                              for b, shape in enumerate(ctx.block_shapes)], ctx.dim)
        count_wire("all-gather", _nbytes(full), len(ctx.part), "scatter")
        made: dict = {}
        out = []
        for dev, dt in ctx.part:
            if (dev, dt) not in made:
                made[dev, dt] = full.to(device=dev, dtype=dt)
            out.append(made[dev, dt])
        return (None, None, None, None, None, *out)


def summed_scatter(parts: Sequence, mesh, sum_axes, block_axes, dim: int = 0,
                   dtype: torch.dtype | None = None) -> tuple:
    """Whole-array partials (``parts``, one a position) summed over
    ``sum_axes`` and each position given its block over ``block_axes``
    (a subset of ``sum_axes``) along ``dim``: the edge sums of every shard
    delivered to the nodes' owners, cast to ``dtype`` (default the
    partials') after the sum.  The backward all-gathers the blocks'
    gradients."""
    sum_axes, block_axes = tuple(sum_axes), tuple(block_axes)
    n_blocks = mesh.size(block_axes)
    out: list = [None] * len(parts)
    for grp in groups(mesh, sum_axes):
        lead = mesh.devices[grp[0]]
        partials = [parts[p] for p in grp]
        targets = tuple(dict.fromkeys((block_index(mesh, p, block_axes), mesh.devices[p])
                                      for p in grp))
        res = _SummedScatter.apply(dim, n_blocks, lead, targets, dtype or partials[0].dtype,
                                   *partials)
        got = dict(zip(targets, res))
        for p in grp:
            out[p] = got[block_index(mesh, p, block_axes), mesh.devices[p]]
    return tuple(out)


class _ScatterSum(torch.autograd.Function):
    """Edge values of every position added into one whole-graph accumulator
    on ``lead`` by their destination rows, in position order (a float type
    narrower than f32 in f32), then split into ``n_blocks`` node blocks as
    :class:`_SummedScatter` delivers them; backward: the blocks' gradients
    concatenated (an all-gather) and each position's rows gathered at its
    destinations.  The same sums as :func:`summed_scatter` of each
    position's partial, without a whole-graph partial a position."""

    @staticmethod
    def forward(ctx, n, n_blocks, lead, targets, out_dtype, n_pos, *vals_and_dst):
        vals, dsts = vals_and_dst[:n_pos], vals_and_dst[n_pos:]
        dt = vals[0].dtype
        wide = dt.is_floating_point and torch.finfo(dt).bits < 32
        acc = torch.zeros((n, *vals[0].shape[1:]), dtype=torch.float32 if wide else dt,
                          device=lead)
        with _collective():
            for v, d in zip(vals, dsts):
                acc.index_add_(0, d.to(lead), v.to(lead, acc.dtype))
        blocks = acc.to(out_dtype).chunk(n_blocks, 0)
        ctx.lead, ctx.targets = lead, targets
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(v.device, v.dtype) for v in vals]
        ctx.save_for_backward(*dsts)
        count_wire("reduce-scatter", acc.numel() * acc.element_size(), n_pos, "scatter")
        return tuple(blocks[b] if d == lead else blocks[b].to(d) for b, d in targets)

    @staticmethod
    def backward(ctx, *grads):
        dsts = ctx.saved_tensors
        by_block: dict = {}
        for (b, _), g in zip(ctx.targets, grads):
            if g is not None:
                by_block.setdefault(b, []).append(g.to(ctx.lead))
        ref = next(g for gs in by_block.values() for g in gs)
        with _collective():
            full = torch.cat([sum_in_order(by_block[b]) if len(by_block.get(b, ())) > 1
                              else by_block[b][0] if b in by_block else ref.new_zeros(shape)
                              for b, shape in enumerate(ctx.block_shapes)], 0)
        count_wire("all-gather", _nbytes(full), len(ctx.part), "scatter")
        out = [full.index_select(0, d.to(ctx.lead)).to(dev, dt)
               for (dev, dt), d in zip(ctx.part, dsts)]
        return (None,) * 6 + (*out, *(None,) * len(dsts))


def scatter_sum(vals: Sequence, dst: Sequence, n: int, mesh, sum_axes, block_axes,
                dtype: torch.dtype | None = None) -> tuple:
    """Each position's edge values (``vals``) summed by their destination
    rows (``dst``, global ids below ``n``) over ``sum_axes`` and each
    position given its node block over ``block_axes``, cast to ``dtype``
    (default the values'): :func:`summed_scatter` of each position's
    segment sum, with one accumulator a group in place of a whole-graph
    partial a position.  The backward all-gathers the blocks' gradients and
    gathers each position's rows."""
    sum_axes, block_axes = tuple(sum_axes), tuple(block_axes)
    n_blocks = mesh.size(block_axes)
    out: list = [None] * len(vals)
    for grp in groups(mesh, sum_axes):
        lead = mesh.devices[grp[0]]
        targets = tuple(dict.fromkeys((block_index(mesh, p, block_axes), mesh.devices[p])
                                      for p in grp))
        res = _ScatterSum.apply(n, n_blocks, lead, targets, dtype or vals[grp[0]].dtype, len(grp),
                                *(vals[p] for p in grp), *(dst[p] for p in grp))
        got = dict(zip(targets, res))
        for p in grp:
            out[p] = got[block_index(mesh, p, block_axes), mesh.devices[p]]
    return tuple(out)
