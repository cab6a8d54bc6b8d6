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
whose entries are the same objects share one call, not one count).  The
same bytes go to :data:`LINK_WIRE` by the link they cross: positions are
numbered row-major over the mesh axes and each run of
:data:`NODE_CARDS` consecutive positions is one node, so a group
whose positions lie in one node moves them over NVLink and a group that
spans nodes over the network between nodes, charged whole at its rate.

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

import contextlib
import threading

import torch

from repro_torch.dist.sharding import block_index, coords

NODE_CARDS = 8  # cards a node joins by NVLink (a DGX H100)

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
    """Within it, :func:`served` is ``positions`` and :func:`lane` is
    ``lane`` (under the shortcut)."""

    __slots__ = ("positions", "lane", "prev")

    def __init__(self, positions: tuple, lane: tuple | None = None):
        self.positions = positions
        self.lane = lane

    def __enter__(self):
        self.prev = (getattr(_SERVING, "at", None), getattr(_SERVING, "lane", None))
        _SERVING.at, _SERVING.lane = self.positions, self.lane

    def __exit__(self, *exc):
        _SERVING.at, _SERVING.lane = self.prev


class _InLane:
    """Within it, :func:`lane` is ``lane``; :func:`served` unchanged."""

    __slots__ = ("lane", "prev")

    def __init__(self, lane: tuple | None):
        self.lane = lane

    def __enter__(self):
        self.prev = getattr(_SERVING, "lane", None)
        _SERVING.lane = self.lane

    def __exit__(self, *exc):
        _SERVING.lane = self.prev


def served() -> tuple | None:
    """The mesh positions the running :func:`per_position` call or
    collective combine serves (in order), None outside one."""
    return getattr(_SERVING, "at", None)


def lane() -> tuple | None:
    """(data-parallel axes bitmask, copies) of the running call or combine
    under the shortcut (``launch/lanes.py``), None outside one or without
    it."""
    return getattr(_SERVING, "lane", None)


# ---------------------------------------------------------------------------
# the dry run's shortcut (``launch/lanes.py``): None outside one
# ---------------------------------------------------------------------------

_SHORTCUT = None  # the running shortcut's ``lanes.Lanes``, set by it


def shortcut():
    """The running dry run's shortcut (``launch/lanes.Lanes``), None
    without one."""
    return _SHORTCUT


def in_lane(ln: tuple | None):
    """A context in which :func:`lane` is ``ln`` (:func:`served` unchanged)."""
    return _InLane(ln)


def each_slice(fn: Callable, mesh, rows: Sequence) -> list:
    """``fn(i, row)`` of every data slice (``rows``: ``mesh.grid()``); under
    the shortcut slice 0's stands for every slice."""
    if _SHORTCUT is None or len(rows) == 1:
        return [fn(i, row) for i, row in enumerate(rows)]
    return _SHORTCUT.each_slice(fn, mesh, rows)


def once():
    """A context for the caller's join of every data slice's results on one
    device: under the shortcut its ops run once."""
    return _InLane((0, 1) if _SHORTCUT is not None else None)


def _segment():
    """The shortcut's segment (``Lanes.segment``), else nothing."""
    return _SHORTCUT.segment() if _SHORTCUT is not None else contextlib.nullcontext()


# wire bytes a kind of collective has moved, summed over mesh positions; the same bytes by
# the link they crossed; and the part of them the graph collectives moved, by collective,
# both directions
WIRE: dict[str, float] = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0}
LINK_WIRE: dict[str, float] = {"nvlink": 0.0, "network": 0.0}
GRAPH_WIRE: dict[str, float] = {"halo": 0.0, "scatter": 0.0}
_WIRE_LOCK = threading.Lock()
_FACTOR = {"all-reduce": lambda g: 2.0 * (g - 1) / g, "all-gather": lambda g: (g - 1) / g,
           "reduce-scatter": lambda g: (g - 1) / g}


def reset_wire() -> None:
    for tally in (WIRE, LINK_WIRE, GRAPH_WIRE):
        for k in tally:
            tally[k] = 0.0


def wire_bytes() -> dict[str, float]:
    """A copy of :data:`WIRE` (bytes over every position, by kind)."""
    return dict(WIRE)


def link_bytes() -> dict[str, float]:
    """A copy of :data:`LINK_WIRE` (bytes over every position, by link)."""
    return dict(LINK_WIRE)


def link(group) -> str:
    """"nvlink" where the positions of ``group`` lie in one node (a run of
    ``NODE_CARDS`` row-major positions), else "network"."""
    nodes = {p // NODE_CARDS for p in group}
    return "nvlink" if len(nodes) == 1 else "network"


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, tuple):
        return sum(_nbytes(x) for x in v)
    return 0


def count_wire(kind: str, full_bytes: float, group, graph: str | None = None) -> None:
    """A ``kind`` collective of a ``full_bytes`` tensor over the mesh
    positions of ``group`` (a sequence; an int ``g`` stands for positions
    ``0 .. g-1``): each of them sends ``factor(g)`` of it, over the link of
    :func:`link` (``graph``: the graph collective it belongs to, for
    :data:`GRAPH_WIRE`)."""
    if isinstance(group, int):
        group = range(group)
    g = len(group)
    if g > 1:
        nbytes = full_bytes * _FACTOR[kind](g) * g
        via = link(group)
        with _WIRE_LOCK:  # backward hooks run on each device's autograd thread
            WIRE[kind] += nbytes
            LINK_WIRE[via] += nbytes
            if graph is not None:
                GRAPH_WIRE[graph] += nbytes


def count_over(kind: str, nbytes: float, mesh, axes) -> None:
    """A ``kind`` collective of ``nbytes`` in every group over ``axes``
    (a sum the caller makes itself, e.g. on one device)."""
    for grp in groups(mesh, axes):
        count_wire(kind, nbytes, grp)


_GROUPS: dict = {}


def groups(mesh, axes) -> list[tuple[int, ...]]:
    """The positions of each group over ``axes``: equal coordinates on every
    other axis, ordered by their block index over ``axes``."""
    axes = tuple(axes)
    key = (id(mesh), axes)
    got = _GROUPS.get(key)
    if got is not None and got[0] is mesh:
        return got[1]
    rest = [a for a in mesh.axis_names if a not in axes]
    by_key: dict = {}
    for pos in range(len(mesh.devices)):
        c = coords(mesh, pos)
        by_key.setdefault(tuple(c[a] for a in rest), []).append(pos)
    out = tuple(tuple(sorted(g, key=lambda p: block_index(mesh, p, axes)))
                for g in by_key.values())
    _GROUPS[key] = (mesh, out)
    return out


def _key(v):
    """Identity of an entry (a tensor, a tuple, list or dict of them, or a
    plain value)."""
    if isinstance(v, torch.Tensor):
        return ("t", id(v))
    if isinstance(v, (tuple, list)):
        return tuple(_key(x) for x in v)
    if isinstance(v, dict):
        return tuple((k, _key(x)) for k, x in v.items())
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
    tr = _SHORTCUT
    vary = 0
    if tr is not None:
        args, vary = tr.fold(args)
    calls: dict = {}
    keys = []
    known: dict = {}  # id(entry) -> its key (positions often share an entry)
    for pos, dev in enumerate(mesh.devices):
        vals = [a[pos] for a in args]
        ks = []
        for v in vals:
            k = known.get(id(v))
            if k is None:
                k = known[id(v)] = _key(v)
            ks.append(k)
        key = (dev, tuple(ks))
        calls.setdefault(key, (vals, []))[1].append(pos)
        keys.append(key)
    done = {}
    with _segment():
        for key, (vals, positions) in calls.items():
            positions = tuple(positions)
            ln = None
            if tr is not None:
                vals, ln = tr.call(positions, vals, vary)
            with _Serving(positions, ln):
                done[key] = fn(*vals)
    return tuple(done[k] for k in keys)


def _count_backward(res, kind: str, group) -> None:
    """Count ``kind`` over the positions of ``group`` when the gradient of
    ``res`` arrives (a gather's backward is a reduce-scatter of the same
    bytes); nothing where no gradient will flow."""
    if isinstance(res, torch.Tensor) and res.requires_grad:
        res.register_hook(lambda grad: count_wire(kind, _nbytes(grad), group))


def _marked(parts: Sequence, mesh, axes, kind: str) -> None:
    """One ``kind`` counted a group over ``axes`` when the gradient of the
    group's first entry arrives."""
    for grp in groups(mesh, axes):
        _count_backward(parts[grp[0]], kind, grp)


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
    reduce-scatter).  A ``combine`` with ``folds`` set takes ``(entries,
    mult, lanes)`` under the shortcut: each distinct entry once, standing
    for ``mult`` in a row (:func:`_in_order`)."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    with _segment():
        return _reduce_over(parts, mesh, axes, combine, kind)


def _reduce_over(parts: Sequence, mesh, axes, combine: Callable, kind: str) -> tuple:
    out: list = [None] * len(parts)
    memo: dict = {}
    copies: dict = {}
    tr = _SHORTCUT
    for grp, key, lead, served_by in _grouped(parts, mesh, axes):
        if key not in memo:
            entries, ln = [parts[p] for p in grp], None
            if tr is not None:
                entries = tr.entries(parts, grp, axes, served_by)
                ln = tr.combine(parts, grp, axes, served_by)
            with _collective(), _Serving(served_by, ln):
                if tr is not None and getattr(combine, "folds", False):
                    keep, mult = _repeats(grp, parts)  # a class's repeated entries: once
                    memo[key] = combine([_to(entries[i], lead) for i in keep], mult, ln)
                else:
                    memo[key] = combine([_to(e, lead) for e in entries])
        res = memo[key]
        count_wire(kind, _nbytes(res), grp)
        if kind == "all-gather":
            _count_backward(res, "reduce-scatter", grp)
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


def over_slices(fn, parts: Sequence, mesh):
    """``fn`` of one entry a data slice (each slice's first model shard's),
    in data order, on the mesh's lead device: a sum or concatenation over
    the data slices that the caller makes on one device."""
    firsts = tuple(row[0] for row in mesh.grid())
    lead = mesh.lead
    if _SHORTCUT is None:
        return fn([parts[p].to(lead) for p in firsts])
    return _SHORTCUT.over_slices(fn, parts, mesh, firsts)


def _in_order(vals, start, step, mult=None, lanes=None):
    """``step`` folded over ``vals`` in order from ``start(vals[0])``; with
    ``mult`` (the shortcut's repeated entries) ``vals[i]`` stands for
    ``mult[i]`` entries in a row, each of its steps one op of that weight
    in the combine's lane ``lanes``."""
    acc = start(vals[0])
    for i, v in enumerate(vals):
        k = (1 if mult is None else mult[i]) - (i == 0)
        if k:
            with weighed(lanes, k):  # the first entry's repeats pass no second gradient
                acc = step(acc, v.detach() if i == 0 else v)
    return acc


def sum_in_order(vals, mult=None, lanes=None):
    """The sum of ``vals`` in order; a float type narrower than f32 is
    summed in f32 and rounded once (``mult``, ``lanes``: :func:`_in_order`)."""
    dt = vals[0].dtype
    wide = dt.is_floating_point and torch.finfo(dt).bits < 32
    acc = _in_order(vals, lambda v: v.float() if wide else v.clone(),
                    lambda a, v: a + (v.float() if wide else v), mult, lanes)
    return acc.to(dt)


def max_in_order(vals, mult=None, lanes=None):
    """The elementwise maximum of ``vals`` in order (``mult``, ``lanes``:
    :func:`_in_order`)."""
    return _in_order(vals, lambda v: v, torch.maximum, mult, lanes)


sum_in_order.folds = max_in_order.folds = True


def psum(parts: Sequence, mesh, axes) -> tuple:
    """Sum over ``axes`` (bf16 summed in f32 and rounded once)."""
    return reduce_over(parts, mesh, axes, sum_in_order)


def pmax(parts: Sequence, mesh, axes) -> tuple:
    """Elementwise maximum over ``axes``."""
    return reduce_over(parts, mesh, axes, max_in_order)


def all_gather(parts: Sequence, mesh, axes, dim: int) -> tuple:
    """Concatenation along ``dim`` over ``axes``, in block order.  Its
    backward (autograd's, through the one concatenation a group) gives each
    entry its block of the gathered value's gradient, summed over every
    position that took it."""
    return reduce_over(parts, mesh, axes, lambda vals: torch.cat(vals, dim=dim), "all-gather")


def _lane_entries(parts, grp, axes, positions) -> tuple[list, int | None]:
    """Group ``grp``'s entries for a combine over ``axes`` serving
    ``positions``, and under the shortcut the lanes of its result (else
    None)."""
    if _SHORTCUT is None:
        return [parts[p] for p in grp], None
    return _SHORTCUT.combine_entries(parts, grp, axes, positions)


def _lane(lanes: int | None, positions) -> tuple | None:
    """The lane of a combine's work of result lanes ``lanes`` that serves
    ``positions`` (None without the shortcut)."""
    return None if lanes is None else _SHORTCUT.narrow(lanes, positions)


class _ReduceScatter(torch.autograd.Function):
    """A group's entries summed in order on ``lead`` (:func:`sum_in_order`)
    and split along ``dim`` into one block an entry; block ``b`` delivered
    to each device of ``targets``' ``(b, device)`` as a storage of its own
    (a view would keep the whole sum alive), made while :func:`served`
    names ``at[i]``, the positions that take target ``i`` (the sum: all of
    them).  Backward: the blocks' gradients concatenated on ``lead`` (an
    all-gather, counted for each group of ``served`` the call serves) and
    given to every entry."""

    @staticmethod
    def forward(ctx, dim, lead, targets, at, served, lanes, *entries):
        every = tuple(sorted(q for ps in at for q in ps))
        with _collective(), _Serving(every, _lane(lanes, every)):
            total = sum_in_order([_to(e, lead) for e in entries])
        blocks = total.chunk(len(entries), dim)
        ctx.dim, ctx.lead, ctx.targets, ctx.served = dim, lead, targets, served
        ctx.lanes = _lane(lanes, every)
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(e.device, e.dtype) for e in entries]
        out = []
        for (b, dev), positions in zip(targets, at):
            with _Serving(positions, _lane(lanes, positions)):
                out.append(blocks[b].clone() if dev == lead else blocks[b].to(dev))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        with _InLane(ctx.lanes):
            return _ReduceScatter._backward(ctx, *grads)

    @staticmethod
    def _backward(ctx, *grads):
        by_block: dict = {}
        for (b, _), g in zip(ctx.targets, grads):
            if g is not None:
                by_block.setdefault(b, []).append(g.to(ctx.lead))
        ref = next(g for gs in by_block.values() for g in gs)
        with _collective():
            full = torch.cat([sum_in_order(by_block[b]) if len(by_block.get(b, ())) > 1
                              else by_block[b][0] if b in by_block else ref.new_zeros(shape)
                              for b, shape in enumerate(ctx.block_shapes)], ctx.dim)
        for grp in ctx.served:
            count_wire("all-gather", _nbytes(full), grp)
        made: dict = {}
        out = []
        for dev, dt in ctx.part:
            if (dev, dt) not in made:
                made[dev, dt] = full.to(device=dev, dtype=dt)
            out.append(made[dev, dt])
        return (None, None, None, None, None, None, *out)


def reduce_scatter(parts: Sequence, mesh, axes, dim: int) -> tuple:
    """Each group's entries over ``axes`` summed (:func:`sum_in_order` on
    the group's lead device, as :func:`psum`) and each position given its
    block of the sum along ``dim`` over ``axes``, in block order: a storage
    of its own a (device, block).  The backward all-gathers the blocks'
    gradients to every entry.  No axes: ``parts`` unchanged."""
    axes = tuple(axes)
    if not axes or mesh.size(axes) == 1:
        return tuple(parts)
    with _segment():
        return _reduce_scatter(parts, mesh, axes, dim)


def _reduce_scatter(parts: Sequence, mesh, axes: tuple, dim: int) -> tuple:
    out: list = [None] * len(parts)
    memo: dict = {}
    grouped = _grouped(parts, mesh, axes)
    sharing: dict = {}
    for grp, key, _, _ in grouped:
        sharing.setdefault(key, []).append(grp)
    for grp, key, lead, served_by in grouped:
        if key not in memo:
            at: dict = {}
            for q in served_by:
                at.setdefault((block_index(mesh, q, axes), mesh.devices[q]), []).append(q)
            entries, lanes = _lane_entries(parts, grp, axes, served_by)
            res = _ReduceScatter.apply(dim, lead, tuple(at), tuple(map(tuple, at.values())),
                                       tuple(sharing[key]), lanes, *entries)
            memo[key] = dict(zip(at, res))
        count_wire("reduce-scatter", _nbytes(parts[grp[0]]), grp)
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
    counted for each group of ``served`` the call serves."""

    @staticmethod
    def forward(ctx, dim, lead, devs, served, lanes, *entries):
        ctx.lanes = _lane(lanes, tuple(p for grp in served for p in grp))
        with _InLane(ctx.lanes):
            full = torch.cat([e.to(lead) for e in entries], dim)
        ctx.dim, ctx.lead, ctx.served = dim, lead, served
        ctx.sizes = [e.shape[dim] for e in entries]
        ctx.entry_devs = [e.device for e in entries]
        for grp in served:
            count_wire("all-gather", _nbytes(full), grp, "halo")
        return tuple(full if d == lead else full.to(d) for d in devs)

    @staticmethod
    def backward(ctx, *grads):
        with _InLane(ctx.lanes):
            got = [g.to(ctx.lead) for g in grads if g is not None]
            with _collective():
                total = sum_in_order(got) if len(got) > 1 else got[0]
            for grp in ctx.served:
                count_wire("reduce-scatter", _nbytes(total), grp, "halo")
            pieces = total.split(ctx.sizes, ctx.dim)
            out = []
            for i, (p, d) in enumerate(zip(pieces, ctx.entry_devs)):
                # each block a storage of its own, made for the positions it goes to
                with _Serving(tuple(sorted(g[i] for g in ctx.served)), ctx.lanes):
                    out.append(p.clone() if d == ctx.lead else p.to(d))
            return (None, None, None, None, None, *out)


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
    sharing: dict = {}
    for grp, _, key in keyed:
        sharing.setdefault(key, []).append(grp)
    for grp, devs, key in keyed:
        if key not in memo:
            entries, lanes = _lane_entries(parts, grp, axes,
                                           tuple(p for g in sharing[key] for p in g))
            memo[key] = dict(zip(devs, _Gather.apply(dim, devs[0], devs, tuple(sharing[key]),
                                                     lanes, *entries)))
        for p in grp:
            out[p] = memo[key][mesh.devices[p]]
    return tuple(out)


def _gathered(by_block: dict, shapes, dim: int, folded: bool = False) -> torch.Tensor:
    """The blocks' gradients (``by_block``: block -> the gradients of its
    targets) concatenated along ``dim``: a block's summed in order over its
    targets, a block of none zeros; ``folded`` (:func:`_folds`): block 0's
    stands for every block's."""
    if folded:
        g = sum_in_order(by_block[0]) if len(by_block[0]) > 1 else by_block[0][0]
        return torch.cat([g] * len(shapes), dim)
    ref = next(g for gs in by_block.values() for g in gs)
    return torch.cat([sum_in_order(by_block[b]) if len(by_block.get(b, ())) > 1
                      else by_block[b][0] if b in by_block else ref.new_zeros(shape)
                      for b, shape in enumerate(shapes)], dim)


def _folds(block_axes, n: int, dim_size: int) -> int:
    """Under the shortcut, the lanes of ``n`` blocks of one size over
    ``block_axes`` where block 0 stands for every block (``Lanes.folds``);
    else 0."""
    if _SHORTCUT is None or n < 2 or dim_size % n:
        return 0
    return _SHORTCUT.folds(block_axes)


def _targets(mesh, grp, block_axes, folded: int) -> tuple:
    """The (block, device) pairs of ``grp``'s positions; block 0's alone
    where the blocks fold."""
    got = dict.fromkeys((0 if folded else block_index(mesh, p, block_axes), mesh.devices[p])
                        for p in grp)
    return tuple(got)


def _delivered(res, targets, folded: int) -> dict:
    """{(block, device): result}, each folded result tagged with the lanes
    its block stands for."""
    for r in res if folded else ():
        _SHORTCUT.tag(r, folded)
    return dict(zip(targets, res))


def _repeats(grp, *seqs) -> tuple[list[int], tuple[int, ...]]:
    """Under the shortcut, the indices into ``grp`` of its positions' first
    entries of each distinct object in ``seqs`` and how many positions
    hold each (a class's shared parts stand for that many copies); else
    every index, once."""
    if _SHORTCUT is None:
        return list(range(len(grp))), (1,) * len(grp)
    first: dict = {}
    for i, p in enumerate(grp):
        first.setdefault(tuple(id(s[p]) for s in seqs), []).append(i)
    return [ix[0] for ix in first.values()], tuple(len(ix) for ix in first.values())


def weighed(lanes, m: int, bits: int | None = None):
    """A context in which an op stands for ``m`` copies of itself in the
    combine's lane ``lanes`` (its storages of lanes ``bits`` where given);
    nothing for one copy or without a lane, so within another such context
    an op of one copy takes the outer weight: do not nest them."""
    if lanes is None or m == 1:
        return contextlib.nullcontext()
    return _InLane((lanes[0] if bits is None else bits, lanes[1] * m))


class _SummedScatter(torch.autograd.Function):
    """Distinct partials (whole arrays) summed in order on ``lead`` (a float
    type narrower than f32 in f32), then split along ``dim`` into
    ``n_blocks`` blocks, block ``b`` delivered to each device of
    ``targets``' ``(b, device)``; backward: the blocks' gradients
    concatenated (an all-gather) and given to every partial."""

    @staticmethod
    def forward(ctx, dim, n_blocks, lead, targets, out_dtype, grp, lanes, folded, mult,
                *partials):
        ctx.lanes, ctx.folded = _lane(lanes, grp), folded
        with _InLane(ctx.lanes):
            return _SummedScatter._forward(ctx, dim, n_blocks, lead, targets, out_dtype, grp,
                                           mult, *partials)

    @staticmethod
    def _forward(ctx, dim, n_blocks, lead, targets, out_dtype, grp, mult, *partials):
        with _collective():
            total = sum_in_order([p.to(lead) for p in partials], mult, ctx.lanes) \
                if len(grp) > 1 else partials[0].to(lead)
        total = total.to(out_dtype)
        blocks = total.chunk(n_blocks, dim)
        ctx.dim, ctx.lead, ctx.targets, ctx.grp = dim, lead, targets, grp
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(p.device, p.dtype) for p in partials]
        count_wire("reduce-scatter", _nbytes(partials[0]), grp, "scatter")
        return tuple(blocks[b] if d == lead else blocks[b].to(d) for b, d in targets)

    @staticmethod
    def backward(ctx, *grads):
        with _InLane(ctx.lanes):
            by_block: dict = {}
            for (b, _), g in zip(ctx.targets, grads):
                if g is not None:
                    by_block.setdefault(b, []).append(g.to(ctx.lead))
            with _collective():
                full = _gathered(by_block, ctx.block_shapes, ctx.dim, ctx.folded)
            count_wire("all-gather", _nbytes(full), ctx.grp, "scatter")
            made: dict = {}
            out = []
            for dev, dt in ctx.part:
                if (dev, dt) not in made:
                    made[dev, dt] = full.to(device=dev, dtype=dt)
                out.append(made[dev, dt])
            return (None,) * 9 + (*out,)


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
    folded = _folds(block_axes, n_blocks, parts[0].shape[dim])
    for grp in groups(mesh, sum_axes):
        lead = mesh.devices[grp[0]]
        partials, lanes = _lane_entries(parts, grp, sum_axes, grp)
        keep, mult = _repeats(grp, parts)
        targets = _targets(mesh, grp, block_axes, folded)
        res = _SummedScatter.apply(dim, n_blocks, lead, targets, dtype or partials[0].dtype, grp,
                                   lanes, folded, mult, *(partials[i] for i in keep))
        got = _delivered(res, targets, folded)
        for p in grp:
            out[p] = got[0 if folded else block_index(mesh, p, block_axes), mesh.devices[p]]
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
    def forward(ctx, n, n_blocks, lead, targets, out_dtype, grp, lanes, folded, mult,
                *vals_and_dst):
        ctx.lanes, ctx.folded = _lane(lanes, grp), folded
        with _InLane(ctx.lanes):
            return _ScatterSum._forward(ctx, n, n_blocks, lead, targets, out_dtype, grp, mult,
                                        *vals_and_dst)

    @staticmethod
    def _forward(ctx, n, n_blocks, lead, targets, out_dtype, grp, mult, *vals_and_dst):
        n_pos = len(vals_and_dst) // 2
        vals, dsts = vals_and_dst[:n_pos], vals_and_dst[n_pos:]
        dt = vals[0].dtype
        wide = dt.is_floating_point and torch.finfo(dt).bits < 32
        acc = torch.zeros((n, *vals[0].shape[1:]), dtype=torch.float32 if wide else dt,
                          device=lead)
        with _collective():
            for v, d, m in zip(vals, dsts, mult):
                with weighed(ctx.lanes, m):
                    acc.index_add_(0, d.to(lead), v.to(lead, acc.dtype))
        blocks = acc.to(out_dtype).chunk(n_blocks, 0)
        ctx.lead, ctx.targets, ctx.grp = lead, targets, grp
        ctx.block_shapes = [b.shape for b in blocks]
        ctx.part = [(v.device, v.dtype) for v in vals]
        ctx.mult = [(m, _SHORTCUT.of(v) if m > 1 else 0) for v, m in zip(vals, mult)]
        ctx.save_for_backward(*dsts)
        count_wire("reduce-scatter", acc.numel() * acc.element_size(), grp, "scatter")
        return tuple(blocks[b] if d == lead else blocks[b].to(d) for b, d in targets)

    @staticmethod
    def backward(ctx, *grads):
        with _InLane(ctx.lanes):
            return _ScatterSum._backward(ctx, *grads)

    @staticmethod
    def _backward(ctx, *grads):
        dsts = ctx.saved_tensors
        by_block: dict = {}
        for (b, _), g in zip(ctx.targets, grads):
            if g is not None:
                by_block.setdefault(b, []).append(g.to(ctx.lead))
        with _collective():
            full = _gathered(by_block, ctx.block_shapes, 0, ctx.folded)
        count_wire("all-gather", _nbytes(full), ctx.grp, "scatter")
        out = []
        for (dev, dt), d, (m, bits) in zip(ctx.part, dsts, ctx.mult):
            with weighed(ctx.lanes, m, bits):  # a repeated entry's rows: each copy's
                out.append(full.index_select(0, d.to(ctx.lead)).to(dev, dt))
        return (None,) * 9 + (*out, *(None,) * len(dsts))


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
    folded = _folds(block_axes, n_blocks, n)
    for grp in groups(mesh, sum_axes):
        lead = mesh.devices[grp[0]]
        targets = _targets(mesh, grp, block_axes, folded)
        entries, lanes = _lane_entries(vals, grp, sum_axes, grp)
        keep, mult = _repeats(grp, vals, dst)
        res = _ScatterSum.apply(n, n_blocks, lead, targets, dtype or vals[grp[0]].dtype, grp,
                                lanes, folded, mult, *(entries[i] for i in keep),
                                *(dst[grp[i]] for i in keep))
        got = _delivered(res, targets, folded)
        for p in grp:
            out[p] = got[0 if folded else block_index(mesh, p, block_axes), mesh.devices[p]]
    return tuple(out)
