"""The dry run's data-parallel shortcut (``launch/dryrun.py``).

On a mesh of several nodes the positions that differ only in their
data-parallel coordinates (every axis but ``model``) run the same
operations on parts of the same shapes.  Under :class:`Lanes` they hold
the same objects, so ``dist/collectives.py``'s per-position calls and
combines run once a class and the dry run's counters weigh each op and
storage by the copies it stands for.  ``collectives`` knows the shortcut
only through its hook (``collectives._SHORTCUT``, set while a
:class:`Lanes` is entered) and the methods it calls on it; with none
entered it runs as it always does.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import operator

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import coords

LANE_ATTR = "_dp_lanes"  # a tensor's bitmask of the data-parallel axes its copies vary over
COPY_ATTR = "_dp_copy"  # on a view of one copy of a storage: (lanes bitmask, the copy's coords)


class Lanes:
    """The shortcut of a dry run on ``mesh`` (``launch/dryrun.py``).

    Positions that differ only in their data-parallel coordinates (every
    axis but ``model``) run the same operations on parts of the same
    shapes; under the shortcut they hold the same objects, so
    ``collectives.per_position`` and every combine run once for all of
    them.  A
    tensor carries in :data:`LANE_ATTR` the data-parallel axes over which
    the full emulation would hold distinct copies of it (its lanes); a call
    or combine runs while :func:`lane` names its axes and the number of
    distinct calls the full emulation would make, and the dry run's
    counters weigh every op and storage by it (outside one: by the copies
    of its inputs' axes).  Where lanes meet, the shortcut makes the full
    emulation's gradient sums: a value of fewer lanes read by a call of more
    gets the sum of its readers' gradients (:class:`_Fan`), and a combine
    over axes its entries vary over reads each lane's copy once
    (:class:`_LaneAlias`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.bit = {a: 1 << i for i, a in enumerate(mesh.axis_names) if a != "model"}
        self.size = {1 << i: n for i, (a, n) in enumerate(zip(mesh.axis_names, mesh.sizes))
                     if a != "model"}
        self.at = [coords(mesh, p) for p in range(len(mesh.devices))]
        self.stride = {}
        step = 1
        for a, n in zip(reversed(mesh.axis_names), reversed(mesh.sizes)):
            self.stride[a] = step
            step *= n
        self._memo: dict = {}  # the answers below, by their arguments
        self.live = None  # the dry run's counter of live bytes while it counts

    def __enter__(self):
        self.prev, col._SHORTCUT = col._SHORTCUT, self
        return self

    def __exit__(self, *exc):
        col._SHORTCUT = self.prev

    def of(self, x) -> int:
        """The lanes of the tensors in ``x`` (nested tuples, lists, dicts)."""
        if isinstance(x, torch.Tensor):
            return getattr(x, LANE_ATTR, 0)
        if isinstance(x, dict):
            x = x.values()
        elif not isinstance(x, (tuple, list)):
            return 0
        bits = 0
        for v in x:
            bits |= self.of(v)
        return bits

    def axes_bits(self, axes) -> int:
        return sum(self.bit.get(a, 0) for a in set(axes))

    def weight(self, bits: int) -> int:
        """Copies over the axes of ``bits``: the product of their sizes."""
        w = 1
        for b, n in self.size.items():
            if bits & b:
                w *= n
        return w

    def copies(self, positions, bits: int) -> int:
        """The distinct copies over the axes of ``bits`` among ``positions``."""
        if not bits:
            return 1
        key = ("copies", tuple(positions), bits)
        got = self._memo.get(key)
        if got is None:
            axes = [a for a, b in self.bit.items() if bits & b]
            got = self._memo[key] = len({tuple(self.at[p][a] for a in axes)
                                         for p in positions})
        return got

    def coords_of(self, pos: int, bits: int) -> tuple:
        """Position ``pos``'s coordinates along the axes of ``bits``."""
        return tuple(self.at[pos][a] for a, b in self.bit.items() if bits & b)

    def every_copy(self, bits: int) -> list[tuple]:
        """The coordinates of every copy along the axes of ``bits``."""
        return list(itertools.product(*(range(self.mesh.shape[a])
                                         for a, b in self.bit.items() if bits & b)))

    def _move(self, p: int, axes, copy) -> int:
        """Position ``p`` moved by ``copy`` along ``axes`` (cyclically)."""
        q = p
        for a, c in zip(axes, copy):
            size = self.mesh.shape[a]
            q += ((self.at[p][a] + c) % size - self.at[p][a]) * self.stride[a]
        return q

    def moved(self, mask: int, bits: int, copy: tuple) -> int:
        """A positions bitmask (``mask``'s positions being copy 0's, at
        coordinate 0 along the axes of ``bits``) moved to copy ``copy``;
        bits past the mesh's positions are kept."""
        key = ("moved", mask, bits, copy)
        got = self._memo.get(key)
        if got is None:
            n = len(self.at)
            axes = [a for a, b in self.bit.items() if bits & b]
            got = mask >> n << n
            rest = mask & ((1 << n) - 1)
            while rest:
                low = rest & -rest
                rest ^= low
                got |= 1 << self._move(low.bit_length() - 1, axes, copy)
            self._memo[key] = got
        return got

    def position_moves(self, bits: int) -> list[tuple]:
        """For each copy over the axes of ``bits`` (in :meth:`every_copy`'s
        order), each position moved to it from copy 0."""
        key = ("moves", bits)
        got = self._memo.get(key)
        if got is None:
            axes = [a for a, b in self.bit.items() if bits & b]
            got = self._memo[key] = [tuple(self._move(p, axes, c) for p in range(len(self.at)))
                                     for c in self.every_copy(bits)]
        return got

    @contextlib.contextmanager
    def segment(self):
        """A per-position call over every position or a combine, which the
        full emulation runs once a lane, the lanes one after the other: the
        dry run's counter (``live``, while it counts) takes its storages'
        trajectory as one lane's and adds the others' when it ends."""
        live = self.live
        if live is None or not live.begin_segment():
            yield
            return
        try:
            yield
        finally:
            live.end_segment()

    def first_copy(self, mask: int, bits: int) -> int:
        """The positions of ``mask`` at coordinate 0 along the axes of
        ``bits`` (copy 0's), bits past the mesh's positions kept."""
        if not bits:
            return mask
        key = ("first", mask, bits)
        got = self._memo.get(key)
        if got is None:
            n = len(self.at)
            got = mask >> n << n
            for p in range(n):
                if mask >> p & 1 and not any(self.coords_of(p, bits)):
                    got |= 1 << p
            self._memo[key] = got
        return got

    def class_of(self, pos: int) -> frozenset:
        """The positions equal to ``pos`` but for their data-parallel
        coordinates."""
        got = self._memo.get(("class", pos))
        if got is None:
            model = self.at[pos].get("model")
            got = self._memo["class", pos] = frozenset(
                p for p in range(len(self.at)) if self.at[p].get("model") == model)
        return got

    def spread(self, positions) -> int:
        """The data-parallel axes along which ``positions`` differ."""
        key = ("spread", tuple(positions))
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = sum(b for a, b in self.bit.items()
                                        if len({self.at[p][a] for p in key[1]}) > 1)
        return got

    def fold(self, args) -> tuple[list, int]:
        """Per-position arguments with each integer one that varies with the
        data-parallel coordinates (an offset into a data slice's block)
        given, at every position, its class's first position's value, and
        the axes such integers vary along: the class then shares one call,
        whose results vary along them (the integers move no shape)."""
        out, vary = [], 0
        for a in args:
            if not (isinstance(a, (list, tuple)) and a and all(
                    isinstance(v, int) and not isinstance(v, bool) for v in a)):
                out.append(a)
                continue
            first = [a[self._class_first(p)] for p in range(len(a))]
            if first != list(a):
                vary |= sum(b for ax, b in self.bit.items() if any(
                    a[p] != a[p - self.at[p][ax] * self.stride[ax]] for p in range(len(a))))
            out.append(first)
        return out, vary

    def _class_first(self, pos: int) -> int:
        """The position of ``pos``'s class at data-parallel coordinates 0."""
        return pos - sum(self.at[pos][ax] * self.stride[ax] for ax in self.bit)

    def call(self, positions, vals, vary: int = 0) -> tuple[list, tuple]:
        """A per-position call's entries (``vals``, serving ``positions``)
        as it reads them, and its lane: the lanes of its entries, and those
        its folded integers (``vary``) vary along, along which
        ``positions`` differ."""
        spread = self.spread(positions)
        bits = (self.of(vals) | vary) & spread
        n = self.copies(positions, bits)
        if self.of(vals) & ~spread or torch.is_grad_enabled():
            vals = [self._read(v, positions, spread, bits, n) for v in vals]
        return vals, (bits, n)

    def _read(self, v, positions, spread: int, bits: int, n: int):
        """Entry ``v`` as a call of lane ``bits`` (``n`` copies) over
        ``positions`` reads it: where ``v``'s lanes run along axes the call
        does not span, the call reads one copy (:class:`_LaneAlias`, the
        first copy's passing the gradient on); where the call spans lanes
        ``v`` lacks, each of ``v``'s copies is read by several of the full
        emulation's calls (:class:`_Fan`)."""
        if isinstance(v, (tuple, list)):
            return type(v)(self._read(x, positions, spread, bits, n) for x in v)
        if isinstance(v, dict):
            return {k: self._read(x, positions, spread, bits, n) for k, x in v.items()}
        if not isinstance(v, torch.Tensor):
            return v
        own = getattr(v, LANE_ATTR, 0)
        one = own & ~spread  # the lanes along which the call reads one copy
        if not (v.requires_grad and torch.is_grad_enabled()):
            if one:
                v = v.view_as(v)
                setattr(v, LANE_ATTR, own & spread)
                setattr(v, COPY_ATTR, (one, self.coords_of(positions[0], one)))
            return v
        if one:
            v = _LaneAlias.apply(not any(self.coords_of(positions[0], one)), own, own & spread,
                                 (one, self.coords_of(positions[0], one)), v)
            own &= spread
        if bits & ~own:
            mine = self.copies(positions, own)
            v = _Fan.apply(n // mine, (own, mine), v)
        return v

    def entries(self, parts, grp, axes, positions) -> list:
        """Group ``grp``'s entries of ``parts`` for a combine over ``axes``
        that serves ``positions``: where an entry's lanes run along
        ``axes``, or along axes the combine does not span, it stands for
        several copies and the combine reads one, each copy through its own
        :class:`_LaneAlias` (the first copy's passes the gradient on for
        all), so autograd sums no gradient the full emulation does not."""
        over = self.axes_bits(axes)
        lone = ~self.spread(positions)
        out, made, seen = [], {}, set()
        for p in grp:
            x = parts[p]
            own = self.of(x) if isinstance(x, torch.Tensor) and x.requires_grad else 0
            vb = own & (over | lone)
            if not vb or not torch.is_grad_enabled():
                out.append(x)
                continue
            key = (id(x), self.coords_of(p, vb))
            if key not in made:
                keep = id(x) not in seen and not any(self.coords_of(p, own & lone & ~over))
                made[key] = _LaneAlias.apply(keep, own, own & ~vb, (vb, key[1]), x)
                seen.add(id(x))
            out.append(made[key])
        return out

    def spread_read(self, mask: int, bits: int) -> int:
        """A positions bitmask (copy 0's) with every copy's along the axes
        of ``bits``."""
        key = ("spread_read", mask, bits)
        got = self._memo.get(key)
        if got is None:
            got = self._memo[key] = functools.reduce(
                operator.or_, (self.moved(mask, bits, c) for c in self.every_copy(bits)))
        return got

    def combine(self, parts, grp, axes, positions) -> tuple:
        """The lane of a combine over ``axes`` of group ``grp``'s entries
        that serves ``positions``: its entries' lanes less ``axes``, along
        which ``positions`` differ."""
        bits = self.of([parts[p] for p in grp]) & ~self.axes_bits(axes) & self.spread(positions)
        return bits, self.copies(positions, bits)

    # the hooks ``dist/collectives.py`` calls under the shortcut

    def each_slice(self, fn, mesh, rows) -> list:
        """Slice 0's ``fn(0, rows[0])``, run in the lane of the data axes,
        given to every slice."""
        bits = self.axes_bits(a for a in mesh.axis_names if a != "model")
        with self.segment(), col.in_lane((bits, len(rows))):
            out = fn(0, rows[0])
        return [out] * len(rows)

    def over_slices(self, fn, parts, mesh, firsts):
        """``fn`` of the data slices' entries (``firsts``' parts), run once
        on the lead device, each entry read as the copy of its slice."""
        dp = [a for a in mesh.axis_names if a != "model"]
        with col.in_lane((0, 1)):
            return fn([e.to(mesh.lead) for e in self.entries(parts, firsts, dp, firsts)])

    def combine_entries(self, parts, grp, axes, positions) -> tuple[list, int]:
        """:meth:`entries` and the lanes of the combine's result (its
        entries' less ``axes``)."""
        return (self.entries(parts, grp, axes, positions),
                self.of([parts[p] for p in grp]) & ~self.axes_bits(axes))

    def narrow(self, bits: int, positions) -> tuple:
        """The lane of work of lanes ``bits`` that serves ``positions``."""
        bits &= self.spread(positions)
        return bits, self.copies(positions, bits)

    def folds(self, block_axes) -> int:
        """The lanes of a collective's blocks over ``block_axes`` that block
        0 stands for (data-parallel axes only; 0 where ``model`` is one)."""
        return 0 if "model" in block_axes else self.axes_bits(block_axes)

    @staticmethod
    def tag(t, bits: int) -> None:
        """Mark ``t`` as standing for the copies along the axes of ``bits``."""
        setattr(t, LANE_ATTR, bits)


def weight_of(x) -> int:
    """The copies an op on ``x`` stands for under the running shortcut: the
    running call's or combine's, else those of ``x``'s lanes (1 without
    the shortcut)."""
    sc = col.shortcut()
    if sc is None:
        return 1
    ln = col.lane()
    return ln[1] if ln is not None else sc.weight(sc.of(x))


class _Fan(torch.autograd.Function):
    """A value of fewer lanes read by a call of ``k`` times as many: an
    alias whose backward makes the gradient sum the full emulation's ``k``
    readers' gradients would, ``k - 1`` additions into one accumulator (in
    place after the first, as autograd's own buffer holds two terms at
    most; the ``k - 2`` in place are one op of that weight), weighed by the
    value's own lane."""

    @staticmethod
    def forward(ctx, k, own, x):
        ctx.k, ctx.own = k, own
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with col.in_lane(ctx.own):
            acc = g.view_as(g) if ctx.k < 2 else g + g
        if ctx.k > 2:  # the other k - 2 additions in place: one op that stands for them
            bits, copies = ctx.own
            with col.in_lane((bits, copies * (ctx.k - 2))):
                acc.add_(g)
        setattr(acc, LANE_ATTR, ctx.own[0])
        return None, None, acc


class _LaneAlias(torch.autograd.Function):
    """One copy of ``x`` (of lanes ``lanes``) read on its own: an alias of
    the lanes ``bits`` it still stands for, marked with the copy it reads
    (``copy``: (lanes, coordinates), :data:`COPY_ATTR`); its backward
    passes its gradient on as the gradient of all of ``x``'s copies where
    ``keep``, and drops it elsewhere (another copy's)."""

    @staticmethod
    def forward(ctx, keep, lanes, bits, copy, x):
        ctx.keep, ctx.lanes = keep, lanes
        out = x.view_as(x)
        setattr(out, LANE_ATTR, bits)
        setattr(out, COPY_ATTR, copy)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.keep:
            return None, None, None, None, None
        h = g.view_as(g)
        setattr(h, LANE_ATTR, ctx.lanes)
        return None, None, None, None, h
