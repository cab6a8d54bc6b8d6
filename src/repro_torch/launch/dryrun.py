"""Dry run: build every (arch x shape x mesh) cell and run it once on the
``meta`` device, with no card and no memory.

For each cell this shows, without hardware:
  * the program builds and runs on the mesh (every layout and collective
    is exercised on tensors that hold shapes only),
  * how many flops and bytes it does (``flopcount``), what its
    collectives move (``dist.collectives.WIRE``) and the three roofline
    terms of an H100 SXM (``roofline``),
  * and its peak memory: the most bytes that live ``meta`` tensors held
    at once during the run, the arguments included, for each mesh
    position as a card of its own would hold them.  ``peak_mem_bytes``,
    ``arg_bytes``, ``temp_bytes`` and ``out_bytes`` are the position with
    the largest peak's (one device's, as the JAX record's memory analysis
    of the SPMD program is); ``mesh_peak_mem_bytes`` is the whole mesh's,
    the positions sharing the one ``meta`` device and a replicated value
    held once (what a mesh of one card holds).  On (1, 1) the two agree.

A storage counts for the positions that hold it: an argument for those
holding its ``Sharded`` part (the dry run gives each distinct part a
storage of its own), a storage made while a ``collectives.per_position``
call or a collective's combine runs for the positions it serves
(``collectives.served``); one made outside both (the controlling code, an
autograd backward, an optimizer update) for the positions that every
input storage it reads counts for (inputs of no common position: the
positions of any), an ``add`` (autograd summing a gradient's terms) for
the positions of all its inputs, and for the lead, position 0, where no
input is a position's.

On a mesh of more than one node the dry run takes a shortcut
(``lanes.Lanes``): the positions of a class, equal but for their
data-parallel coordinates, share their parts, so each class runs once and
every op and storage counts as the copies it stands for.  A per-position
call over every position, or a combine, is a segment (:class:`_Segment`):
its first lane is counted as it runs, the others' runs, one after the
other as the full emulation runs them, when it ends.  The flops, bytes,
wire bytes and arguments are the full emulation's; so are the memory keys
of a program without a backward.  In a backward the shortcut counts a
storage's copies live together where the full emulation, running the
lanes' backwards one after the other, may have freed some, and it cannot
see the full emulation's order there: its whole-mesh peak is then larger,
and a position's peak may differ by a few per cent either way (PERF.md,
the production table's gap column).

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh 1x1 --mesh 2x4]
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch --jobs 6
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k \
        --mesh 2x4 --rule seq_sp=none     # the residual stream whole (no seq_sp)
    python -m repro_torch.launch.dryrun --all --production --jobs 6   # 32x8 and 2x16x8

A mesh (1, 1) is one card, (2, 4) one 8-card node, (32, 8) and (2, 16, 8)
the production meshes of 256 cards (``mesh.make_production_mesh``); all are
meshes of ``meta`` devices.  One JSON file a cell is written, so a crashed
sweep resumes where it left off (``--force`` runs it again); the command
exits 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.launch.lanes import COPY_ATTR, LANE_ATTR, Lanes

DEFAULT_MESHES = ((1, 1), (2, 4))


def _flat_tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _flat_tensors(a)


def _placed_tensors(x, n: int):
    """(tensor, position or None) of every tensor in a program's arguments
    ``x``: a ``Sharded`` value's parts at their positions, a tuple of ``n``
    dataclasses (an engine's forest shards, one a position) likewise."""
    if isinstance(x, (list, tuple)) and n > 1 and len(x) == n and all(
            dataclasses.is_dataclass(v) and not isinstance(v, type) for v in x):
        for p, v in enumerate(x):
            yield from ((t, p) for t in _storages(v))
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _placed_tensors(v, n)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _placed_tensors(v, n)
    elif hasattr(x, "parts"):  # a Sharded value
        for p, t in enumerate(x.parts):
            yield t, (p if n > 1 else None)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _placed_tensors(getattr(x, f.name), n)
    else:
        yield from ((t, None) for t in _storages(x))


def _storages(x):
    """The tensors in ``x`` (nested sequences, dicts, ``Sharded`` values and
    dataclasses such as ``K2Forest``)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _storages(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _storages(v)
    elif hasattr(x, "parts"):  # a Sharded value
        yield from _storages(x.parts)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        yield from _storages([getattr(x, f.name) for f in dataclasses.fields(x)])


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes live storages hold while it is on, in all
    (``peak``) and for each of ``n_positions`` mesh positions
    (``peak_at``): every storage an op makes (and every one passed to
    :meth:`hold`) counts from then until only this mode still refers to
    it, for the positions of the module docstring's rule.  The exact live
    totals are taken only when a new storage could raise a peak.  With a
    ``cost`` it also counts each op (``flopcount.tally``; one mode, not
    two).  With ``lanes`` (the shortcut's ``lanes.Lanes``) a storage
    stands for the copies of its lanes, the full emulation's storages
    along the data-parallel axes it varies over: its mask is the first
    copy's positions, each copy's the same moved to its lanes."""

    def __init__(self, cost=None, n_positions: int = 1, lanes=None):
        super().__init__()
        self.cost = cost
        self.n = n_positions
        self.lanes = lanes
        # cdata -> [storage, nbytes, positions bitmask, lanes, lanes counted]; the bit
        # n_positions marks a storage of no position's (counted for position 0, the lead),
        # which a flow ignores; a storage made in a segment counts its first copy only (lanes
        # counted 0) until the segment ends
        self.held: dict[int, list] = {}
        self.young: list[int] = []  # storages made since the last sweep of every storage
        self.segment = None  # the running _Segment
        self.upper = 0  # >= the live bytes (frees found at the next sweep)
        self.peak = 0
        # each position's, as arrays: a storage of many positions updates them in one step
        self.upper_at = np.zeros(n_positions, np.int64)
        self.peak_at = np.zeros(n_positions, np.int64)
        self._unplaced = 1 << n_positions
        self._positions: dict[int, tuple] = {}  # bitmask -> the positions it counts for
        self._masks: dict[tuple, int] = {}  # (served positions, lanes) -> bitmask
        self._counts: dict[tuple, tuple] = {}  # (bitmask, lanes) -> (position, copies) pairs
        self._vecs: dict[tuple, tuple] = {}  # (bitmask, lanes) -> (positions, copies) arrays

    def positions(self, mask: int) -> tuple:
        ps = self._positions.get(mask)
        if ps is None:
            ps = tuple(p for p in range(self.n) if mask >> p & 1)
            if mask & self._unplaced and 0 not in ps:
                ps = (0, *ps)
            self._positions[mask] = ps
        return ps

    def counts(self, mask: int, bits: int) -> tuple[tuple, int]:
        """((position, copies it holds), ...) of a storage of first-copy
        positions ``mask`` and lanes ``bits``, and its copies in all."""
        key = (mask, bits)
        got = self._counts.get(key)
        if got is None:
            if not bits:
                got = (tuple((p, 1) for p in self.positions(mask)), 1)
            else:
                held: dict = {}
                copies = self.lanes.every_copy(bits)
                for c in copies:
                    for p in self.positions(self.lanes.moved(mask, bits, c)):
                        held[p] = held.get(p, 0) + 1
                got = (tuple(held.items()), len(copies))
            self._counts[key] = got
        return got

    def vec(self, mask: int, bits: int) -> tuple:
        """:meth:`counts` as (positions, copies) index arrays."""
        key = (mask, bits)
        got = self._vecs.get(key)
        if got is None:
            at = self.counts(mask, bits)[0]
            got = self._vecs[key] = (np.array([p for p, _ in at], np.int64),
                                     np.array([k for _, k in at], np.int64))
        return got

    def _sweep(self, cds=None) -> None:
        use = torch._C._storage_Use_Count
        seg = self.segment
        if cds is None:
            self.young = []
        for cd in [cd for cd in (self.held if cds is None else cds)
                   if cd in self.held and use(cd) <= 1]:
            entry = self.held.pop(cd, None)
            if entry is None:  # named twice
                continue
            nb, mask = entry[1], entry[2]
            at, n = self.counts(mask, entry[4])
            self.upper -= nb * n
            idx, ks = self.vec(mask, entry[4])
            self.upper_at[idx] -= nb * ks
            if seg is not None:
                seg.freed(cd, nb, at, n)

    def _add(self, cd: int, s, nb: int, mask: int, bits: int = 0) -> None:
        seg = self.segment
        counted = bits
        if seg is not None:
            if seg.would_raise(nb, mask):  # its own frees, exactly, before a new most
                self._sweep(list(seg.made) + list(seg.once))
            if bits:
                counted = 0  # the first run's copy; the others when the segment ends
        at, n = self.counts(mask, counted)
        idx, ks = self.vec(mask, counted)
        up = self.upper_at[idx] + nb * ks
        if self.upper + nb * n > self.peak or (up > self.peak_at[idx]).any():
            # most storages die young: their frees first, then, where a most could still
            # rise, every storage's, so a most is only ever taken of exact totals
            self._sweep(self.young)
            self.young = []
            up = self.upper_at[idx] + nb * ks
            if self.upper + nb * n > self.peak or (up > self.peak_at[idx]).any():
                self._sweep()
                up = self.upper_at[idx] + nb * ks
        self.held[cd] = [s, nb, mask, bits, counted]
        self.young.append(cd)
        self.upper += nb * n
        self.peak = max(self.peak, self.upper)
        self.upper_at[idx] = up
        self.peak_at[idx] = np.maximum(self.peak_at[idx], up)
        if seg is not None:
            seg.made_now(cd, nb, mask, bits, at)

    def begin_segment(self) -> bool:
        """Start counting a segment (``lanes.Lanes.segment``): work
        the full emulation runs once a lane, the lanes one after the other;
        False where one runs already."""
        if self.segment is not None:
            return False
        self.segment = _Segment(self)
        return True

    def end_segment(self) -> None:
        """End the running segment: its other lanes' runs, each the first's
        moved to its lane, after the first (``_Segment.close``)."""
        self.segment.close()
        self.segment = None

    def _widen(self, entry: list, mask: int) -> None:
        """An argument's storage held by more positions: count it for them."""
        _, nb, old, bits, counted = entry
        bits = counted
        before = dict(self.counts(old, bits)[0])
        entry[2] |= mask
        for p, k in sorted(self.counts(entry[2], bits)[0]):
            if k > before.get(p, 0):
                self.upper_at[p] += nb * (k - before.get(p, 0))
                self.peak_at[p] = max(self.peak_at[p], self.upper_at[p])

    def _mask(self, args, func=None, bits: int = 0) -> int:
        """The positions a storage an op ``func`` of lanes ``bits`` makes
        now counts for (its first copy's)."""
        if self.n == 1:
            return 1
        at = col.served()
        if at is not None:
            mask = self._masks.get((at, bits))
            if mask is None:
                mask = sum(1 << p for p in at)
                if bits:
                    mask = self.lanes.first_copy(mask, bits)
                self._masks[at, bits] = mask
            return mask
        inter, union = (1 << self.n) - 1, 0
        for t in _flat_tensors(args):
            e = self.held.get(t.untyped_storage()._cdata) if t.layout == torch.strided else None
            if e is None or e[2] == self._unplaced:
                continue
            m = e[2]
            if e[3]:
                m = self._read_mask(t, m, e[3], bits)
            inter &= m
            union |= m
        if not union:  # no input of a position's: the lead's
            return self._unplaced
        if func in _SUMS:  # a sum of positions' terms (autograd adding a gradient's): all of them
            return union
        return inter or union

    def _read_mask(self, t, mask: int, stored: int, bits: int) -> int:
        """The positions of the copies of a storage (first-copy ``mask``,
        lanes ``stored``) that an op of lanes ``bits`` reads through ``t``
        in its first copy: along lanes a view of one copy names, that
        copy's; along the op's own lanes, the first; along lanes the op
        does not keep, every copy's."""
        copy = getattr(t, COPY_ATTR, None)
        one = 0
        if copy is not None:
            one = copy[0]
            mask = self.lanes.moved(mask, *copy)
        every = stored & ~bits & ~one
        return self.lanes.spread_read(mask, every) if every else mask

    def _lane(self, args) -> tuple[int, int]:
        """(lanes, copies) of an op under the shortcut: the running call's
        or combine's; else its inputs'; for a factory in the backward of a
        custom autograd function, that function's saved tensors' (its
        other ops read them or its gradients)."""
        ln = col.lane()
        if ln is not None:
            return ln
        ins = list(_flat_tensors(args))
        if ins:
            bits = self.lanes.of(ins)
        else:
            node = torch._C._current_autograd_node()
            bits = 0
            if node is not None and hasattr(node, "saved_tensors"):
                bits = getattr(node, LANE_ATTR, None)
                if bits is None:
                    bits = self.lanes.of(list(node.saved_tensors))
                    setattr(node, LANE_ATTR, bits)
        return bits, self.lanes.weight(bits)

    def hold(self, x, mask: int | None = None) -> None:
        """Count the storages of ``x`` from now, for the positions of
        ``mask`` (default: those of an op's output made now), each as the
        copies of its lanes under the shortcut."""
        for t in _storages(x):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            cd = s._cdata
            bits = 0 if self.lanes is None else self.lanes.of(t)
            m = self._mask(()) if mask is None else mask
            if bits:
                m = self.lanes.first_copy(m, bits)
            if cd in self.held:
                if m & ~self.held[cd][2]:
                    self._widen(self.held[cd], m)
                continue
            self._add(cd, s, s.nbytes(), m, bits)

    def hold_args(self, args) -> None:
        """Count a program's arguments: a ``Sharded`` part (or an engine's
        per-position forest shard) for the positions that hold it, anything
        else for the lead."""
        placed: dict = {}
        for t, p in _placed_tensors(args, self.n):
            if t.layout != torch.strided:
                continue
            got = placed.setdefault(t.untyped_storage()._cdata, [t, 0])
            got[1] |= self._unplaced if p is None else 1 << p
        for t, mask in placed.values():
            self.hold(t, mask)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_on_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        bits, w = 0, 1
        if self.lanes is not None:
            bits, w = self._lane(args)
            for t in _storages(out):
                setattr(t, LANE_ATTR, bits)
        mask = None
        for t in _storages(out):
            if t.layout != torch.strided:
                continue
            s = t.untyped_storage()
            cd = s._cdata
            if cd not in self.held:
                if mask is None:
                    mask = self._mask(args, func, bits)
                self._add(cd, s, s.nbytes(), mask, bits)
            elif func in _SUMS and self.n > 1 and col.served() is None:
                # summed in place outside a position (autograd adding a gradient's terms in its
                # first term's buffer): it now holds every term's positions
                mask = self._mask(args, func, bits)
                if mask & ~self.held[cd][2] and mask != self._unplaced:
                    self._widen(self.held[cd], mask)
        if self.cost is not None:
            from repro_torch.launch import flopcount

            flopcount.tally(self.cost, func, args, kwargs, out, w)
        return out


class _Segment:
    """A segment of a shortcut dry run (:meth:`LiveBytes.begin_segment`): a
    per-position call over every position, or a combine, which the full
    emulation runs once a lane, the lanes one after the other in position
    order, and the shortcut once.

    While it runs, a storage it makes of some lanes counts the first copy
    only (the first lane's run), and the run's trajectory is
    kept by position: of the copies that move with their lane
    (``moving``), and of those of no position's, counted for the lead in
    every lane's run (``lead``).  When it ends, each further lane's run is
    the first's moved to its lane, after the runs before it left their
    survivors: the peaks of those runs are taken, and the survivors count
    every copy.  A storage of no lanes made in it belongs to the first
    run; it frees nothing made before it (a call frees none of its inputs),
    so a storage made before it and found dead during it was dead before."""

    def __init__(self, live):
        self.live = live
        self.bits = 0
        self.base = live.upper
        self.base_at = live.upper_at.tolist()
        self.made: dict[int, tuple] = {}  # cd -> (nbytes, moving positions, of the lead)
        self.once: dict[int, tuple] = {}  # cd -> (nbytes, counts) of a storage of no lanes
        self.stale = 0  # bytes of storages made before it and found dead during it
        self.stale_at: dict[int, int] = {}
        self.now = 0  # the first run's bytes of its lane storages, and their most
        self.top = 0
        self.moving: dict[int, int] = {}  # position -> its moving bytes now
        self.lead = 0  # the lead's bytes of storages of no position's, now and their most
        self.lead_top = 0
        self.top_at: dict[int, int] = {}  # position -> the most of its moving bytes
        # the positions a lane moves to the lead's (the lead's class), and the most of each
        # one's moving bytes and the lead's
        self.lead_class = live.lanes.class_of(0)
        self.joint: dict[int, int] = {}

    def _split(self, mask: int) -> tuple:
        live = self.live
        moving = live.positions(mask & ~live._unplaced) if mask & ~live._unplaced else ()
        return moving, bool(mask & live._unplaced) and not mask & 1

    def would_raise(self, nb: int, mask: int) -> bool:
        """Whether ``nb`` bytes made now at first-copy positions ``mask``
        could raise one of the first run's mosts."""
        moving, lead = self._split(mask)
        return (self.now + nb > self.top or (lead and self.lead + nb > self.lead_top)
                or any(self.moving.get(q, 0) + nb > self.top_at.get(q, 0) for q in moving))

    def _step(self, nb: int, moving, lead: bool) -> None:
        """The first run's lane bytes change by ``nb`` at ``moving`` (and at
        the lead for a storage of no position's)."""
        self.now += nb
        self.top = max(self.top, self.now)
        if lead:
            self.lead += nb
            self.lead_top = max(self.lead_top, self.lead)
            for q in self.lead_class:
                if q in self.moving:
                    self.joint[q] = max(self.joint.get(q, 0), self.moving[q] + self.lead)
        for q in moving:
            b = self.moving[q] = self.moving.get(q, 0) + nb
            self.top_at[q] = max(self.top_at.get(q, 0), b)
            if q in self.lead_class:
                self.joint[q] = max(self.joint.get(q, 0), b + self.lead)

    def made_now(self, cd: int, nb: int, mask: int, bits: int, at) -> None:
        if not bits:
            self.once[cd] = (nb, at)
            return
        self.bits |= bits
        moving, lead = self._split(mask)
        self.made[cd] = (nb, moving, lead)
        self._step(nb, moving, lead)

    def freed(self, cd: int, nb: int, at, n: int) -> None:
        if cd in self.made:
            nb, moving, lead = self.made.pop(cd)
            self._step(-nb, moving, lead)  # a free raises no most
        elif cd in self.once:
            del self.once[cd]
        else:
            self.stale += nb * n
            for p, k in at:
                self.stale_at[p] = self.stale_at.get(p, 0) + nb * k

    def close(self) -> None:
        live = self.live
        live._sweep(list(self.made) + list(self.once))
        if not self.made:
            return
        n = len(live.lanes.every_copy(self.bits))
        keep = sum(nb for nb, _ in self.once.values())
        keep_at: dict[int, int] = {}
        for nb, at in self.once.values():
            for p, k in at:
                keep_at[p] = keep_at.get(p, 0) + nb * k
        kept = sum(nb for nb, _, _ in self.made.values())  # what a lane's run leaves
        kept_at: dict[int, int] = {}
        kept_lead = 0
        for nb, moving, lead in self.made.values():
            kept_lead += nb if lead else 0
            for q in moving:
                kept_at[q] = kept_at.get(q, 0) + nb
        # the last run: the base, the first run's storages of no lanes, the runs before, a
        # run's most
        want = self.base + keep + (n - 1) * kept + self.top
        if want > live.peak:
            live._sweep()  # the base exactly: less what was found dead
            live.peak = max(live.peak, want - self.stale)
        self._runs_by_position(n, keep_at, kept_at, kept_lead)
        for cd in self.made:  # the survivors count every copy from now on
            e = live.held[cd]
            nb, mask, bits = e[1], e[2], e[3]
            first = dict(live.counts(mask, 0)[0])
            at, m = live.counts(mask, bits)
            live.upper += nb * (m - 1)
            for p, k in at:
                live.upper_at[p] += nb * (k - first.get(p, 0))
            e[4] = bits

    def _runs_by_position(self, n: int, keep_at: dict, kept_at: dict, kept_lead: int) -> None:
        """Each position's peak in each further run: its moving copies are
        the first run's at the position they move from, the lead's storages
        of no position's are every run's."""
        live = self.live
        moves = live.lanes.position_moves(self.bits)
        pairs: dict[int, dict] = {}  # position -> {run: the first run's position it repeats}
        for k in range(n):
            for q in set(self.top_at) | set(kept_at):
                pairs.setdefault(moves[k][q], {})[k] = q
        lead = bool(self.lead_top or kept_lead)
        if lead:
            pairs.setdefault(0, {})
        exact = False
        for p, by_run in pairs.items():
            every = lead and p == 0
            before = 0
            best = None
            for k in range(n) if every else sorted(by_run):
                q = by_run.get(k)
                if k:
                    if every:
                        top = self.joint.get(q, self.lead_top) if q is not None else self.lead_top
                    else:
                        top = self.top_at.get(q, 0)
                    best = before + top if best is None else max(best, before + top)
                before += kept_at.get(q, 0) + (kept_lead if every else 0)
            if best is None:
                continue
            want = self.base_at[p] + keep_at.get(p, 0) + best
            if want > live.peak_at[p]:
                if not exact:
                    live._sweep()
                    exact = True
                live.peak_at[p] = max(live.peak_at[p], want - self.stale_at.get(p, 0))


_POINTWISE: dict = {}
_SUMS = (torch.ops.aten.add.Tensor, torch.ops.aten.add_.Tensor)


def _pointwise_on_meta(func, args, kwargs):
    """A pointwise op on ``meta`` tensors, made without aten's meta kernel
    (a Python reference for most pointwise ops, ~250 us a call): the
    broadcast shape, the dtype the op gives on one-element CPU tensors of
    the same dtypes and ranks, contiguous.  None where that does not apply
    (other ops, ``out=``, several outputs, other devices)."""
    fast = _POINTWISE.get(func)
    if fast is None:
        fast = _POINTWISE[func] = (torch.Tag.pointwise in func.tags
                                   and len(func._schema.returns) == 1)
    if not fast or "out" in kwargs:
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "meta" for t in tensors):
        return None
    if func._schema.name.endswith("_") or func._schema.returns[0].alias_info is not None:
        return args[0]  # in place: the first argument, its shape and dtype

    key = (func, tuple((a.dtype, a.dim() > 0) if isinstance(a, torch.Tensor) else type(a)
                       for a in args), tuple((k, type(v)) for k, v in kwargs.items()))
    dtype = _DTYPES.get(key)
    if dtype is None:
        def probe(a):
            if isinstance(a, torch.Tensor):
                return torch.zeros((1,) * a.dim(), dtype=a.dtype)
            return a

        with torch.utils._python_dispatch._disable_current_modes():
            dtype = _DTYPES[key] = func(*(probe(a) for a in args), **kwargs).dtype
    return torch.empty(_broadcast(t.shape for t in tensors), dtype=dtype, device="meta")


_DTYPES: dict = {}


def _broadcast(shapes) -> list[int]:
    out: list[int] = []
    for shape in shapes:
        shape = list(shape)
        if len(shape) > len(out):
            out = [1] * (len(shape) - len(out)) + out
        off = len(out) - len(shape)
        for i, n in enumerate(shape):
            m = out[off + i]
            if m == 1:
                out[off + i] = n
            elif n != 1 and n != m:
                raise RuntimeError(f"shapes do not broadcast: {m} against {n}")
    return out


def mesh_axes(shape) -> tuple[str, ...]:
    """The axes of a dry-run mesh of ``shape``: ("data", "model"), or
    ("pod", "data", "model") for three numbers."""
    if len(shape) == 3:
        return ("pod", "data", "model")
    if len(shape) == 2:
        return ("data", "model")
    raise ValueError(f"a dry-run mesh has two or three axes, not {tuple(shape)}")


def meta_mesh(shape):
    """A (data, model) or (pod, data, model) mesh of ``shape`` over the
    ``meta`` device."""
    from repro_torch.core.query import meta_devices
    from repro_torch.launch import mesh as meshlib

    with meta_devices():
        return meshlib.make_mesh(tuple(shape), mesh_axes(shape),
                                 ["meta"] * int(torch.tensor(shape).prod()))


def program_args(program, mesh, lanes=None) -> tuple:
    """A program's arguments at its ``in_specs`` (``meta`` tensors): on a
    mesh of several positions laid out as the program lays them out, each
    distinct ``Sharded`` part (an engine's forest shard) a storage of its
    own, as on distinct cards; on one position as they are.  With
    ``lanes`` (the shortcut's ``lanes.Lanes``) the positions of a
    class (equal but for their data-parallel coordinates) share their
    first member's part where every member's is of its shape, tagged with
    the data-parallel axes it is split over."""
    from repro_torch.launch import programs

    if program.meta is not None:
        from repro_torch.core import engine as eng

        fspec, *rest = program.in_specs
        shards = eng.shard_forest(fspec, mesh)
        if len(mesh.devices) > 1:
            own = {id(f): dataclasses.replace(f, **{k.name: getattr(f, k.name).clone()
                                                    for k in dataclasses.fields(f) if k.init})
                   for f in shards}
            shards = tuple(own[id(f)] for f in shards)
        return (shards, *rest)
    args = tuple(program.in_specs)
    if program.mesh is None or len(program.mesh.devices) == 1:
        return args
    return _own_parts(programs.place(program, args), lanes)


def _own_parts(x, lanes=None):
    """``x`` with each distinct part of every ``Sharded`` value cloned (a
    class's shared under ``lanes``)."""
    if isinstance(x, shd.Sharded):
        if lanes is None:
            return shd.map_distinct(torch.clone, x)
        return _lane_parts(x, lanes)
    if isinstance(x, dict):
        return {k: _own_parts(v, lanes) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_own_parts(v, lanes) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_own_parts(v, lanes) for v in x)
    return x


def _lane_parts(s, lanes):
    """``s`` with every position of a class holding its first member's
    part (a clone of it, tagged with the data-parallel axes ``s`` is split
    over), where the class's parts are all of one shape; each other
    distinct part cloned as without the shortcut."""
    mesh = s.mesh
    first: dict = {}
    for p in range(len(mesh.devices)):
        first.setdefault(lanes.at[p]["model"], p)
    rep = [first[lanes.at[p]["model"]] for p in range(len(mesh.devices))]
    alike = {r: all(s.parts[p].shape == s.parts[r].shape for p in range(len(rep)) if rep[p] == r)
             for r in first.values()}
    bits = lanes.axes_bits(a for e in s.spec for a in shd.axes_of(e))
    parts = tuple(s.parts[rep[p]] if alike[rep[p]] else s.parts[p] for p in range(len(rep)))
    made = {}
    for p, t in enumerate(parts):
        if id(t) not in made:
            made[id(t)] = t.clone()
            if alike[rep[p]]:
                setattr(made[id(t)], LANE_ATTR, bits)
    return shd.Sharded(tuple(made[id(t)] for t in parts), mesh, s.spec)


def measure(fn, args, mesh=None, lanes=None) -> dict:
    """Run ``fn(*args)`` once on ``meta`` tensors under the counters: the
    ``flopcount.Cost``, the collectives' wire bytes by kind (summed over
    positions) and the live bytes, the arguments included: ``mesh_peak``
    the whole run's (every storage once), and with ``mesh`` (its positions
    counted apart) ``peak_at`` / ``arg_at`` / ``out_at`` each position's
    peak, argument and output bytes, ``peak`` / ``arg_bytes`` /
    ``out_bytes`` those of the position with the largest peak (the first
    such).  Without ``mesh`` every storage counts for one position.  With
    ``lanes`` (``lanes.Lanes`` of ``mesh``; ``args`` from
    :func:`program_args` with them) it runs the shortcut: each class of
    positions once, counted for every member."""
    from repro_torch.core.query import meta_devices
    from repro_torch.launch import flopcount

    cost = flopcount.Cost()
    live = LiveBytes(cost, len(mesh.devices) if mesh is not None else 1, lanes)
    col.reset_wire()
    if lanes is not None:
        lanes.live = live
    with meta_devices(), flopcount.collecting(cost), live, lanes or contextlib.nullcontext():
        live.hold_args(args)
        out = fn(*args)
        arg = {cd: live.held[cd][2] for cd in _by_storage(args) if cd in live.held}
        outs = {cd: live.held[cd][2] for cd in _by_storage(out)
                if cd in live.held and cd not in arg}
    n = live.n

    def at(masks: dict) -> list[int]:
        tot = [0] * n
        for cd, mask in masks.items():
            for p, k in live.counts(mask, live.held[cd][3])[0]:
                tot[p] += live.held[cd][1] * k
        return tot

    arg_at, out_at = at(arg), at(outs)
    peak_at = live.peak_at.tolist()
    top = max(range(n), key=lambda p: (peak_at[p], -p))
    return dict(cost=cost, wire=col.wire_bytes(), links=col.link_bytes(), mesh_peak=live.peak,
                peak_at=peak_at, arg_at=arg_at, out_at=out_at, peak=peak_at[top],
                arg_bytes=arg_at[top], out_bytes=out_at[top])


def _by_storage(x) -> dict[int, int]:
    """{storage: bytes} of the tensors in ``x``, each storage once."""
    out = {}
    for t in _storages(x):
        if t.layout == torch.strided:
            s = t.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def storage_bytes(x) -> int:
    """Bytes of the distinct storages the tensors of ``x`` lie in."""
    return sum(_by_storage(x).values())


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


def rules_name(rules: dict | None) -> str:
    """``rules`` as a file-name part: ``seq_sp-none`` for {"seq_sp": None}."""
    return "__".join(f"{k}-{'-'.join(v) if isinstance(v, (list, tuple)) else str(v).lower()}"
                     for k, v in sorted((rules or {}).items()))


def run_cell(arch_id: str, shape_id: str, mesh_shape, out_dir: str, force: bool = False,
             verbose: bool = True, smoke: bool = False, rules: dict | None = None,
             shortcut: bool | None = None) -> dict:
    """Dry-run one cell (``rules`` amend an LM program's sharding rules)
    and write its record to ``out_dir``; a record already there is read
    back unless ``force``.  ``shortcut`` runs each class of positions once
    (``lanes.Lanes``); the default takes it on a mesh of more than
    one node (``roofline.NODE_CARDS`` positions)."""
    from repro_torch.launch import programs, roofline

    name = mesh_name(mesh_shape)
    key = (f"{arch_id}__{shape_id}__{name}" + ("__smoke" if smoke else "")
           + (f"__{rules_name(rules)}" if rules else ""))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, key + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    t0 = time.time()
    rec = {"arch": arch_id, "shape": shape_id, "mesh": name, "smoke": smoke, "ok": False}
    if rules:
        rec["rules"] = rules
    try:
        mesh = meta_mesh(mesh_shape)
        if shortcut is None:
            shortcut = len(mesh.devices) > roofline.NODE_CARDS
        lanes = Lanes(mesh) if shortcut else None
        prog = programs.build(arch_id, shape_id, mesh, smoke=smoke, rules=rules)
        t_build = time.time() - t0
        got = measure(prog.fn, program_args(prog, mesh, lanes), mesh, lanes)
        chips = len(mesh.devices)
        r = roofline.analyze(prog.name, name, chips, got["cost"], got["wire"], prog.model_flops,
                             peak_mem_bytes=got["peak"], links=got["links"])
        rec.update(r.to_dict())
        rec.update(ok=True, t_build_s=round(t_build, 2), t_run_s=round(time.time() - t0 - t_build, 2),
                   flops=got["cost"].flops, bytes_naive=got["cost"].bytes_naive,
                   flops_bf16=got["cost"].flops_bf16, flops_f32=got["cost"].flops_f32,
                   flops_other=got["cost"].flops_other, wire_bytes=got["wire"],
                   arg_bytes=got["arg_bytes"], out_bytes=got["out_bytes"],
                   temp_bytes=max(got["peak"] - got["arg_bytes"], 0),
                   mesh_peak_mem_bytes=got["mesh_peak"])
        if verbose:
            print(roofline.fmt_row(r), f"[run {rec['t_run_s']:.1f}s]", flush=True)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"FAIL {key}: {rec['error']}", flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def parse_rule(text: str) -> tuple[str, object]:
    """``NAME=AXIS[,AXIS...]`` or ``NAME=none`` -> (name, rule value)."""
    name, _, value = text.partition("=")
    axes = tuple(a for a in value.split(",") if a)
    if not name or not axes:
        raise ValueError(f"a rule is NAME=AXIS[,AXIS...] or NAME=none, not {text!r}")
    rule = None if axes == ("none",) else axes[0] if len(axes) == 1 else axes
    return name, rule


def parse_mesh(text: str) -> tuple[int, ...]:
    """``DATAxMODEL`` or ``PODxDATAxMODEL`` -> the mesh shape."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    mesh_axes(shape)
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", action="append", type=parse_mesh, metavar="[PODx]DATAxMODEL",
                    help="a (data, model) or (pod, data, model) mesh of meta devices, e.g. 1x1 "
                         "(one card), 2x4 (one 8-card node), 32x8 or 2x16x8 (256 cards); "
                         "repeatable (default: 1x1 and 2x4)")
    ap.add_argument("--production", action="store_true",
                    help="the two production meshes, 32x8 and 2x16x8 "
                         "(launch.mesh.make_production_mesh), beside any --mesh")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configs")
    ap.add_argument("--rule", action="append", type=parse_rule, default=[],
                    metavar="NAME=AXES", help="amend the LM programs' sharding rules, e.g. "
                    "seq_sp=none (the residual stream whole); repeatable")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--shortcut", choices=("on", "off"),
                    help="run each class of positions once (on) or every position (off); "
                         "default: on for a mesh of more than one node")
    args = ap.parse_args(argv)

    from repro_torch.launch import programs

    from repro_torch.launch import mesh as meshlib

    meshes = list(args.mesh or ())
    if args.production:
        meshes += [shape for shape, _ in meshlib.PRODUCTION_SHAPES.values()]
    meshes = meshes or list(DEFAULT_MESHES)
    if args.all:
        cells = list(programs.all_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --all or both --arch and --shape")
    rules = dict(args.rule) or None
    shortcut = None if args.shortcut is None else args.shortcut == "on"
    if rules:
        cells = [(a, s) for a, s in cells if programs.cb.get(a).family == "lm"]
    work = [(a, s, m) for a, s in cells for m in meshes]
    t0 = time.time()
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn")) as pool:
            recs = list(pool.map(_run_one, [(*w, args.out, args.force, args.smoke, rules,
                                             shortcut) for w in work]))
    else:
        recs = [run_cell(a, s, m, args.out, force=args.force, smoke=args.smoke, rules=rules,
                         shortcut=shortcut) for a, s, m in work]
    n_ok = sum(bool(r.get("ok")) for r in recs)
    n_fail = len(recs) - n_ok
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed in {time.time() - t0:.1f}s")
    return 1 if n_fail else 0


def _run_one(job) -> dict:
    arch_id, shape_id, mesh_shape, out, force, smoke, rules, shortcut = job
    torch.set_num_threads(1)
    return run_cell(arch_id, shape_id, mesh_shape, out, force=force, smoke=smoke, rules=rules,
                    shortcut=shortcut)


if __name__ == "__main__":
    raise SystemExit(main())
