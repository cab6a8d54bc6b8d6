"""Join categories D–F over triple patterns (paper §k²-triples, Fig. 4).

A join query is two triple patterns sharing one variable ?X in the subject
or object position of each (SS / OO / SO joins).  In categories D–F
pattern 2 carries a second, unbounded variable ?Y:

  D — bound predicates                     -> resolve X, re-bind into pattern 2
  E — D with the pattern-2 predicate free  -> D per predicate
  F — D with both predicates free          -> union X over predicates, then E

Categories A–C bind both non-join positions:

  A — both predicates bound                -> list ∩ list
  B — pattern 2's predicate free           -> list ∩ each of P lists
  C — both predicates free                 -> union ∩ union

``join_a`` / ``join_b`` / ``join_c`` compute them here over scan launches
and ``core.sortedset``; join plans (``Engine.compile(JoinQ)``) resolve
them as serve-IR side lists with the same set algebra.

Inputs are 1-based ids; outputs are fixed-capacity ``JoinPairs`` with
validity masks.  ``vpos`` ∈ {"s","o"} names the position of the join
variable in a pattern.  D and E run the fused ``k2_scan_rebind`` kernel
(the X list never leaves the device); F re-binds its unioned X list with
one flat ``k2_scan`` launch.

Overflow is per predicate for E/F (``JoinPairs.overflow[P]``).  Re-bind
overflow is masked by the X slot's validity, so a dead slot's key-0 scan
cannot latch a phantom overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import k2forest, sortedset
from repro_torch.core.sortedset import SENTINEL


class JoinPairs(NamedTuple):
    """(X, Y) bindings: Y lists hang off each X slot."""

    x_ids: torch.Tensor  # int32[..., cap_x]
    x_valid: torch.Tensor  # bool[..., cap_x]
    y_ids: torch.Tensor  # int32[..., cap_x, cap_y]
    y_valid: torch.Tensor  # bool[..., cap_x, cap_y]
    overflow: torch.Tensor  # bool[] (D) or bool[P] (E/F: per predicate)


def _axis(vpos: str) -> int:
    """Scan axis that lists the join variable: ?X in subject position is a
    column scan (reverse neighbours), in object position a row scan."""
    return 1 if vpos == "s" else 0


def _side_list(meta, f, p, const, vpos: str, cap: int) -> sortedset.IdSet:
    """Sorted candidate values of the join variable for one bound pattern,
    1-based: (?X, P, O) is a column scan, (S, P, ?X) a row scan."""
    scan = k2forest.col_scan if vpos == "s" else k2forest.row_scan
    r = scan(meta, f, torch.as_tensor(p) - 1, torch.as_tensor(const) - 1, cap)
    return sortedset.from_result(
        torch.where(r.valid, r.ids + 1, SENTINEL), r.valid, r.count, r.overflow
    )


def _side_list_all_preds(meta, f, const, vpos: str, cap: int):
    """-> (ids[P, cap], valid[P, cap], overflow[P]), sorted within each pred:
    one scan launch over every tree with a broadcast key."""
    P = f.n_preds
    d = f.device
    r = k2forest.scan_batch_mixed(
        meta, f, torch.arange(P, dtype=torch.int32, device=d),
        k2forest.as_lanes(const - 1, d, P),
        torch.full((P,), _axis(vpos), dtype=torch.int32, device=d), cap,
    )
    return torch.where(r.valid, r.ids + 1, SENTINEL), r.valid, r.overflow


class PerPredSets(NamedTuple):
    ids: torch.Tensor  # int32[P, cap]
    valid: torch.Tensor  # bool[P, cap]
    preds: torch.Tensor  # int32[P] 1-based predicate ids
    counts: torch.Tensor  # int32[P] per-predicate result counts
    overflow: torch.Tensor  # bool[P] per-predicate truncation flags


def join_a(meta, f, p1, c1, vpos1: str, p2, c2, vpos2: str, cap: int) -> sortedset.IdSet:
    """Two bound patterns: intersect their side lists."""
    a = _side_list(meta, f, p1, c1, vpos1, cap)
    b = _side_list(meta, f, p2, c2, vpos2, cap)
    return sortedset.intersect(a, b)


def join_b(meta, f, p1, c1, vpos1: str, c2, vpos2: str, cap: int) -> PerPredSets:
    """Pattern 2's predicate free: the bound side list ∩ each predicate's."""
    a = _side_list(meta, f, p1, c1, vpos1, cap)
    ids2, valid2, ovf2 = _side_list_all_preds(meta, f, c2, vpos2, cap)
    P = f.n_preds
    b = sortedset.IdSet(ids2, valid2, valid2.sum(dim=-1, dtype=torch.int32),
                        torch.zeros(P, dtype=torch.bool, device=f.device))
    r = sortedset.intersect(a, b)
    return PerPredSets(
        r.ids, r.valid, torch.arange(1, P + 1, dtype=torch.int32, device=f.device),
        r.valid.sum(dim=-1, dtype=torch.int32), a.overflow | ovf2,
    )


def join_c(meta, f, c1, vpos1: str, c2, vpos2: str, cap: int) -> sortedset.IdSet:
    """Both predicates free: the union of each side over predicates, then
    the intersection of the unions."""
    ids1, valid1, ovf1 = _side_list_all_preds(meta, f, c1, vpos1, cap)
    ids2, valid2, ovf2 = _side_list_all_preds(meta, f, c2, vpos2, cap)
    u1 = sortedset.union_rows(ids1, valid1, cap, ovf1.any())
    u2 = sortedset.union_rows(ids2, valid2, cap, ovf2.any())
    return sortedset.intersect(u1, u2)


def _wrap_rebind(x_valid, y_ids, y_valid, y_ovf):
    """Shift re-bind output to 1-based ids and mask it by X validity."""
    ids = torch.where(y_valid, y_ids + 1, SENTINEL)
    valid = y_valid & x_valid[..., None]
    ovf = (y_ovf & x_valid).any(dim=-1)
    return ids, valid, ovf


def _rebind(meta, f, preds1, c1, vpos1, preds2, vpos2, cap_x, cap_y):
    q = preds1.shape[0]
    dev = f.device
    x_ids, x_valid, _, x_ovf, y_ids, y_valid, _, y_ovf = k2forest.scan_rebind_batch(
        meta, f, preds1, k2forest.as_lanes(c1 - 1, dev, q),
        torch.full((q,), _axis(vpos1), dtype=torch.int32, device=dev),
        preds2, torch.full((q,), 1 - _axis(vpos2), dtype=torch.int32, device=dev),
        cap_x, cap_y,
    )
    xi = torch.where(x_valid, x_ids + 1, SENTINEL)
    yi, yv, yo = _wrap_rebind(x_valid, y_ids, y_valid, y_ovf)
    return JoinPairs(xi, x_valid, yi, yv, x_ovf | yo)


def join_d(meta, f, p1, c1, vpos1: str, p2, vpos2: str,
           cap_x: int, cap_y: int) -> JoinPairs:
    """Resolve the X list of pattern 1, re-bind each X into pattern 2.

    ``vpos2`` names the position of **?X** in pattern 2; ?Y takes the
    other one.  One fused scan -> re-bind launch.
    """
    d = f.device
    r = _rebind(meta, f, k2forest.as_lanes(p1 - 1, d, 1), c1, vpos1,
                k2forest.as_lanes(p2 - 1, d, 1), vpos2, cap_x, cap_y)
    return k2forest.first_lane(r)


def join_e(meta, f, p1, c1, vpos1: str, vpos2: str,
           cap_x: int, cap_y: int) -> JoinPairs:
    """D with the pattern-2 predicate unbounded: one fused launch with P
    query lanes; lane p re-resolves X and re-binds it into tree p."""
    P = f.n_preds
    d = f.device
    return _rebind(meta, f, k2forest.as_lanes(p1 - 1, d, P), c1, vpos1,
                   torch.arange(P, dtype=torch.int32, device=d), vpos2,
                   cap_x, cap_y)


def join_f(meta, f, c1, vpos1: str, vpos2: str,
           cap_x: int, cap_y: int) -> JoinPairs:
    """Both predicates unbounded: union X over predicates, then re-bind the
    union into every tree with one flat (P·cap_x)-lane scan."""
    ids1, valid1, ovf1 = _side_list_all_preds(meta, f, c1, vpos1, cap_x)
    u = sortedset.union_rows(ids1, valid1, cap_x, ovf1.any())
    xs = torch.where(u.valid, u.ids, 1)  # invalid slots scan a safe id
    P = f.n_preds
    d = f.device
    preds = torch.repeat_interleave(torch.arange(P, dtype=torch.int32, device=d), cap_x)
    keys = (xs - 1).repeat(P)
    axes = torch.full((P * cap_x,), 1 - _axis(vpos2), dtype=torch.int32, device=d)
    r = k2forest.scan_batch_mixed(meta, f, preds, keys, axes, cap_y)
    yi, yv, yo = _wrap_rebind(
        u.valid[None, :], r.ids.reshape(P, cap_x, cap_y),
        r.valid.reshape(P, cap_x, cap_y), r.overflow.reshape(P, cap_x),
    )
    return JoinPairs(
        u.ids.expand(P, cap_x), u.valid.expand(P, cap_x), yi, yv, u.overflow | yo
    )
