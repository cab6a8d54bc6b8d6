"""The paper's eight SPARQL triple patterns as functions of the forest.

Every function takes 1-based ids (the dictionary's space) and returns
1-based ids inside the fixed-shape ``QueryResult`` / ``PairResult``
contracts (ids, valid mask, count, overflow), on the forest's device.

Pattern -> primitive map (paper §k²-triples):

  (S, P, O)     cell check on the P-th tree            -> ``spo``
  (S, ?P, O)    cell check on every tree               -> ``s_any_o``
  (S, P, ?O)    row scan (direct neighbours), sorted   -> ``sp_any``
  (S, ?P, ?O)   row scan on every tree                 -> ``s_any_any``
  (?S, P, O)    column scan (reverse neighbours)       -> ``any_po``
  (?S, ?P, O)   column scan on every tree              -> ``any_any_o``
  (?S, P, ?O)   full range scan of one tree            -> ``any_p_any``
  (?S, ?P, ?O)  range scan on every tree (dump)        -> ``dump``

The three unbounded-``?P`` functions also take the SP/OP index
(``index=`` + ``pmeta=``, ``core.predindex``): the candidates are then
gathered from the index and only those trees are touched, and
``s_any_any`` / ``any_any_o`` return a ``PredScanResult`` whose axis 0 is
the candidate slot (``preds`` names each slot's predicate), ``s_any_o``
the matching predicates as a ``QueryResult``.  Without an index the
all-preds sweep runs, axis 0 = predicate, the paper's shapes.

Plans (``Engine.compile``) do not call these: they lower patterns to the
serve IR.  These are the per-primitive surface the benchmarks time.
"""

from __future__ import annotations

import torch

from repro_torch.core import k2forest, predindex
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, PairResult, QueryResult
from repro_torch.core.predindex import PredScanResult


def _ids(res: QueryResult) -> QueryResult:
    """0-based matrix coordinates back to 1-based dictionary ids."""
    return res._replace(ids=torch.where(res.valid, res.ids + 1, 0))


def _pairs(res: PairResult) -> PairResult:
    return res._replace(
        rows=torch.where(res.valid, res.rows + 1, 0),
        cols=torch.where(res.valid, res.cols + 1, 0),
    )


def _int(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def spo(meta: K2Meta, f: K2Forest, s, p, o) -> torch.Tensor:
    """(S, P, O) -> bool of the broadcast shape of ``s``, ``p``, ``o``."""
    s, p, o = torch.broadcast_tensors(*(_int(x, f.device) for x in (s, p, o)))
    hit = k2forest.check(meta, f, *(k2forest.as_lanes(x - 1, f.device) for x in (p, s, o)))
    return hit.reshape(s.shape)


def s_any_o(meta: K2Meta, f: K2Forest, s, o, *, index=None, pmeta=None,
            u_width: int | None = None):
    """(S, ?P, O) -> bool[P], slot i <-> predicate i + 1.

    With ``index``: only the subject's SP candidates are checked, and the
    matching predicate ids (1-based, ascending) come back as a
    ``QueryResult``.
    """
    s, o = _int(s, f.device), _int(o, f.device)
    if index is None:
        return k2forest.check_all_preds(meta, f, s - 1, o - 1)
    r = predindex.check_pruned_batch(
        meta, f, pmeta, index, (s - 1).reshape(1), (o - 1).reshape(1),
        u_width or max(pmeta.max_degree, 1),
    )
    return _ids(k2forest.first_lane(r))


def sp_any(meta: K2Meta, f: K2Forest, s, p, cap: int) -> QueryResult:
    """(S, P, ?O) -> object ids, ascending (merge-join ready)."""
    s, p = _int(s, f.device), _int(p, f.device)
    return _ids(k2forest.row_scan(meta, f, p - 1, s - 1, cap))


def _pruned_one(meta, f, pmeta, index, key, axis: int, cap: int,
                u_width: int | None) -> PredScanResult:
    """One pruned unbounded scan, shifted to 1-based ids."""
    r = k2forest.first_lane(predindex.scan_pruned_batch(
        meta, f, pmeta, index, key.reshape(1), axis, cap,
        u_width or max(pmeta.max_degree, 1),
    ))
    return r._replace(
        preds=torch.where(r.pvalid, r.preds + 1, 0),
        ids=torch.where(r.valid, r.ids + 1, 0),
    )


def s_any_any(meta: K2Meta, f: K2Forest, s, cap: int, *, index=None, pmeta=None,
              u_width: int | None = None):
    """(S, ?P, ?O) -> per-predicate object lists (axis 0 = predicate); with
    ``index``, axis 0 is the candidate slot of a ``PredScanResult``."""
    s = _int(s, f.device)
    if index is None:
        return _ids(k2forest.row_scan_all_preds(meta, f, s - 1, cap))
    return _pruned_one(meta, f, pmeta, index, s - 1, 0, cap, u_width)


def any_po(meta: K2Meta, f: K2Forest, p, o, cap: int) -> QueryResult:
    """(?S, P, O) -> subject ids, ascending."""
    p, o = _int(p, f.device), _int(o, f.device)
    return _ids(k2forest.col_scan(meta, f, p - 1, o - 1, cap))


def any_any_o(meta: K2Meta, f: K2Forest, o, cap: int, *, index=None, pmeta=None,
              u_width: int | None = None):
    """(?S, ?P, O) -> per-predicate subject lists; with ``index``, pruned
    to the object's OP candidates (see ``s_any_any``)."""
    o = _int(o, f.device)
    if index is None:
        return _ids(k2forest.col_scan_all_preds(meta, f, o - 1, cap))
    return _pruned_one(meta, f, pmeta, index, o - 1, 1, cap, u_width)


def any_p_any(meta: K2Meta, f: K2Forest, p, cap: int) -> PairResult:
    """(?S, P, ?O) -> every (subject, object) pair of predicate P."""
    return _pairs(k2forest.range_scan(meta, f, _int(p, f.device) - 1, cap))


def dump(meta: K2Meta, f: K2Forest, cap: int) -> PairResult:
    """(?S, ?P, ?O) -> every triple (axis 0 = predicate)."""
    return _pairs(k2forest.range_scan_all_preds(meta, f, cap))


# batched forms ---------------------------------------------------------------


def spo_batch(meta, f, s, p, o):
    return spo(meta, f, s, p, o)


def sp_any_batch(meta, f, s, p, cap: int) -> QueryResult:
    s, p = _int(s, f.device), _int(p, f.device)
    return _ids(k2forest.row_scan_batch(meta, f, p - 1, s - 1, cap))


def any_po_batch(meta, f, p, o, cap: int) -> QueryResult:
    p, o = _int(p, f.device), _int(o, f.device)
    return _ids(k2forest.col_scan_batch(meta, f, p - 1, o - 1, cap))
