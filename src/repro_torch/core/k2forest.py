"""K2Forest — the vertical-partitioning arena: one k²-tree per predicate.

The |P| trees are packed into padded 2-D word arenas ``(P, W)`` so that a
batch of queries with per-query predicate ids lowers to gathers
``words[pred, pos >> 5]``.  All trees share one ``K2Meta`` (the matrix side
is the dictionary extent, padded to the hybrid-k power).

The batched queries route by device: a CUDA tensor goes to the hand-written
kernels in ``kernels/csrc``, a CPU tensor to their plain torch versions in
``kernels/ref.py`` (see ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import bitvec, k2tree
from repro_torch.core.k2tree import K2Meta, PairResult, QueryResult


@dataclasses.dataclass(frozen=True)
class K2Forest:
    """Device arenas; words are int32 tensors carrying uint32 bits."""

    t_words: torch.Tensor  # int32[P, Wt]
    t_rank: torch.Tensor  # int32[P, Wt]
    l_words: torch.Tensor  # int32[P, Wl]
    ones_before: torch.Tensor  # int32[P, max(H-1,1)]
    level_start: torch.Tensor  # int32[P, H]
    nnz: torch.Tensor  # int32[P]

    @property
    def n_preds(self) -> int:
        return self.t_words.shape[0]

    @property
    def device(self) -> torch.device:
        return self.t_words.device

    def to(self, device) -> "K2Forest":
        return K2Forest(*(
            getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        ))

    def numpy(self) -> dict[str, np.ndarray]:
        """Host copies, words reinterpreted as uint32."""
        out = {f.name: getattr(self, f.name).cpu().numpy()
               for f in dataclasses.fields(self)}
        out["t_words"] = out["t_words"].view(np.uint32)
        out["l_words"] = out["l_words"].view(np.uint32)
        return out


class ForestStats(NamedTuple):
    """Compression accounting (padding is a layout, not a size)."""

    total_bits: int  # sum over predicates of (|T| + |L|)
    padded_bits: int  # device-arena footprint
    per_pred_bits: np.ndarray
    per_pred_nnz: np.ndarray


def forest_from_numpy(arrays: dict[str, np.ndarray], device) -> K2Forest:
    """Device forest from host arrays (uint32 words viewed as int32)."""
    return K2Forest(*(
        bitvec.to_device(arrays[f.name], device) for f in dataclasses.fields(K2Forest)
    ))


def of_tree(tree: k2tree.K2Tree) -> K2Forest:
    """The one-tree forest (P = 1) that is ``tree``: row views of its
    arrays, neither padded nor rank-extended, so every clipped gather lands
    where the tree's own 1-D gathers land."""
    return K2Forest(
        t_words=tree.t.words[None], t_rank=tree.t.rank_blocks[None],
        l_words=tree.l.words[None], ones_before=tree.ones_before[None],
        level_start=tree.level_start[None],
        nnz=torch.full((1,), tree.nnz, dtype=torch.int32, device=tree.t.words.device),
    )


def build_forest(
    coords: Sequence[tuple[np.ndarray, np.ndarray]], meta: K2Meta, device
) -> tuple[K2Forest, ForestStats]:
    """Build one tree per predicate from (rows, cols) coordinate lists."""
    hosts = [k2tree.build_host(r, c, meta) for (r, c) in coords]
    P = len(hosts)
    H = meta.n_levels
    wt = max(1, max((h.t_bits.shape[0] + 31) // 32 for h in hosts))
    wl = max(1, max((h.l_bits.shape[0] + 31) // 32 for h in hosts))

    t_words = np.zeros((P, wt), np.uint32)
    t_rank = np.zeros((P, wt), np.int32)
    l_words = np.zeros((P, wl), np.uint32)
    ones_before = np.zeros((P, max(H - 1, 1)), np.int32)
    level_start = np.zeros((P, H), np.int32)
    nnz = np.zeros((P,), np.int32)
    bits = np.zeros((P,), np.int64)
    for i, h in enumerate(hosts):
        tw = bitvec.pack_bits_np(h.t_bits)
        t_words[i, : tw.shape[0]] = tw
        t_rank[i, : tw.shape[0]] = bitvec.rank_blocks_np(tw)
        # padding words rank-extend so rank1 beyond the tree stays monotone
        if tw.shape[0] < wt:
            t_rank[i, tw.shape[0]:] = int(h.t_bits.sum())
        lw = bitvec.pack_bits_np(h.l_bits)
        l_words[i, : lw.shape[0]] = lw
        ones_before[i, : h.ones_before.shape[0]] = h.ones_before
        level_start[i] = h.level_start
        nnz[i] = h.nnz
        bits[i] = h.t_bits.shape[0] + h.l_bits.shape[0]

    forest = forest_from_numpy(dict(
        t_words=t_words, t_rank=t_rank, l_words=l_words,
        ones_before=ones_before, level_start=level_start, nnz=nnz,
    ), device)
    stats = ForestStats(
        total_bits=int(bits.sum()),
        padded_bits=int(P * (wt + wl) * 32 + t_rank.size * 32),
        per_pred_bits=bits,
        per_pred_nnz=nnz.copy(),
    )
    return forest, stats


# ---------------------------------------------------------------------------
# batched queries — 2-D indexed (pred travels with every lane)
# ---------------------------------------------------------------------------


def check(meta: K2Meta, f: K2Forest, pred, rows, cols) -> torch.Tensor:
    """Batched (S, P, O) over per-lane predicates -> bool[Q].

    Coordinates may be negative or out of range: digits floor-divide and
    every gather clips, exactly as the JAX package's ``k2forest.check``.
    """
    from repro_torch.kernels import ops

    return ops.k2_check(meta, f, pred, rows, cols)


def scan_batch_mixed(meta: K2Meta, f: K2Forest, preds, keys, axes, cap: int) -> QueryResult:
    """Batched mixed row/col scans: axes[i]==0 -> row (S,P,?O), 1 -> col.

    Returns ``QueryResult`` with ids ``int32[Q, cap]`` in ascending order.
    """
    from repro_torch.kernels import ops

    return QueryResult(*ops.k2_scan(meta, f, preds, keys, axes, cap=cap))


def as_lanes(x, device, n: int | None = None) -> torch.Tensor:
    """``x`` (a scalar, sequence, array or tensor) as a contiguous int32
    lane tensor on ``device``; a scalar is broadcast to ``n`` lanes."""
    t = torch.as_tensor(x, device=device).to(torch.int32)
    if n is not None:
        t = t.reshape(-1).expand(n) if t.numel() == 1 else t
    return t.reshape(-1).contiguous()


def first_lane(r):
    """Lane 0 of a batched result tuple."""
    return type(r)(*(a[0] for a in r))


def check_all_preds(meta: K2Meta, f: K2Forest, row, col) -> torch.Tensor:
    """(S, ?P, O): bool[P], the paper's "check the cell in every tree"."""
    P = f.n_preds
    d = f.device
    return check(meta, f, torch.arange(P, dtype=torch.int32, device=d),
                 as_lanes(row, d, P), as_lanes(col, d, P))


def _scan(meta: K2Meta, f: K2Forest, preds, keys, axis: int, cap: int, n=None) -> QueryResult:
    """``scan_batch_mixed`` of one axis over lanes placed on the forest's
    device (``n`` broadcasts scalar lanes)."""
    d = f.device
    preds = as_lanes(preds, d, n)
    keys = as_lanes(keys, d, preds.shape[0])
    axes = torch.full(preds.shape, axis, dtype=torch.int32, device=d)
    return scan_batch_mixed(meta, f, preds, keys, axes, cap)


def row_scan(meta: K2Meta, f: K2Forest, pred, row, cap: int) -> QueryResult:
    """(S, P, ?O): direct neighbours, ascending object id."""
    return first_lane(_scan(meta, f, pred, row, 0, cap, 1))


def col_scan(meta: K2Meta, f: K2Forest, pred, col, cap: int) -> QueryResult:
    """(?S, P, O): reverse neighbours, ascending subject id."""
    return first_lane(_scan(meta, f, pred, col, 1, cap, 1))


def row_scan_batch(meta: K2Meta, f: K2Forest, preds, rows, cap: int) -> QueryResult:
    return _scan(meta, f, preds, rows, 0, cap)


def col_scan_batch(meta: K2Meta, f: K2Forest, preds, cols, cap: int) -> QueryResult:
    return _scan(meta, f, preds, cols, 1, cap)


def row_scan_all_preds(meta: K2Meta, f: K2Forest, row, cap: int) -> QueryResult:
    """(S, ?P, ?O): per-predicate object lists, axis 0 = predicate; the
    all-preds sweep is one scan launch with a broadcast key."""
    return _scan(meta, f, torch.arange(f.n_preds, dtype=torch.int32), row, 0, cap)


def col_scan_all_preds(meta: K2Meta, f: K2Forest, col, cap: int) -> QueryResult:
    """(?S, ?P, O): per-predicate subject lists."""
    return _scan(meta, f, torch.arange(f.n_preds, dtype=torch.int32), col, 1, cap)


def range_scan_batch(meta: K2Meta, f: K2Forest, preds, cap: int) -> PairResult:
    """Batched (?S, P, ?O) pair enumeration, one lane per predicate, pairs
    in Morton order."""
    from repro_torch.kernels import ops

    return PairResult(*ops.k2_range(meta, f, as_lanes(preds, f.device), cap=cap))


def range_scan(meta: K2Meta, f: K2Forest, pred, cap: int) -> PairResult:
    """(?S, P, ?O): every pair of one predicate's matrix (Morton order)."""
    return first_lane(range_scan_batch(meta, f, as_lanes(pred, f.device, 1), cap))


def range_scan_all_preds(meta: K2Meta, f: K2Forest, cap: int) -> PairResult:
    """(?S, ?P, ?O): the dataset dump, axis 0 = predicate."""
    return range_scan_batch(meta, f, torch.arange(f.n_preds, dtype=torch.int32), cap)


def scan_rebind_batch(
    meta: K2Meta, f: K2Forest, preds1, keys1, axes1, preds2, axes2,
    cap_x: int, cap_y: int,
):
    """Fused X-resolution + re-bind (join categories D and E).

    Per query lane: scan (preds1, keys1, axes1) into a ``cap_x`` side list
    of ?X ids, then re-bind each X into pattern 2 as (preds2, X, axes2)
    scans of ``cap_y``.  Dead X slots scan key 0; callers mask their
    ``y_valid`` rows with ``x_valid``.

    Returns ``(x_ids, x_valid, x_count, x_overflow, y_ids, y_valid,
    y_count, y_overflow)`` shaped ``(Q,cap_x) ×2, (Q,) ×2,
    (Q,cap_x,cap_y) ×2, (Q,cap_x) ×2``, 0-based coordinates throughout.
    """
    from repro_torch.kernels import ops

    d = f.device
    return ops.k2_scan_rebind(
        meta, f, as_lanes(preds1, d), as_lanes(keys1, d), as_lanes(axes1, d),
        as_lanes(preds2, d), as_lanes(axes2, d), cap_x=cap_x, cap_y=cap_y,
    )
