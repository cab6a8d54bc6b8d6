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
from repro_torch.core.k2tree import K2Meta, QueryResult


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
