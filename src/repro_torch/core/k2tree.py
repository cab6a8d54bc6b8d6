"""k²-tree: compressed quadtree over a sparse binary matrix (the paper's core).

Construction (host, numpy): sort-based, level-order emission of the T / L bit
arrays with the paper's hybrid arity (k=4 for the first 5 levels, then k=2).

Queries run as a level-synchronous batched traversal: every level processes
a whole frontier of candidate nodes as dense tensors (gather word, rank,
compute child positions).  Results have fixed shapes: a ``cap`` of slots,
a valid mask, a count and an overflow flag.

Navigation invariant (hybrid-k generalization of Brisaboa et al. 2009):
  * levels ``0 .. H-2`` live in T, level ``H-1`` (the matrix cells) lives in L;
  * the j-th 1-bit (level order) of level ``l`` owns the bit slab
    ``[j * k²_{l+1}, (j+1) * k²_{l+1})`` of level ``l+1``;
  * ``j = rank1(T, pos) - ones_before_level[l]``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitvec
from repro_torch.core.bitvec import BitVec

# Paper §k²-trees: "hybrid policy which uses values k=4, up to the level 5 of
# the tree, and then k=2, for the rest ones".
HYBRID_K4_LEVELS = 5


def hybrid_ks(side_needed: int, k4_levels: int = HYBRID_K4_LEVELS) -> tuple[int, ...]:
    """Per-level arities covering at least ``side_needed`` (paper's hybrid)."""
    ks: list[int] = []
    side = 1
    while side < side_needed:
        ks.append(4 if len(ks) < k4_levels else 2)
        side *= ks[-1]
    return tuple(ks) if ks else (2,)


@dataclasses.dataclass(frozen=True)
class K2Meta:
    """Static (hashable) tree geometry, shared by every tree of a forest."""

    ks: tuple[int, ...]  # per-level arity, len == n_levels

    @property
    def n_levels(self) -> int:
        return len(self.ks)

    @property
    def side(self) -> int:
        return int(np.prod(self.ks))

    @property
    def radices(self) -> tuple[int, ...]:
        return tuple(k * k for k in self.ks)

    @property
    def subsides(self) -> tuple[int, ...]:
        """Submatrix side of a node at each level (after that level's split)."""
        out, s = [], self.side
        for k in self.ks:
            s //= k
            out.append(s)
        return tuple(out)  # subsides[-1] == 1 (cells)


class K2Tree(NamedTuple):
    """One compressed matrix on a device (meta travels separately)."""

    t: BitVec
    l: BitVec
    ones_before: torch.Tensor  # int32[max(H-1, 1)]: #1s in T before each level
    level_start: torch.Tensor  # int32[H]: bit offset of each level
    #   (levels 0..H-2 offsets are into T; level_start[H-1] == 0, into L)
    nnz: int


class K2HostArrays(NamedTuple):
    """Raw numpy arrays of one tree (the forest packer's input)."""

    t_bits: np.ndarray  # uint8[t_len]
    l_bits: np.ndarray  # uint8[l_len]
    ones_before: np.ndarray  # int32[H-1]
    level_start: np.ndarray  # int32[H]
    nnz: int


def build_host(rows: np.ndarray, cols: np.ndarray, meta: K2Meta) -> K2HostArrays:
    """Sort-based level-order construction. O(nnz · H)."""
    H = meta.n_levels
    radices = meta.radices
    side = meta.side
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.size and (rows.max() >= side or cols.max() >= side):
        raise ValueError("coordinates exceed matrix side")

    # mixed-radix Morton-style code, most-significant level first
    code = np.zeros(rows.shape[0], dtype=np.int64)
    r, c, s = rows.copy(), cols.copy(), side
    for k in meta.ks:
        s //= k
        code = code * (k * k) + ((r // s) * k + (c // s))
        r %= s
        c %= s
    code = np.unique(code)
    nnz = int(code.shape[0])

    # per-level sorted prefixes (the 1-nodes of each level)
    prefixes: list[np.ndarray] = [None] * H  # type: ignore[list-item]
    prefixes[H - 1] = code
    for lvl in range(H - 2, -1, -1):
        prefixes[lvl] = np.unique(prefixes[lvl + 1] // radices[lvl + 1])

    level_bits: list[np.ndarray] = []
    for lvl in range(H):
        if lvl == 0:
            bits = np.zeros(radices[0], dtype=np.uint8)
            bits[prefixes[0]] = 1
        else:
            parent_idx = np.searchsorted(prefixes[lvl - 1], prefixes[lvl] // radices[lvl])
            pos = parent_idx * radices[lvl] + prefixes[lvl] % radices[lvl]
            bits = np.zeros(prefixes[lvl - 1].shape[0] * radices[lvl], dtype=np.uint8)
            bits[pos] = 1
        level_bits.append(bits)

    t_bits = (
        np.concatenate(level_bits[:-1]) if H > 1 else np.zeros(0, dtype=np.uint8)
    )
    l_bits = level_bits[-1]

    lvl_lens = np.array([b.shape[0] for b in level_bits[:-1]], dtype=np.int64)
    level_start = np.zeros(H, dtype=np.int32)
    if H > 1:
        level_start[1:-1] = np.cumsum(lvl_lens)[:-1].astype(np.int32)
    level_start[H - 1] = 0  # last level indexes into L

    ones = np.array([int(b.sum()) for b in level_bits[:-1]], dtype=np.int64)
    ones_before = np.zeros(max(H - 1, 1), dtype=np.int32)
    if H > 1:
        ones_before[1:] = np.cumsum(ones)[:-1].astype(np.int32)
        ones_before = ones_before[: H - 1]

    return K2HostArrays(t_bits, l_bits, ones_before, level_start, nnz)


def build(rows: np.ndarray, cols: np.ndarray, meta: K2Meta, device="cuda") -> K2Tree:
    """One tree of the cells ``(rows[i], cols[i])`` on ``device``."""
    from repro_torch.core.query import resolve_device

    device = resolve_device(device)
    h = build_host(rows, cols, meta)
    return K2Tree(
        t=bitvec.bitvec_from_bits(h.t_bits, device),
        l=bitvec.bitvec_from_bits(h.l_bits, device),
        ones_before=bitvec.to_device(h.ones_before, device),
        level_start=bitvec.to_device(h.level_start, device),
        nnz=h.nnz,
    )


def size_bits(tree: K2HostArrays | K2Tree) -> int:
    """Structure size in bits (T + L), the paper's compression metric."""
    if isinstance(tree, K2HostArrays):
        return int(tree.t_bits.shape[0] + tree.l_bits.shape[0])
    return tree.t.n_bits + tree.l.n_bits


# ---------------------------------------------------------------------------
# batched traversal helpers (torch)
# ---------------------------------------------------------------------------


def row_digits(meta: K2Meta, v: torch.Tensor) -> list[torch.Tensor]:
    """Per-level digit of a coordinate along one axis (floor semantics, so a
    negative or too-large coordinate only moves the first digit)."""
    digs = []
    rem = v.to(torch.int32)
    for sub in meta.subsides:
        digs.append(torch.div(rem, sub, rounding_mode="floor"))
        rem = torch.remainder(rem, sub)
    return digs


class QueryResult(NamedTuple):
    """Fixed-shape query result: ID-sorted ids, validity, count, overflow."""

    ids: torch.Tensor  # int32[..., cap]  (0 where ~valid)
    valid: torch.Tensor  # bool[..., cap]
    count: torch.Tensor  # int32[...]      min(#results, cap)
    overflow: torch.Tensor  # bool[...]    True if a frontier exceeded cap


class PairResult(NamedTuple):
    """Fixed-shape (?S, P, ?O) result: Morton-ordered pair coordinates."""

    rows: torch.Tensor  # int32[..., cap]  (0 where ~valid)
    cols: torch.Tensor  # int32[..., cap]
    valid: torch.Tensor  # bool[..., cap]
    count: torch.Tensor  # int32[...]
    overflow: torch.Tensor  # bool[...]


def compact(valid: torch.Tensor, cap: int, *arrays: torch.Tensor):
    """Stable per-row compaction (B, N) -> (B, cap), valid lanes first.

    The contract of the JAX ``_compact``: survivors are the first ``cap``
    valid lanes in lane order, dead slots are zeroed, and ``overflow`` is
    set when more than ``cap`` lanes are valid.  Returns
    ``(valid', count, overflow, arrays')``.
    """
    b = valid.shape[0]
    v = valid.to(torch.int32)
    total = v.sum(dim=1, dtype=torch.int32)
    idx = torch.cumsum(v, dim=1, dtype=torch.int32) - 1
    # invalid and beyond-cap lanes land in a spill column that is cut off
    tgt = torch.where(valid, idx, cap).clamp(max=cap).to(torch.int64)
    n = total.clamp(max=cap)
    lane = torch.arange(cap, dtype=torch.int32, device=valid.device)
    new_valid = lane[None, :] < n[:, None]
    outs = [
        torch.zeros((b, cap + 1), dtype=a.dtype, device=a.device)
        .scatter_(1, tgt, a)[:, :cap]
        for a in arrays
    ]
    return new_valid, n, total > cap, outs


# ---------------------------------------------------------------------------
# single-tree queries: the tree runs as the one-tree forest (P = 1) through
# the forest kernels (``kernels/ops.py``), every lane's predicate 0
# ---------------------------------------------------------------------------


def check(meta: K2Meta, tree: K2Tree, rows, cols) -> torch.Tensor:
    """Batched cell query: does (row, col) contain a 1?  -> bool of the
    broadcast shape of ``rows`` and ``cols``.  Paper pattern (S, P, O)."""
    from repro_torch.kernels import ops

    dev = tree.t.words.device
    rows, cols = torch.broadcast_tensors(torch.as_tensor(rows, device=dev),
                                         torch.as_tensor(cols, device=dev))
    hit = ops.k2_check_tree(meta, tree, rows.reshape(-1).to(torch.int32).contiguous(),
                            cols.reshape(-1).to(torch.int32).contiguous())
    return hit.reshape(rows.shape)


def row_scan(meta: K2Meta, tree: K2Tree, row, cap: int) -> QueryResult:
    """(S, P, ?O): columns of ``row`` (a scalar), ascending; ``(cap,)``
    ids and valid, 0-d count and overflow."""
    from repro_torch.core import k2forest

    return k2forest.row_scan(meta, k2forest.of_tree(tree), 0, row, cap)


def col_scan(meta: K2Meta, tree: K2Tree, col, cap: int) -> QueryResult:
    """(?S, P, O): rows of ``col`` (a scalar), ascending."""
    from repro_torch.core import k2forest

    return k2forest.col_scan(meta, k2forest.of_tree(tree), 0, col, cap)


def range_scan(meta: K2Meta, tree: K2Tree, cap: int) -> PairResult:
    """(?S, P, ?O): every 1-cell of the matrix (Morton order), capped.

    Level 0 bit-tests every root child and only then compacts into the
    ``cap`` frontier: overflow latches only when more than ``cap`` root
    children are occupied."""
    from repro_torch.core import k2forest

    return k2forest.range_scan(meta, k2forest.of_tree(tree), 0, cap)
