"""Plain torch versions of the CUDA kernels in ``csrc/``.

Each function computes exactly what its kernel computes, on raw arena
tensors, with dense batched tensor ops (level loops unrolled over the tree
height, compaction by scatter).  ``kernels/ops.py`` runs them for CPU
tensors; the tests compare them with the JAX package, and ``chip_smoke.py``
compares each kernel with them on the card.  The last three
(``popcount_ref``, ``sorted_intersect_mask_ref``, ``block_spmm_ref``) back
the ``ops`` entry points of the same names, which no query path calls.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitvec import (
    get_bit_2d, popcount32, rank1_2d, row_index, u32,
)
from repro_torch.core.k2tree import K2Meta, compact, row_digits
from repro_torch.core.sortedset import SENTINEL


def k2_check_ref(
    meta: K2Meta, t_words, t_rank, l_words, ones_before, level_start,
    preds, rows, cols,
) -> torch.Tensor:
    """Batched (S, P, O) point probe over the forest -> bool[Q]."""
    H = meta.n_levels
    p = row_index(preds.to(torch.int32), t_words.shape[0])
    rd, cd = row_digits(meta, rows), row_digits(meta, cols)
    alive = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    pos = rd[0] * meta.ks[0] + cd[0]
    for lvl in range(H):
        last = lvl == H - 1
        bit = get_bit_2d(l_words if last else t_words, p, pos)
        alive = alive & (bit == 1)
        if not last:
            j = rank1_2d(t_words, t_rank, p, pos) - ones_before[p, lvl]
            nxt = rd[lvl + 1] * meta.ks[lvl + 1] + cd[lvl + 1]
            pos = level_start[p, lvl + 1] + j * meta.radices[lvl + 1] + nxt
            pos = torch.where(alive, pos, 0)
    return alive


def k2_scan_ref(
    meta: K2Meta, t_words, t_rank, l_words, ones_before, level_start,
    preds, keys, axes, *, cap: int,
):
    """Batched mixed row/col scan -> (ids, valid, count, overflow).

    Level-synchronous frontier BFS: gather word, rank, expand ``k``
    children along the free axis, stable-compact into ``cap``.
    """
    H = meta.n_levels
    q = preds.shape[0]
    dev = preds.device
    p = row_index(preds.to(torch.int32), t_words.shape[0])[:, None]
    is_row = (axes == 0)[:, None]
    fdig = [d[:, None] for d in row_digits(meta, keys)]

    k0, sub0 = meta.ks[0], meta.subsides[0]
    init_n = min(k0, cap)
    j0 = torch.arange(init_n, dtype=torch.int32, device=dev)[None, :]
    pos = torch.zeros((q, cap), dtype=torch.int32, device=dev)
    base = torch.zeros((q, cap), dtype=torch.int32, device=dev)
    valid = torch.zeros((q, cap), dtype=torch.bool, device=dev)
    pos[:, :init_n] = torch.where(is_row, fdig[0] * k0 + j0, j0 * k0 + fdig[0])
    base[:, :init_n] = j0 * sub0
    valid[:, :init_n] = True
    overflow = torch.full((q,), k0 > cap, dtype=torch.bool, device=dev)
    valid = valid & (get_bit_2d(l_words if H == 1 else t_words, p, pos) == 1)

    for lvl in range(H - 1):
        k, r, sub = meta.ks[lvl + 1], meta.radices[lvl + 1], meta.subsides[lvl + 1]
        j = rank1_2d(t_words, t_rank, p, pos) - ones_before[p, lvl]
        child_base0 = level_start[p, lvl + 1] + j * r
        ch = torch.arange(k, dtype=torch.int32, device=dev)[None, None, :]
        d = fdig[lvl + 1][:, :, None]
        cpos = child_base0[:, :, None] + torch.where(
            is_row[:, :, None], d * k + ch, ch * k + d
        )
        cbase = base[:, :, None] + ch * sub
        words = l_words if lvl + 1 == H - 1 else t_words
        cbit = get_bit_2d(words, p[:, :, None], torch.where(valid[:, :, None], cpos, 0))
        cvalid = valid[:, :, None] & (cbit == 1)
        valid, _, ovf, (pos, base) = compact(
            cvalid.reshape(q, -1), cap, cpos.reshape(q, -1), cbase.reshape(q, -1)
        )
        overflow = overflow | ovf
        pos = torch.where(valid, pos, 0)

    valid, count, ovf, (ids,) = compact(valid, cap, base)
    return ids, valid, count, overflow | ovf


def k2_range_ref(
    meta: K2Meta, t_words, t_rank, l_words, ones_before, level_start,
    preds, *, cap: int,
):
    """Batched (?S, P, ?O) pair enumeration -> (rows, cols, valid, count,
    overflow).

    The frontier is ``(pos, rbase, cbase)``; each level expands by the full
    radix ``k²`` and stable-compacts into ``cap``, so pairs come out in
    Morton order.  Level 0 bit-tests every root child before compacting:
    overflow latches only when more than ``cap`` root children are set.
    """
    H = meta.n_levels
    q = preds.shape[0]
    dev = preds.device
    p = row_index(preds.to(torch.int32), t_words.shape[0])[:, None]

    k0, r0, sub0 = meta.ks[0], meta.radices[0], meta.subsides[0]
    d0 = torch.arange(r0, dtype=torch.int32, device=dev)[None, :].repeat(q, 1)
    bit0 = get_bit_2d(l_words if H == 1 else t_words, p, d0)
    valid, _, overflow, (pos, rbase, cbase) = compact(
        bit0 == 1, cap, d0, (d0 // k0) * sub0, (d0 % k0) * sub0
    )
    pos = torch.where(valid, pos, 0)

    for lvl in range(H - 1):
        k, r, sub = meta.ks[lvl + 1], meta.radices[lvl + 1], meta.subsides[lvl + 1]
        j = rank1_2d(t_words, t_rank, p, pos) - ones_before[p, lvl]
        child_base0 = level_start[p, lvl + 1] + j * r
        d = torch.arange(r, dtype=torch.int32, device=dev)[None, None, :]
        cpos = child_base0[:, :, None] + d
        crb = rbase[:, :, None] + (d // k) * sub
        ccb = cbase[:, :, None] + (d % k) * sub
        words = l_words if lvl + 1 == H - 1 else t_words
        cbit = get_bit_2d(words, p[:, :, None], torch.where(valid[:, :, None], cpos, 0))
        cvalid = valid[:, :, None] & (cbit == 1)
        valid, _, ovf, (pos, rbase, cbase) = compact(
            cvalid.reshape(q, -1), cap, cpos.reshape(q, -1),
            crb.reshape(q, -1), ccb.reshape(q, -1),
        )
        overflow = overflow | ovf
        pos = torch.where(valid, pos, 0)

    valid, count, ovf, (rows, cols) = compact(valid, cap, rbase, cbase)
    return rows, cols, valid, count, overflow | ovf


def k2_scan_rebind_ref(
    meta: K2Meta, t_words, t_rank, l_words, ones_before, level_start,
    preds1, keys1, axes1, preds2, axes2, *, cap_x: int, cap_y: int,
):
    """Scan -> re-bind: ``k2_scan_ref`` at ``cap_x``, then every X slot
    scanned again as (preds2[q], X, axes2[q]) at ``cap_y``.

    A dead X slot scans key 0 and its Y results are returned as computed
    (the caller masks them).  Returns ``(x_ids, x_valid, x_count,
    x_overflow, y_ids, y_valid, y_count, y_overflow)`` shaped
    ``(Q,cap_x) ×2, (Q,) ×2, (Q,cap_x,cap_y) ×2, (Q,cap_x) ×2``.
    """
    arenas = (t_words, t_rank, l_words, ones_before, level_start)
    q = preds1.shape[0]
    x_ids, x_valid, x_count, x_ovf = k2_scan_ref(
        meta, *arenas, preds1, keys1, axes1, cap=cap_x
    )
    keys2 = torch.where(x_valid, x_ids, 0).reshape(q * cap_x)
    p2 = preds2[:, None].expand(q, cap_x).reshape(q * cap_x)
    a2 = axes2[:, None].expand(q, cap_x).reshape(q * cap_x)
    y_ids, y_valid, y_count, y_ovf = k2_scan_ref(
        meta, *arenas, p2, keys2, a2, cap=cap_y
    )
    return (
        x_ids, x_valid, x_count, x_ovf,
        y_ids.reshape(q, cap_x, cap_y), y_valid.reshape(q, cap_x, cap_y),
        y_count.reshape(q, cap_x), y_ovf.reshape(q, cap_x),
    )


def _byte_at(words: torch.Tensor, bidx: torch.Tensor) -> torch.Tensor:
    w = u32(words[(bidx >> 2).clamp(0, words.shape[0] - 1).to(torch.int64)])
    return ((w >> ((bidx & 3) * 8).to(torch.int64)) & 0xFF).to(torch.int32)


def pred_gather_dac_ref(
    rows, anchors, words, degs, flags, frank, *,
    levels: int, level_byte_start: tuple, flag_word_start: tuple,
    deg_width: int, rows_per_block: int, cap: int,
):
    """DAC(b=8) SP/OP decode -> (ids, valid, count, overflow).

    ``rows`` must be pre-clipped to the index range.  Row pointers come
    from the block anchor plus the packed degrees before the row; each lane
    reads its level-0 chunk, follows continuation flags through the levels
    (flag rank = position in the next level), and a prefix sum over the
    lane axis turns gaps back into ascending 0-based predicate ids.
    """
    dev = rows.device
    rows = rows.to(torch.int32)
    per_word = 32 // deg_width
    dmask = (1 << deg_width) - 1
    block = torch.div(rows, rows_per_block, rounding_mode="floor")
    within = torch.remainder(rows, rows_per_block)

    kidx = torch.arange(rows_per_block, dtype=torch.int32, device=dev)
    widx = block[:, None] * 4 + torch.div(kidx, per_word, rounding_mode="floor")[None, :]
    dword = u32(degs[widx.clamp(0, degs.shape[0] - 1).to(torch.int64)])
    shift = ((kidx % per_word) * deg_width).to(torch.int64)
    dvals = ((dword >> shift[None, :]) & dmask).to(torch.int32)  # (B, rb)
    start = anchors[block.clamp(0, anchors.shape[0] - 1).to(torch.int64)] + torch.sum(
        dvals * (kidx[None, :] < within[:, None]), dim=1, dtype=torch.int32
    )
    deg = torch.gather(dvals, 1, within[:, None].to(torch.int64))[:, 0]

    lane = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    n = deg.clamp(max=cap)
    valid = lane < n[:, None]
    pos = torch.where(valid, start[:, None] + lane, 0)
    gap = _byte_at(words, level_byte_start[0] + pos)
    alive = valid
    for lvl in range(levels - 1):
        fidx = (flag_word_start[lvl] + (pos >> 5)).clamp(0, flags.shape[0] - 1).to(torch.int64)
        fword = u32(flags[fidx])
        sh = (pos & 31).to(torch.int64)
        bit = ((fword >> sh) & 1) == 1
        rank = frank[fidx] + popcount32(fword & ((torch.ones_like(fword) << sh) - 1))
        alive = alive & bit
        pos = torch.where(alive, rank, 0)
        chunk = _byte_at(words, level_byte_start[lvl + 1] + pos)
        gap = gap + torch.where(alive, chunk << (8 * (lvl + 1)), 0)
    preds = torch.cumsum(torch.where(valid, gap, 0), dim=1, dtype=torch.int32) - 1
    ids = torch.where(valid, preds, 0)
    return ids, valid, n, deg > cap


def pred_gather_ref(rows, offsets, words, *, bytes_per_pred: int, cap: int):
    """Fixed-layout CSR gather (byte-packed entries) -> as ``pred_gather_dac_ref``."""
    dev = rows.device
    rows = rows.to(torch.int64)
    start = offsets[rows]
    deg = offsets[rows + 1] - start
    lane = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    n = deg.clamp(max=cap)
    valid = lane < n[:, None]
    elem = torch.where(valid, start[:, None] + lane, 0)
    bidx = elem * bytes_per_pred
    word = u32(words[(bidx >> 2).clamp(0, words.shape[0] - 1).to(torch.int64)])
    mask = (1 << (8 * bytes_per_pred)) - 1
    pred = ((word >> ((bidx & 3) * 8).to(torch.int64)) & mask).to(torch.int32)
    return torch.where(valid, pred, 0), valid, n, deg > cap


def popcount_ref(words: torch.Tensor) -> torch.Tensor:
    """Set bits of every int32 word (uint32 bits) -> int32 of the same shape."""
    return popcount32(u32(words))


def sorted_intersect_mask_ref(a_ids: torch.Tensor, b_ids: torch.Tensor) -> torch.Tensor:
    """``mask[i] = a_ids[i] ∈ b_ids`` for ascending, ``SENTINEL``-padded
    int32 lists: the lower bound of each A lane in B, its B value clipped to
    B's last lane, ``== a``; a sentinel lane never matches."""
    pos = torch.searchsorted(b_ids, a_ids).clamp(max=b_ids.shape[0] - 1)
    return (b_ids[pos] == a_ids) & (a_ids != SENTINEL)


def block_spmm_ref(mask, a, x, block_m: int = 128, block_k: int = 128) -> torch.Tensor:
    """``Y = A @ X`` in f32, adding the product of A's ``(block_m, block_k)``
    tile ``(mi, ki)`` with X's row band ``ki`` only where ``mask[mi, ki] != 0``.

    A masked-off tile is selected away, never multiplied by 0, so a NaN or
    Inf in it (or in the X rows it would meet) does not reach Y: what the
    Pallas kernel computes, which never reads such a tile.  bf16 inputs are
    widened to f32, where their products are exact.
    """
    m, k = a.shape
    on = mask.repeat_interleave(block_m, dim=0) != 0  # (M, K/BK)
    y = torch.zeros((m, x.shape[1]), dtype=torch.float32, device=a.device)
    for ki in range(k // block_k):
        band = slice(ki * block_k, (ki + 1) * block_k)
        prod = a[:, band].to(torch.float32) @ x[band].to(torch.float32)
        y += torch.where(on[:, ki:ki + 1], prod, 0.0)
    return y
