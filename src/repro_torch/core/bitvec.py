"""Packed bit vectors with O(1) rank — the k²-tree storage primitive.

Bits are packed LSB-first into 32-bit words with a per-word exclusive
cumulative popcount, so that

    rank1(p) = rank[p >> 5] + popcount(word[p >> 5] & ((1 << (p & 31)) - 1))

Host construction is numpy.  On the device the word arenas are
``torch.int32`` tensors carrying the uint32 bit pattern
(``np.ndarray.view(np.int32)``): torch's uint32 has no shifts, so the plain
versions below widen gathered words to int64 and mask with ``0xFFFFFFFF``.

Out-of-range indices follow the JAX package's gathers exactly: a word index
is clipped to ``[0, W-1]``; a row (tree) index ``r`` is wrapped once if
negative (``r + P``) and then clipped to ``[0, P-1]``.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host-side (numpy) construction
# ---------------------------------------------------------------------------


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Pack a {0,1} uint8 array into uint32 words, LSB-first."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[0]
    n_words = max(1, (n + WORD_BITS - 1) // WORD_BITS)
    padded = np.zeros(n_words * WORD_BITS, dtype=np.uint64)
    padded[:n] = bits
    lanes = padded.reshape(n_words, WORD_BITS)
    weights = (np.uint64(1) << np.arange(WORD_BITS, dtype=np.uint64))
    return (lanes * weights).sum(axis=1).astype(np.uint32)


def rank_blocks_np(words: np.ndarray) -> np.ndarray:
    """Exclusive cumulative popcount per word (int32)."""
    pops = popcount_np(words)
    out = np.zeros_like(pops, dtype=np.int64)
    np.cumsum(pops[:-1], out=out[1:])
    return out.astype(np.int32)


def popcount_np(words: np.ndarray) -> np.ndarray:
    w = words.astype(np.uint32)
    w = w - ((w >> np.uint32(1)) & np.uint32(0x55555555))
    w = (w & np.uint32(0x33333333)) + ((w >> np.uint32(2)) & np.uint32(0x33333333))
    w = (w + (w >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((w * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


# ---------------------------------------------------------------------------
# device-side (torch) queries — vectorized over arbitrary index shapes
# ---------------------------------------------------------------------------


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as an int32 device tensor (uint32 words keep their bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words carrying uint32 bits -> int64 in ``[0, 2**32)``."""
    return words.to(torch.int64) & U32


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 lanes holding 32-bit values -> int32."""
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return (((w * 0x01010101) & U32) >> 24).to(torch.int32)


def row_index(row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """JAX's gather rule for a row index: wrap negatives once, then clip."""
    row = torch.where(row < 0, row + n_rows, row)
    return row.clamp(0, n_rows - 1).to(torch.int64)


def _word_index(words2d: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return (pos >> 5).clamp(0, words2d.shape[-1] - 1).to(torch.int64)


def get_bit_2d(words2d: torch.Tensor, row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos`` of row ``row`` of a (P, W) word arena -> int32 {0,1}."""
    word = u32(words2d[row_index(row, words2d.shape[0]), _word_index(words2d, pos)])
    return ((word >> (pos & 31).to(torch.int64)) & 1).to(torch.int32)


def rank1_2d(
    words2d: torch.Tensor, rank2d: torch.Tensor, row: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """Number of set bits of row ``row`` strictly before ``pos``."""
    r = row_index(row, words2d.shape[0])
    widx = _word_index(words2d, pos)
    word = u32(words2d[r, widx])
    mask = (torch.ones_like(word) << (pos & 31).to(torch.int64)) - 1
    return rank2d[r, widx] + popcount32(word & mask)
