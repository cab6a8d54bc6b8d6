"""Compressed SP/OP predicate indexes — the k²-triples+ subsystem.

An unbounded-``?P`` query (``(S,?P,?O)`` / ``(?S,?P,O)`` / ``(S,?P,O)``)
gathers its candidate predicates from these indexes and scans only those
trees (arXiv:1310.4954).  Both indexes share ONE arena: row ``s-1`` for
subject ``s``, row ``|S| + o - 1`` for object ``o`` (1-based ids).

Two on-device layouts, selected by ``PredIndexMeta.layout``:

  * ``"dac"`` (default) — DAC(b=8): each list is gap-encoded (first entry
    +1, then deltas) and split into 8-bit chunks; level k holds the k-th
    chunk of every gap still alive, with a rank-enabled continuation-flag
    bitmap per non-final level.  Row pointers are one int32 anchor per
    ``rows_per_block`` rows plus ``deg_width``-bit packed degrees.  Decoded
    on the device by the ``pred_gather_dac`` kernel.
  * ``"fixed"`` — byte-packed lists at ``bytes_per_pred`` ∈ {1, 2, 4} under
    int32 CSR offsets.  Only its plain version exists so far: on a CUDA
    tensor it raises until its kernel is ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitvec
from repro_torch.core.bitvec import popcount_np
from repro_torch.core.k2tree import QueryResult

DAC_CHUNK_BITS = 8


@dataclasses.dataclass(frozen=True)
class PredIndex:
    """Device arrays of one layout (unused fields are size-1 placeholders).

      * fixed: ``offsets`` int32[R+1] CSR row pointers, ``words`` the
        byte-packed predicate ids.
      * dac:   ``offsets`` int32[n_blocks] block anchors, ``degs`` packed
        per-row degrees, ``words`` the per-level chunk byte streams,
        ``flags`` the continuation bitmaps, ``frank`` their in-level ranks.

    ``words``/``degs``/``flags`` are int32 tensors carrying uint32 bits.
    """

    offsets: torch.Tensor
    words: torch.Tensor
    degs: torch.Tensor
    flags: torch.Tensor
    frank: torch.Tensor

    def to(self, device) -> "PredIndex":
        return PredIndex(*(
            getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        ))

    def numpy(self) -> dict[str, np.ndarray]:
        out = {f.name: getattr(self, f.name).cpu().numpy()
               for f in dataclasses.fields(self)}
        for name in ("words", "degs", "flags"):
            out[name] = out[name].view(np.uint32)
        return out


def index_from_numpy(arrays: dict[str, np.ndarray], device) -> PredIndex:
    return PredIndex(*(
        bitvec.to_device(arrays[f.name], device) for f in dataclasses.fields(PredIndex)
    ))


@dataclasses.dataclass(frozen=True)
class PredIndexMeta:
    """Static (hashable) geometry — travels like ``K2Meta``."""

    n_subjects: int
    n_objects: int
    n_preds: int
    bytes_per_pred: int  # 1, 2 or 4 (an entry never straddles a word)
    max_degree: int  # max list length over all subjects and objects
    max_sp_degree: int = 0
    max_op_degree: int = 0
    # --- DAC layout geometry (meaningful when layout == "dac") ---
    layout: str = "fixed"  # "fixed" | "dac"
    levels: int = 1  # number of DAC chunk levels L
    level_byte_start: tuple = (0,)  # len L: start byte of each level stream
    flag_word_start: tuple = ()  # len L-1: word start of each level's bitmap
    deg_width: int = 32  # bits per packed degree (4 | 8 | 16 | 32)
    rows_per_block: int = 1  # rows sharing one anchor (4 words of degrees)


class PredIndexStats(NamedTuple):
    """Size accounting: measured device bits of the DAC layout, the analytic
    DAC(b=8) size of the gap lists, and the fixed fallback's cost."""

    sp_entries: int
    op_entries: int
    payload_bits: int
    offsets_bits: int
    dac_bits: int
    bits_per_triple: float
    fixed_payload_bits: int = 0
    fixed_offsets_bits: int = 0
    fixed_bits_per_triple: float = 0.0


@dataclasses.dataclass(frozen=True)
class BuiltPredIndex:
    """Device DAC index + its fixed-layout fallback + host views.

    A store converted from foreign arrays (``core.convert``) carries no
    fixed fallback, stats or host CSR: those fields are ``None``.
    """

    device: PredIndex
    meta: PredIndexMeta
    stats: PredIndexStats | None = None
    host_offsets: np.ndarray | None = None  # int64[R + 1]
    host_preds: np.ndarray | None = None  # int32[total] 0-based, sorted per row
    device_fixed: PredIndex | None = None
    meta_fixed: PredIndexMeta | None = None

    def select(self, layout: str | None = None):
        """(device, meta) for ``layout`` ("dac" | "fixed" | None=default)."""
        if layout is None or layout == self.meta.layout:
            return self.device, self.meta
        if self.device_fixed is not None and layout == self.meta_fixed.layout:
            return self.device_fixed, self.meta_fixed
        raise ValueError(f"store carries no {layout!r} predicate index")

    def to(self, device) -> "BuiltPredIndex":
        return dataclasses.replace(
            self, device=self.device.to(device),
            device_fixed=(None if self.device_fixed is None
                          else self.device_fixed.to(device)),
        )


# ---------------------------------------------------------------------------
# construction (numpy, host)
# ---------------------------------------------------------------------------


def _dac_bits(values: np.ndarray, chunk: int = 8) -> int:
    """Analytic multi-level DAC size: ``chunk``-bit chunks + 1 flag bit each."""
    if values.size == 0:
        return 0
    v = values.astype(np.int64)
    nbits = np.maximum(1, np.floor(np.log2(np.maximum(v, 1))) + 1)
    nchunks = np.ceil(nbits / chunk)
    return int(nchunks.sum() * (chunk + 1))


def _encode_dac(gaps: np.ndarray):
    """Encode positive gaps into the multi-level DAC(b=8) arrays.

    Returns ``(words, levels, level_byte_start, flag_word_start, flags,
    frank)``.
    """
    g = np.asarray(gaps, np.int64)
    if g.size == 0:
        return (
            np.zeros(1, np.uint32), 1, (0,), (),
            np.zeros(1, np.uint32), np.zeros(1, np.int32),
        )
    nbits = np.maximum(1, np.floor(np.log2(np.maximum(g, 1))).astype(np.int64) + 1)
    nchunks = (nbits + DAC_CHUNK_BITS - 1) // DAC_CHUNK_BITS
    levels = int(nchunks.max())

    streams, flag_words, frank_words, level_byte_start, flag_word_start = (
        [], [], [], [], []
    )
    byte_pos = 0
    flag_pos = 0
    cur, cur_nchunks = g, nchunks
    for lvl in range(levels):
        level_byte_start.append(byte_pos)
        stream = (cur & 0xFF).astype(np.uint8)
        streams.append(stream)
        byte_pos += int(stream.size)
        cont = cur_nchunks > (lvl + 1)
        if lvl < levels - 1:
            n_words = max((int(stream.size) + 31) // 32, 1)
            fw = np.zeros(n_words, np.int64)
            idx = np.nonzero(cont)[0]
            np.bitwise_or.at(fw, idx >> 5, np.int64(1) << (idx & 31))
            fw = fw.astype(np.uint32)
            fr = np.zeros(n_words, np.int64)
            np.cumsum(popcount_np(fw)[:-1], out=fr[1:])
            flag_word_start.append(flag_pos)
            flag_pos += n_words
            flag_words.append(fw)
            frank_words.append(fr.astype(np.int32))
        cur = cur[cont] >> DAC_CHUNK_BITS
        cur_nchunks = cur_nchunks[cont]

    chunk_bytes = np.concatenate(streams)
    padded = np.zeros((chunk_bytes.size + 3) // 4 * 4, np.uint8)
    padded[: chunk_bytes.size] = chunk_bytes
    words = padded.view("<u4").copy()
    if flag_words:
        flags = np.concatenate(flag_words)
        frank = np.concatenate(frank_words)
    else:
        flags = np.zeros(1, np.uint32)
        frank = np.zeros(1, np.int32)
    return (
        words, levels, tuple(level_byte_start), tuple(flag_word_start),
        flags, frank,
    )


def _pack_degrees(counts: np.ndarray, offsets: np.ndarray, max_degree: int):
    """Pack per-row degrees at the narrowest SWAR width + block anchors.

    Returns ``(anchors, degs, deg_width, rows_per_block)``; a block's
    packed degrees span exactly 4 uint32 words.
    """
    deg_width = next(w for w in (4, 8, 16, 32) if max_degree < (1 << w))
    per_word = 32 // deg_width
    rows_per_block = 4 * per_word
    n_rows = int(counts.size)
    n_blocks = max((n_rows + rows_per_block - 1) // rows_per_block, 1)
    padded = np.zeros(n_blocks * rows_per_block, np.uint64)
    padded[:n_rows] = counts.astype(np.uint64)
    lanes = padded.reshape(n_blocks * 4, per_word)
    shifts = np.arange(per_word, dtype=np.uint64) * deg_width
    degs = np.bitwise_or.reduce(lanes << shifts[None, :], axis=1).astype(np.uint32)
    anchors = offsets[: n_blocks * rows_per_block : rows_per_block].astype(np.int32)
    if anchors.size < n_blocks:  # counts.size == 0 degenerate
        anchors = np.zeros(n_blocks, np.int32)
    return anchors, degs, deg_width, rows_per_block


def build(
    ids: np.ndarray, *, n_subjects: int, n_objects: int, n_preds: int,
    device, n_triples: int | None = None,
) -> BuiltPredIndex:
    """Build SP+OP from int64[N,3] 1-based (s, p, o) ID triples."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1, 3)
    n_triples = int(ids.shape[0]) if n_triples is None else n_triples
    sp = np.unique(ids[:, [0, 1]], axis=0)  # sorted (s, p): lists come sorted
    op = np.unique(ids[:, [2, 1]], axis=0)

    R = n_subjects + n_objects
    counts = np.zeros(R, np.int64)
    np.add.at(counts, sp[:, 0] - 1, 1)
    np.add.at(counts, n_subjects + op[:, 0] - 1, 1)
    offsets = np.zeros(R + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    preds = np.zeros(max(int(offsets[-1]), 1), np.int32)
    preds[: sp.shape[0]] = sp[:, 1] - 1
    op_base = int(offsets[n_subjects])
    preds[op_base : op_base + op.shape[0]] = op[:, 1] - 1

    bpp = 1 if n_preds <= 0xFF else (2 if n_preds <= 0xFFFF else 4)
    per_word = 4 // bpp
    n_entries = int(offsets[-1])
    padded = np.zeros(((max(n_entries, 1) + per_word - 1) // per_word) * per_word,
                      np.uint32)
    padded[:n_entries] = preds[:n_entries].astype(np.uint32)
    lanes = padded.reshape(-1, per_word)
    shifts = (np.arange(per_word, dtype=np.uint64) * 8 * bpp)
    words_fixed = np.bitwise_or.reduce(
        (lanes.astype(np.uint64) << shifts[None, :]), axis=1
    ).astype(np.uint32)

    max_degree = int(counts.max()) if R else 0
    max_sp = int(counts[:n_subjects].max()) if n_subjects else 0
    max_op = int(counts[n_subjects:].max()) if n_objects else 0
    # gap-encode each list: first entry +1, then deltas (all gaps >= 1)
    gaps = preds[:n_entries].astype(np.int64) + 1
    if n_entries:
        starts = offsets[:-1][counts > 0]
        inner = np.ones(n_entries, np.bool_)
        inner[starts] = False
        gaps[inner] = np.diff(preds[:n_entries].astype(np.int64))[inner[1:]]

    dac_words, levels, lbs, fws, flags, frank = _encode_dac(gaps)
    anchors, degs, deg_width, rows_per_block = _pack_degrees(
        counts, offsets, max_degree
    )

    payload_bits = int((dac_words.size + flags.size) * 32 + frank.size * 32)
    offsets_bits = int((anchors.size + degs.size) * 32)
    fixed_payload = int(words_fixed.size * 32)
    fixed_offsets = int((R + 1) * 32)
    stats = PredIndexStats(
        sp_entries=int(sp.shape[0]),
        op_entries=int(op.shape[0]),
        payload_bits=payload_bits,
        offsets_bits=offsets_bits,
        dac_bits=_dac_bits(gaps),
        bits_per_triple=float(payload_bits + offsets_bits) / max(n_triples, 1),
        fixed_payload_bits=fixed_payload,
        fixed_offsets_bits=fixed_offsets,
        fixed_bits_per_triple=float(fixed_payload + fixed_offsets)
        / max(n_triples, 1),
    )
    placeholder_u = np.zeros(1, np.uint32)
    placeholder_i = np.zeros(1, np.int32)
    common = dict(
        n_subjects=n_subjects, n_objects=n_objects, n_preds=n_preds,
        bytes_per_pred=bpp, max_degree=max_degree,
        max_sp_degree=max_sp, max_op_degree=max_op,
    )
    return BuiltPredIndex(
        device=index_from_numpy(dict(
            offsets=anchors, words=dac_words, degs=degs, flags=flags,
            frank=frank,
        ), device),
        meta=PredIndexMeta(
            layout="dac", levels=levels, level_byte_start=lbs,
            flag_word_start=fws, deg_width=deg_width,
            rows_per_block=rows_per_block, **common,
        ),
        stats=stats,
        host_offsets=offsets,
        host_preds=preds[:n_entries],
        device_fixed=index_from_numpy(dict(
            offsets=offsets.astype(np.int32), words=words_fixed,
            degs=placeholder_u, flags=placeholder_u, frank=placeholder_i,
        ), device),
        meta_fixed=PredIndexMeta(layout="fixed", **common),
    )


# ---------------------------------------------------------------------------
# device queries
# ---------------------------------------------------------------------------


def gather_batch(pmeta: PredIndexMeta, index: PredIndex, rows, cap: int) -> QueryResult:
    """Batched candidate-predicate gather: rows int32[B] (0-based entity
    rows, clipped to the index range) -> 0-based predicate ids in
    ``(B, cap)`` slots, prefix-valid, dead slots zeroed, overflow = list
    longer than ``cap``."""
    from repro_torch.kernels import ops

    rows = rows.to(torch.int32).clamp(
        0, max(pmeta.n_subjects + pmeta.n_objects - 1, 0)
    )
    if pmeta.layout == "dac":
        return QueryResult(*ops.pred_gather_dac(pmeta, index, rows, cap=cap))
    return QueryResult(*ops.pred_gather(pmeta, index, rows, cap=cap))
