"""The paper's 4-range Dictionary mapping (Fig. 2, following BitMat).

Terms are split into four lexicographically-sorted categories:

  * SO — terms playing BOTH subject and object roles -> IDs [1, |SO|]
  * S  — subject-only terms                          -> IDs [|SO|+1, |SO|+|S|]
  * O  — object-only terms                           -> IDs [|SO|+1, |SO|+|O|]
  * P  — predicates                                  -> IDs [1, |P|]

so that subject/object cross-joins land in the shared [1,|SO|]² submatrix.
IDs are 1-based as in the paper; matrix coordinates are (id - 1).

The paper scopes dictionary *compression* out, but the system's thesis —
full-in-memory serving — needs it at dbpedia scale, and *Compressed
Indexes for Fast Search of Semantic Data* (arXiv:1904.07619) shows the
standard recipe is query-competitive: bucketed **plain front coding** for
the sorted term strings (each bucket stores its head verbatim, the rest as
(shared-prefix-len, suffix) varint records) with an **Elias–Fano** monotone
sequence over the bucket byte offsets, supporting both dictionary
operations — ``locate`` (term -> dense 1-based id, binary search over
bucket heads + in-bucket walk) and ``extract`` (id -> term, EF access +
bounded decode).  :class:`FrontCodedStrings` implements the pool,
:class:`CompressedTripleDictionary` the paper's 4-range mapping on top of
it (same API as :class:`TripleDictionary`), and ``size_bits`` /
``analytic_bits`` keep the accounting honest (measured arrays vs the
textbook n·(2 + log(u/n)) EF bound + raw front-coded bytes) for
``benchmarks/bench_compression``'s end-to-end bits/triple.

``encode_triples`` encodes a whole batch at once: each term class is
decoded once into a sorted numpy string array and every column is looked
up with ``np.searchsorted`` plus an equality check.  The ids are those of
the single-term ``encode_*`` methods (which keep the per-term algorithm),
and an unknown term raises the same ``KeyError`` as that path, for the
first triple that holds one.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.bitvec import popcount_np


@dataclasses.dataclass(frozen=True)
class TripleDictionary:
    """Immutable term <-> ID mapping with the paper's four ranges."""

    so_terms: tuple[str, ...]  # sorted; IDs 1..|SO|
    s_terms: tuple[str, ...]  # sorted; IDs |SO|+1 ..
    o_terms: tuple[str, ...]  # sorted; IDs |SO|+1 ..
    p_terms: tuple[str, ...]  # sorted; IDs 1..|P|

    # ---- sizes -----------------------------------------------------------
    @property
    def n_so(self) -> int:
        return len(self.so_terms)

    @property
    def n_subjects(self) -> int:  # total distinct subjects
        return self.n_so + len(self.s_terms)

    @property
    def n_objects(self) -> int:  # total distinct objects
        return self.n_so + len(self.o_terms)

    @property
    def n_preds(self) -> int:
        return len(self.p_terms)

    @property
    def matrix_extent(self) -> int:
        """Rows/cols the square adjacency matrices must cover."""
        return max(self.n_subjects, self.n_objects, 1)

    # ---- encode ----------------------------------------------------------
    def encode_subject(self, term: str) -> int:
        i = bisect.bisect_left(self.so_terms, term)
        if i < len(self.so_terms) and self.so_terms[i] == term:
            return i + 1
        j = bisect.bisect_left(self.s_terms, term)
        if j < len(self.s_terms) and self.s_terms[j] == term:
            return self.n_so + j + 1
        raise KeyError(f"unknown subject: {term!r}")

    def encode_object(self, term: str) -> int:
        i = bisect.bisect_left(self.so_terms, term)
        if i < len(self.so_terms) and self.so_terms[i] == term:
            return i + 1
        j = bisect.bisect_left(self.o_terms, term)
        if j < len(self.o_terms) and self.o_terms[j] == term:
            return self.n_so + j + 1
        raise KeyError(f"unknown object: {term!r}")

    def encode_predicate(self, term: str) -> int:
        j = bisect.bisect_left(self.p_terms, term)
        if j < len(self.p_terms) and self.p_terms[j] == term:
            return j + 1
        raise KeyError(f"unknown predicate: {term!r}")

    # ---- decode ----------------------------------------------------------
    def decode_subject(self, sid: int) -> str:
        if 1 <= sid <= self.n_so:
            return self.so_terms[sid - 1]
        return self.s_terms[sid - self.n_so - 1]

    def decode_object(self, oid: int) -> str:
        if 1 <= oid <= self.n_so:
            return self.so_terms[oid - 1]
        return self.o_terms[oid - self.n_so - 1]

    def decode_predicate(self, pid: int) -> str:
        return self.p_terms[pid - 1]

    def _pools(self) -> tuple[Sequence[str], ...]:
        return self.so_terms, self.s_terms, self.o_terms, self.p_terms

    def encode_triples(
        self, triples: Iterable[tuple[str, str, str]]
    ) -> np.ndarray:
        """-> int64[N, 3] of 1-based (s, p, o) IDs."""
        return _encode_batch(self, list(triples))


def _per_term(d, triples) -> np.ndarray:
    out = [
        (d.encode_subject(s), d.encode_predicate(p), d.encode_object(o))
        for (s, p, o) in triples
    ]
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def _str_array(terms) -> np.ndarray | None:
    """``terms`` as a numpy unicode array, or None when one ends in NUL:
    numpy's fixed-width strings drop trailing NULs, so equality would lie."""
    if any(t.endswith("\0") for t in terms):
        return None
    return np.array(terms, dtype=str) if len(terms) else np.zeros(0, "<U1")


def _lookup(pool: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """0-based index of each key in the sorted ``pool``, -1 where absent."""
    if pool.size == 0:
        return np.full(keys.shape, -1, np.int64)
    i = np.minimum(np.searchsorted(pool, keys), pool.size - 1)
    return np.where(pool[i] == keys, i, -1).astype(np.int64)


def _encode_ids(pools, triples) -> np.ndarray | None:
    """int64[N, 3] ids of ``triples`` over the four sorted term ``pools``
    (SO, S, O, P), 0 where a term is absent; None when a term ends in NUL
    (the caller then encodes term by term)."""
    arrays = [_str_array(list(t)) for t in pools]
    cols = [_str_array(list(c)) for c in zip(*triples)]
    if any(a is None for a in arrays + cols):
        return None
    so, s, o, p = arrays
    n_so = so.size

    def role(col, own):
        i, j = _lookup(so, col), _lookup(own, col)
        return np.where(i >= 0, i + 1, np.where(j >= 0, n_so + j + 1, 0))

    return np.stack([role(cols[0], s), _lookup(p, cols[1]) + 1, role(cols[2], o)], axis=1)


def _checked(d, triples, out: np.ndarray) -> np.ndarray:
    """``out`` once every id is known; else the per-term ``KeyError`` of the
    first triple with an unknown term."""
    bad = (out == 0).any(axis=1)
    if bad.any():
        s, p, o = triples[int(np.argmax(bad))]
        d.encode_subject(s), d.encode_predicate(p), d.encode_object(o)
        raise AssertionError("batched encode missed a term the per-term path knows")
    return out


def _encode_batch(d, triples: list) -> np.ndarray:
    if not triples:
        return np.zeros((0, 3), np.int64)
    out = _encode_ids(d._pools(), triples)
    return _per_term(d, triples) if out is None else _checked(d, triples, out)


def build_dictionary(triples: Sequence[tuple[str, str, str]]) -> TripleDictionary:
    """Classify every term into SO / S / O / P and sort each class."""
    subjects = {t[0] for t in triples}
    objects = {t[2] for t in triples}
    preds = {t[1] for t in triples}
    so = subjects & objects
    return TripleDictionary(
        so_terms=tuple(sorted(so)),
        s_terms=tuple(sorted(subjects - so)),
        o_terms=tuple(sorted(objects - so)),
        p_terms=tuple(sorted(preds)),
    )


# ---------------------------------------------------------------------------
# Elias–Fano monotone sequence (host-side; the bucket-offset index)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    """LEB128 unsigned varint."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


class EliasFano:
    """Elias–Fano encoding of a non-decreasing int sequence with O(1)-ish
    ``access``: low ``l = floor(log2(u/n))`` bits packed densely, high bits
    as a unary bitvector ``H`` where element i sets bit ``(v_i >> l) + i``,
    plus per-word inclusive popcount blocks so ``access(i)`` is a
    ``searchsorted`` (select1) + in-word bit walk.  Measured size counts all
    three arrays; ``analytic_bits`` is the textbook ``n * (2 + l)`` bound.
    """

    def __init__(self, values: Sequence[int]):
        v = np.asarray(values, np.int64).reshape(-1)
        self.n = int(v.size)
        if self.n == 0:
            self._l = 0
            self._low = np.zeros(0, np.uint32)
            self._high = np.zeros(1, np.uint32)
            self._cum = np.zeros(1, np.int64)
            self.universe = 0
            return
        if np.any(v[1:] < v[:-1]) or v[0] < 0:
            raise ValueError("EliasFano needs a non-decreasing, non-negative sequence")
        u = int(v[-1]) + 1
        self.universe = u
        l = max(0, (u // self.n).bit_length() - 1)
        self._l = l
        # low halves, l bits each, packed LSB-first into uint32 words
        if l:
            lw = np.zeros((self.n * l + 31) // 32, np.int64)
            for k in range(l):
                bitpos = np.arange(self.n, dtype=np.int64) * l + k
                bitpos = bitpos[((v >> k) & 1) == 1]
                np.bitwise_or.at(lw, bitpos >> 5, np.int64(1) << (bitpos & 31))
            self._low = lw.astype(np.uint32)
        else:
            self._low = np.zeros(0, np.uint32)
        # high halves: unary bitvector, bit (v_i >> l) + i set for element i
        hb = (v >> l) + np.arange(self.n, dtype=np.int64)
        hw = np.zeros((int(hb[-1]) >> 5) + 1, np.int64)
        np.bitwise_or.at(hw, hb >> 5, np.int64(1) << (hb & 31))
        self._high = hw.astype(np.uint32)
        self._cum = np.cumsum(popcount_np(self._high)).astype(np.int64)

    def __len__(self) -> int:
        return self.n

    def _low_at(self, i: int) -> int:
        val = 0
        for k in range(self._l):
            bp = i * self._l + k
            val |= ((int(self._low[bp >> 5]) >> (bp & 31)) & 1) << k
        return val

    def __getitem__(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise IndexError(i)
        # select1(i): word via searchsorted on inclusive ranks, then bit walk
        w = int(np.searchsorted(self._cum, i, side="right"))
        r = i - (int(self._cum[w - 1]) if w else 0)
        word = int(self._high[w])
        for b in range(32):
            if (word >> b) & 1:
                if r == 0:
                    return ((w * 32 + b - i) << self._l) | self._low_at(i)
                r -= 1
        raise AssertionError("rank blocks inconsistent with bitvector")

    def size_bits(self) -> int:
        return 32 * (self._low.size + self._high.size + 2 * self._cum.size)

    def analytic_bits(self) -> int:
        return self.n * (2 + self._l)


# ---------------------------------------------------------------------------
# bucketed plain-front-coded string pool with EF offsets (locate + extract)
# ---------------------------------------------------------------------------


class FrontCodedStrings:
    """Sorted string list, plain-front-coded in buckets of ``bucket`` terms.

    Each bucket stores its head verbatim (``varint(len) + bytes``) and the
    remaining terms as ``varint(lcp) + varint(suffix_len) + suffix`` records;
    bucket byte offsets live in an :class:`EliasFano` index.  ``extract``
    (``__getitem__``) decodes at most ``bucket`` records; ``locate`` binary
    searches the bucket heads then walks one bucket.  LCPs are in characters
    (suffixes stored as UTF-8), so non-ASCII terms round-trip.
    """

    def __init__(self, terms: Sequence[str], bucket: int = 8):
        self.bucket = int(bucket)
        blob = bytearray()
        offsets: list[int] = []
        prev = ""
        for i, t in enumerate(terms):
            if i % self.bucket == 0:
                offsets.append(len(blob))
                enc = t.encode()
                blob += _varint(len(enc)) + enc
            else:
                lcp = 0
                m = min(len(prev), len(t))
                while lcp < m and prev[lcp] == t[lcp]:
                    lcp += 1
                enc = t[lcp:].encode()
                blob += _varint(lcp) + _varint(len(enc)) + enc
            prev = t
        self.n = len(terms)
        self._blob = bytes(blob)
        self._ef = EliasFano(offsets)

    def __len__(self) -> int:
        return self.n

    def _head(self, b: int) -> str:
        pos = self._ef[b]
        ln, pos = _read_varint(self._blob, pos)
        return self._blob[pos : pos + ln].decode()

    def _bucket_iter(self, b: int):
        """Yield (index, term) for every term in bucket b, in order."""
        pos = self._ef[b]
        ln, pos = _read_varint(self._blob, pos)
        cur = self._blob[pos : pos + ln].decode()
        pos += ln
        i = b * self.bucket
        yield i, cur
        end = min(self.n, i + self.bucket)
        for i in range(i + 1, end):
            lcp, pos = _read_varint(self._blob, pos)
            ln, pos = _read_varint(self._blob, pos)
            cur = cur[:lcp] + self._blob[pos : pos + ln].decode()
            pos += ln
            yield i, cur

    def terms(self) -> list[str]:
        """Every term in order: one linear walk of the blob."""
        out: list[str] = []
        pos, cur = 0, ""
        for i in range(self.n):
            if i % self.bucket == 0:
                ln, pos = _read_varint(self._blob, pos)
                cur = self._blob[pos : pos + ln].decode()
            else:
                lcp, pos = _read_varint(self._blob, pos)
                ln, pos = _read_varint(self._blob, pos)
                cur = cur[:lcp] + self._blob[pos : pos + ln].decode()
            pos += ln
            out.append(cur)
        return out

    def __getitem__(self, idx: int) -> str:
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        b = idx // self.bucket
        for i, t in self._bucket_iter(b):
            if i == idx:
                return t
        raise AssertionError("bucket walk missed its own index")

    def locate(self, term: str) -> int:
        """0-based index of ``term``, or -1 if absent (terms must be sorted)."""
        if self.n == 0 or term < self._head(0):
            return -1
        lo, hi = 0, len(self._ef) - 1
        while lo < hi:  # rightmost bucket whose head <= term
            mid = (lo + hi + 1) // 2
            if self._head(mid) <= term:
                lo = mid
            else:
                hi = mid - 1
        for i, t in self._bucket_iter(lo):
            if t == term:
                return i
            if t > term:
                return -1
        return -1

    def size_bits(self) -> int:
        """Measured: blob bytes + the EF offset index (incl. rank blocks)."""
        return 8 * len(self._blob) + self._ef.size_bits()

    def analytic_bits(self) -> int:
        """Front-coded bytes + the EF bound (no word padding, no rank)."""
        return 8 * len(self._blob) + self._ef.analytic_bits()

    def size_bytes(self) -> int:
        return (self.size_bits() + 7) // 8


# ---------------------------------------------------------------------------
# the 4-range Dictionary over front-coded pools (same API as TripleDictionary)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class CompressedTripleDictionary:
    """The paper's 4-range mapping with every term class stored as a
    :class:`FrontCodedStrings` pool — duck-compatible with
    :class:`TripleDictionary` (same encode/decode/size API) but holding
    compressed bytes instead of Python string tuples, so the end-to-end
    bits/triple quoted by ``bench_compression`` includes a *real* dictionary.
    """

    so: FrontCodedStrings
    s: FrontCodedStrings
    o: FrontCodedStrings
    p: FrontCodedStrings

    # ---- sizes -----------------------------------------------------------
    @property
    def n_so(self) -> int:
        return len(self.so)

    @property
    def n_subjects(self) -> int:
        return self.n_so + len(self.s)

    @property
    def n_objects(self) -> int:
        return self.n_so + len(self.o)

    @property
    def n_preds(self) -> int:
        return len(self.p)

    @property
    def matrix_extent(self) -> int:
        return max(self.n_subjects, self.n_objects, 1)

    # TripleDictionary compatibility: materialized term tuples (tests only —
    # hot paths go through locate/extract and never expand these)
    @property
    def so_terms(self) -> tuple[str, ...]:
        return tuple(self.so[i] for i in range(len(self.so)))

    @property
    def s_terms(self) -> tuple[str, ...]:
        return tuple(self.s[i] for i in range(len(self.s)))

    @property
    def o_terms(self) -> tuple[str, ...]:
        return tuple(self.o[i] for i in range(len(self.o)))

    @property
    def p_terms(self) -> tuple[str, ...]:
        return tuple(self.p[i] for i in range(len(self.p)))

    # ---- encode (locate) -------------------------------------------------
    def encode_subject(self, term: str) -> int:
        i = self.so.locate(term)
        if i >= 0:
            return i + 1
        j = self.s.locate(term)
        if j >= 0:
            return self.n_so + j + 1
        raise KeyError(f"unknown subject: {term!r}")

    def encode_object(self, term: str) -> int:
        i = self.so.locate(term)
        if i >= 0:
            return i + 1
        j = self.o.locate(term)
        if j >= 0:
            return self.n_so + j + 1
        raise KeyError(f"unknown object: {term!r}")

    def encode_predicate(self, term: str) -> int:
        j = self.p.locate(term)
        if j >= 0:
            return j + 1
        raise KeyError(f"unknown predicate: {term!r}")

    # ---- decode (extract) ------------------------------------------------
    def decode_subject(self, sid: int) -> str:
        if 1 <= sid <= self.n_so:
            return self.so[sid - 1]
        return self.s[sid - self.n_so - 1]

    def decode_object(self, oid: int) -> str:
        if 1 <= oid <= self.n_so:
            return self.so[oid - 1]
        return self.o[oid - self.n_so - 1]

    def decode_predicate(self, pid: int) -> str:
        return self.p[pid - 1]

    def _pools(self) -> tuple[Sequence[str], ...]:
        return tuple(pool.terms() for pool in (self.so, self.s, self.o, self.p))

    def encode_triples(
        self, triples: Iterable[tuple[str, str, str]]
    ) -> np.ndarray:
        return _encode_batch(self, list(triples))

    # ---- accounting ------------------------------------------------------
    def size_bits(self) -> int:
        return sum(
            pool.size_bits() for pool in (self.so, self.s, self.o, self.p)
        )

    def analytic_bits(self) -> int:
        return sum(
            pool.analytic_bits() for pool in (self.so, self.s, self.o, self.p)
        )

    def raw_bits(self) -> int:
        """Uncompressed UTF-8 bytes of every term (the baseline)."""
        total = 0
        for pool in (self.so, self.s, self.o, self.p):
            for i in range(len(pool)):
                total += len(pool[i].encode())
        return 8 * total


def build_compressed_dictionary(
    triples: Sequence[tuple[str, str, str]], *, bucket: int = 8
) -> CompressedTripleDictionary:
    """Classify terms into SO / S / O / P and front-code each sorted class."""
    subjects = {t[0] for t in triples}
    objects = {t[2] for t in triples}
    preds = {t[1] for t in triples}
    so = subjects & objects
    return CompressedTripleDictionary(
        so=FrontCodedStrings(sorted(so), bucket),
        s=FrontCodedStrings(sorted(subjects - so), bucket),
        o=FrontCodedStrings(sorted(objects - so), bucket),
        p=FrontCodedStrings(sorted(preds), bucket),
    )


class ExtendedDictionary:
    """Incremental id-range extension on top of a frozen dictionary.

    The delta layer (``core/delta.py``) must mint ids for terms the static
    dictionary has never seen without perturbing any existing id — the
    static k²-forest and DAC index are addressed by those ids.  Extension
    terms therefore get a single SHARED subject/object id appended above
    ``base.matrix_extent`` (id ``ext_base + k``, 1-based ``k``), and
    extension predicates are appended above ``base.n_preds``.  Compaction
    folds the extension into the rebuilt store by passing the same
    ``ExtendedDictionary`` through — appended ranges keep ids stable across
    epochs, so plans and cached results never need re-translation.

    Duck-compatible with :class:`TripleDictionary` /
    :class:`CompressedTripleDictionary` (``encode_*`` raise ``KeyError`` on
    unknown terms; ``decode_*`` cover both base and extension ranges).
    """

    def __init__(self, base: TripleDictionary | CompressedTripleDictionary):
        self.base = base
        self.ext_base = base.matrix_extent
        self.pred_base = base.n_preds
        self._terms: list[str] = []  # shared S/O extension pool
        self._ids: dict[str, int] = {}
        self._preds: list[str] = []
        self._pred_ids: dict[str, int] = {}

    # --- extents (appended ranges inflate both roles: harmless empty rows)

    @property
    def n_so(self) -> int:
        return self.base.n_so

    @property
    def n_subjects(self) -> int:
        return self.ext_base + len(self._terms) if self._terms else self.base.n_subjects

    @property
    def n_objects(self) -> int:
        return self.ext_base + len(self._terms) if self._terms else self.base.n_objects

    @property
    def n_preds(self) -> int:
        return self.pred_base + len(self._preds)

    @property
    def matrix_extent(self) -> int:
        return max(self.ext_base + len(self._terms), 1)

    @property
    def n_ext_terms(self) -> int:
        return len(self._terms)

    # --- encode (base first, then the extension pool)

    def _encode_ext(self, term: str) -> int:
        i = self._ids.get(term)
        if i is None:
            raise KeyError(term)
        return i

    def encode_subject(self, term: str) -> int:
        try:
            return self.base.encode_subject(term)
        except KeyError:
            return self._encode_ext(term)

    def encode_object(self, term: str) -> int:
        try:
            return self.base.encode_object(term)
        except KeyError:
            return self._encode_ext(term)

    def encode_predicate(self, term: str) -> int:
        try:
            return self.base.encode_predicate(term)
        except KeyError:
            i = self._pred_ids.get(term)
            if i is None:
                raise KeyError(term)
            return i

    # --- extend (idempotent: re-adding returns the existing id)

    def add_term(self, term: str) -> int:
        """Register ``term`` in the shared S/O extension pool -> its id."""
        for enc in (self.base.encode_subject, self.base.encode_object):
            try:
                return enc(term)
            except KeyError:
                pass
        i = self._ids.get(term)
        if i is None:
            i = self.ext_base + len(self._terms) + 1
            self._terms.append(term)
            self._ids[term] = i
        return i

    def add_predicate(self, term: str) -> int:
        try:
            return self.base.encode_predicate(term)
        except KeyError:
            i = self._pred_ids.get(term)
            if i is None:
                i = self.pred_base + len(self._preds) + 1
                self._preds.append(term)
                self._pred_ids[term] = i
            return i

    # --- decode

    def _decode_ext(self, xid: int) -> str:
        return self._terms[xid - self.ext_base - 1]

    def decode_subject(self, sid: int) -> str:
        if sid > self.ext_base:
            return self._decode_ext(sid)
        return self.base.decode_subject(sid)

    def decode_object(self, oid: int) -> str:
        if oid > self.ext_base:
            return self._decode_ext(oid)
        return self.base.decode_object(oid)

    def decode_predicate(self, pid: int) -> str:
        if pid > self.pred_base:
            return self._preds[pid - self.pred_base - 1]
        return self.base.decode_predicate(pid)

    def encode_triples(
        self, triples: Iterable[tuple[str, str, str]]
    ) -> np.ndarray:
        """Base ids first, then the extension pools for the rest."""
        triples = list(triples)
        if not triples:
            return np.zeros((0, 3), np.int64)
        out = _encode_ids(self.base._pools(), triples)
        if out is None:
            return _per_term(self, triples)
        for k, c in zip(*np.nonzero(out == 0)):
            got = (self._pred_ids if c == 1 else self._ids).get(triples[k][c])
            if got is not None:
                out[k, c] = got
        return _checked(self, triples, out)
