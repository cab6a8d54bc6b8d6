"""Fixed-shape sorted-ID set algebra (intersection / union).

Join side lists are fixed-capacity lanes with validity masks.  Invalid
lanes hold ``SENTINEL`` (int32 max), so sorted order puts them at the tail:

  * intersection = binary search (``torch.searchsorted``) of A's lanes in
    B, then a sort that sinks the sentinels;
  * union = concatenate + sort + neighbour dedup + compaction.

All ids stay int32.  The functions take any leading batch dimensions
where noted, so a per-predicate intersection is one call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SENTINEL = 2**31 - 1


class IdSet(NamedTuple):
    """Ascending ids in valid lanes; ``SENTINEL`` elsewhere."""

    ids: torch.Tensor  # int32[..., cap]
    valid: torch.Tensor  # bool[..., cap]
    count: torch.Tensor  # int32[...]
    overflow: torch.Tensor  # bool[...]


def intersect(a: IdSet, b: IdSet) -> IdSet:
    """A ∩ B, ascending, with A's capacity.  ``b`` may carry leading batch
    dimensions that ``a`` broadcasts against (one A against P rows)."""
    a_ids = a.ids.expand(*b.ids.shape[:-1], a.ids.shape[-1]).contiguous()
    a_valid = a.valid.expand(a_ids.shape)
    pos = torch.searchsorted(b.ids.contiguous(), a_ids)
    found = torch.gather(b.ids, -1, pos.clamp(max=b.ids.shape[-1] - 1)) == a_ids
    valid = a_valid & found
    ids = torch.where(valid, a_ids, SENTINEL).to(torch.int32)
    # valid lanes of A stay sorted; the sort sinks the sentinels to the tail
    ids = torch.sort(ids, dim=-1, stable=True).values
    valid = ids != SENTINEL
    return IdSet(
        ids, valid, valid.sum(dim=-1, dtype=torch.int32), a.overflow | b.overflow
    )


def union_rows(ids2d, valid2d, cap: int, overflow) -> IdSet:
    """Union of P sorted rows -> one sorted, deduplicated set of capacity
    ``cap``; ``overflow`` is or-ed with "more than ``cap`` unique ids"."""
    dev = ids2d.device
    flat = torch.where(valid2d, ids2d, SENTINEL).to(torch.int32).reshape(-1)
    flat = torch.sort(flat, stable=True).values
    n = flat.shape[0]
    first = torch.ones(1, dtype=torch.bool, device=dev)
    keep = (flat != SENTINEL) & torch.cat([first, flat[1:] != flat[:-1]])
    n_unique = keep.sum(dtype=torch.int32)
    # kept lanes go to the front in order; the rest land in one extra slot
    # that is cut off (the reference's scatter with mode="drop")
    idx = torch.cumsum(keep.to(torch.int32), 0) - 1
    tgt = torch.where(keep, idx, n).to(torch.int64)
    out = torch.full((n + 1,), SENTINEL, dtype=torch.int32, device=dev)
    out = out.scatter(0, tgt, flat)[:n]
    if n >= cap:
        out = out[:cap]
    else:
        pad = torch.full((cap - n,), SENTINEL, dtype=torch.int32, device=dev)
        out = torch.cat([out, pad])
    ovf = torch.as_tensor(overflow, device=dev).to(torch.bool) | (n_unique > cap)
    return IdSet(out, out != SENTINEL, n_unique.clamp(max=cap), ovf)



def from_result(ids, valid, count, overflow) -> IdSet:
    """An ``IdSet`` from a result-like tuple: invalid lanes to ``SENTINEL``."""
    dev = ids.device
    return IdSet(
        torch.where(valid, ids, SENTINEL).to(torch.int32), valid,
        torch.as_tensor(count, device=dev).to(torch.int32),
        torch.as_tensor(overflow, device=dev).to(torch.bool),
    )


def to_dense_mask(s: IdSet, extent: int) -> torch.Tensor:
    """bool[extent + 1] membership table (ids are 1-based; index 0 unused).
    Ids past ``extent`` are dropped; a negative id counts from the end of
    the ``extent + 2`` table before the cut, as the reference's scatter."""
    n = extent + 2
    idx = torch.where(s.valid, s.ids, extent + 1).to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    idx = idx[(idx >= 0) & (idx < n)]
    out = torch.zeros(n, dtype=torch.bool, device=s.ids.device)
    out[idx] = True
    return out[: extent + 1]
