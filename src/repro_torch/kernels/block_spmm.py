"""Tile masks for ``ops.block_spmm`` from one level of a k²-tree.

The upper levels of a k²-tree are a hierarchical occupancy bitmap of the
adjacency matrix: a 0 at level ℓ certifies an empty ``(side/side_ℓ)²``
region.  ``mask_from_k2_level`` re-tiles one such level to the kernel's
``(block, block)`` tiles, so that ``block_spmm`` skips the tiles the tree
proves empty.
"""

from __future__ import annotations

import torch


def mask_from_k2_level(level_bits_dense: torch.Tensor, side: int, block: int) -> torch.Tensor:
    """Re-tile a level's dense ``(side_l, side_l)`` 0/1 occupancy (each cell
    certifies a ``(side/side_l)²`` region) to an int32 tile mask of
    ``(side/block, side/block)``: a tile is on iff a covering region is on.

    Exact when ``block`` divides the region size; conservative (never
    falsely empty) otherwise.  Raises where the square does not cut into
    whole tiles (the reshape of the OR-reduce), as the JAX helper does.
    """
    side_l = level_bits_dense.shape[0]
    region = side // side_l
    nb = side // block
    if region >= block:
        rep = region // block
        m = level_bits_dense.repeat_interleave(rep, dim=0).repeat_interleave(rep, dim=1)
        return m.to(torch.int32)
    g = block // region  # region < block: OR-reduce g x g regions into a tile
    return level_bits_dense.reshape(nb, g, nb, g).amax(dim=(1, 3)).to(torch.int32)
