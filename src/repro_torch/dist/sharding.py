"""Logical-axis -> mesh-axis sharding rules, and tensors split over a mesh.

Models name the axes of their parameters and activations logically
(``transformer.logical_axes``: "embed", "heads", "batch", ...);
:func:`spec_for` turns a tuple of those names into a partition spec for a
concrete :class:`~repro_torch.launch.mesh.Mesh`, by the JAX package's rules
(``repro.dist.sharding``).  A spec is a tuple with one entry a dimension:
``None`` (replicated), one mesh axis name, or a tuple of them (the
dimension split over their product, the first axis major), the entries of
the JAX ``PartitionSpec`` for the same names.

Resolution per dimension:
  * ``None`` or an unknown name  -> replicated;
  * a rule value may be one mesh axis or a tuple (e.g. ("pod", "data"));
    axes absent from the mesh are dropped;
  * a mesh axis is used at most once per spec (first dimension wins);
  * if the dimension size does not divide the mapped axis product, the
    dimension falls back to replicated.

:func:`shard` splits a tensor by a spec into a :class:`Sharded`, one
tensor a mesh position; :func:`unshard` puts it back together.  On the
tensor's own device a part is a view (no bytes added); on another device
one copy a (device, block) is shared by the positions that name it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Default placement (the JAX package's): 'model' carries tensor, expert and
# vocab parallelism and the predicate arena; 'data' (+ 'pod') the batch.
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq_sp": "model",  # sequence-parallel residual stream (models/transformer_mesh.py)
    "kv_seq": None,
    # LM params
    "vocab": "model",
    "embed": None,
    "embed_out": None,
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "layers": None,
    # recsys params
    "fields": None,
    "rows": "model",
    # GNN batches
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    # engine
    "preds": "model",
}


def spec_for(mesh, names, shape=None, rules=None) -> tuple:
    """The partition spec of logical axis ``names`` of a ``shape`` on
    ``mesh`` (anything with a ``shape`` dict of axis sizes)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    used: set[str] = set()
    parts = []
    for i, nm in enumerate(names):
        rule = merged.get(nm) if nm is not None else None
        if rule is None:
            parts.append(None)
            continue
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        axes = tuple(a for a in axes if a in mesh.shape and a not in used)
        size = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if not axes or (shape is not None and shape[i] % size != 0):
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (``()`` for replicated)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def coords(mesh, pos: int) -> dict[str, int]:
    """{axis: index} of row-major mesh position ``pos``."""
    out = {}
    for a, n in zip(reversed(mesh.axis_names), reversed(mesh.sizes)):
        out[a] = pos % n
        pos //= n
    return out


def block_index(mesh, pos: int, axes) -> int:
    """Position ``pos``'s block along ``axes`` (row-major, the first axis
    major), 0 for no axes."""
    c, shape = coords(mesh, pos), mesh.shape
    idx = 0
    for a in axes:
        idx = idx * shape[a] + c[a]
    return idx


_BLOCKS: dict = {}


def _blocks(mesh, spec) -> list[tuple[int, ...]]:
    """Every position's block coordinates, one a dimension of ``spec``
    (made once a mesh and spec)."""
    key = (id(mesh), tuple(spec))
    got = _BLOCKS.get(key)
    if got is None or got[0] is not mesh:
        got = _BLOCKS[key] = (mesh, [tuple(block_index(mesh, pos, axes_of(e)) for e in spec)
                                     for pos in range(len(mesh.devices))])
    return got[1]


def _block_shape(shape, mesh, spec) -> list[int]:
    """The shape of one block of a global ``shape`` split by ``spec``."""
    if len(spec) != len(shape):
        raise ValueError(f"a spec of {len(spec)} entries for a rank-{len(shape)} tensor")
    sizes = []
    for n, e in zip(shape, spec):
        k = mesh.size(axes_of(e))
        if n % k:
            raise ValueError(f"dimension {n} does not split over {axes_of(e)} ({k})")
        sizes.append(n // k)
    return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor split over ``mesh`` by ``spec``: ``parts[i]`` is the block
    that mesh position ``i`` holds, on ``mesh.devices[i]``.  Positions that
    hold the same block on one device hold the same tensor object."""

    parts: tuple
    mesh: object
    spec: tuple

    def __post_init__(self):
        if len(self.parts) != len(self.mesh.devices):
            raise ValueError(f"{len(self.parts)} parts for {len(self.mesh.devices)} positions")
        if len(self.spec) != self.parts[0].dim():
            raise ValueError(f"a spec of {len(self.spec)} entries for rank {self.parts[0].dim()}")

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape."""
        return tuple(n * self.mesh.size(axes_of(e))
                     for n, e in zip(self.parts[0].shape, self.spec))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def unshard(self, device=None) -> torch.Tensor:
        return unshard(self, device)


def shard(t: torch.Tensor, mesh, spec) -> Sharded:
    """``t`` split by ``spec`` over ``mesh``: on ``t``'s device each part
    is a view; on another device one copy a (device, block)."""
    spec = tuple(spec)
    sizes = _block_shape(t.shape, mesh, spec)
    views: dict = {}
    copies: dict = {}
    parts = []
    for pos, blk in enumerate(_blocks(mesh, spec)):
        if blk not in views:
            v = t
            for d, (b, n) in enumerate(zip(blk, sizes)):
                if n != t.shape[d]:
                    v = v.narrow(d, b * n, n)
            views[blk] = v
        dev = mesh.devices[pos]
        if dev == t.device:
            parts.append(views[blk])
        else:
            if (dev, blk) not in copies:
                copies[dev, blk] = views[blk].to(dev)
            parts.append(copies[dev, blk])
    return Sharded(tuple(parts), mesh, spec)


def unshard(s: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``s`` on ``device`` (default the mesh's lead):
    each block copied once from the first position that holds it."""
    dev = s.mesh.lead if device is None else torch.device(device)
    out = torch.empty(s.shape, dtype=s.dtype, device=dev)
    done = set()
    for pos, blk in enumerate(_blocks(s.mesh, s.spec)):
        if blk in done:
            continue
        done.add(blk)
        part = s.parts[pos]
        v = out
        for d, b in enumerate(blk):
            n = part.shape[d]
            if n != out.shape[d]:
                v = v.narrow(d, b * n, n)
        v.copy_(part)
    return out


def empty(shape, dtype, mesh, spec) -> Sharded:
    """An uninitialised :class:`Sharded` of global ``shape``: one tensor a
    (device, block), shared by the positions that hold that block there."""
    sizes = _block_shape(shape, mesh, spec)
    made: dict = {}
    parts = []
    for pos, blk in enumerate(_blocks(mesh, spec)):
        key = (mesh.devices[pos], blk)
        if key not in made:
            made[key] = torch.empty(sizes, dtype=dtype, device=mesh.devices[pos])
        parts.append(made[key])
    return Sharded(tuple(parts), mesh, tuple(spec))


def zeros(shape, dtype, mesh, spec) -> Sharded:
    """:func:`empty`, zeroed."""
    s = empty(shape, dtype, mesh, spec)
    for p in distinct(s):
        p.zero_()
    return s


def distinct(s: Sharded) -> list[torch.Tensor]:
    """Each distinct tensor of ``s`` once, in position order: a block a
    device it lies on."""
    return list({id(p): p for p in s.parts}.values())


def holders(s: Sharded) -> dict[tuple, list[torch.Tensor]]:
    """{block coordinates: the distinct tensors holding that block}, both
    in position order: one a device that holds it."""
    out: dict = {}
    for pos, blk in enumerate(_blocks(s.mesh, s.spec)):
        out.setdefault(blk, {}).setdefault(id(s.parts[pos]), s.parts[pos])
    return {blk: list(ts.values()) for blk, ts in out.items()}


def positions_holding(s: Sharded) -> dict[tuple, tuple[int, ...]]:
    """{block coordinates: the mesh positions that hold that block}, in
    order, every position counted, on a repeated device too."""
    out: dict = {}
    for pos, blk in enumerate(_blocks(s.mesh, s.spec)):
        out.setdefault(blk, []).append(pos)
    return {blk: tuple(ps) for blk, ps in out.items()}


def map_distinct(fn, s: Sharded) -> Sharded:
    """``fn`` of each distinct tensor of ``s``, laid out as ``s`` (positions
    that shared a tensor share its result)."""
    made = {id(p): fn(p) for p in distinct(s)}
    return Sharded(tuple(made[id(p)] for p in s.parts), s.mesh, s.spec)
