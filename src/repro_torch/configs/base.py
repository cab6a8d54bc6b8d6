"""Arch/shape registry: the configurations the program builder knows.

A cell is arch × shape × mesh (``launch.programs.build``).  The registry
holds the paper's engine arch (``configs/k2triples.py``) and the five
transformer LM archs with their shape table (:func:`lm_shapes`); the GNN
and recsys families and their shape tables are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

ARCHS: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (a cell is arch × shape × mesh)."""

    shape_id: str
    kind: str  # train | prefill | decode | forward | retrieval | serve
    dims: dict[str, int]  # family-specific sizes
    rules_override: dict[str, Any] = dataclasses.field(default_factory=dict)
    skip: str | None = None  # reason if inapplicable (recorded, not silently)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | engine
    cfg: Any  # full (paper-table) config
    smoke_cfg: Any  # reduced same-family config for CPU smoke tests
    shapes: tuple[ShapeSpec, ...]
    optimizer: str = "adamw"  # adamw | adafactor (large-model memory)
    param_dtype: str = "float32"  # float32 | bfloat16 (1T-class)
    source: str = ""

    def shape(self, shape_id: str) -> ShapeSpec:
        for s in self.shapes:
            if s.shape_id == shape_id:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {shape_id!r}")


def register(spec: ArchSpec) -> ArchSpec:
    ARCHS[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    return ARCHS[arch_id]


# ---------------------------------------------------------------------------
# family-level shape tables (each arch file instantiates these)
# ---------------------------------------------------------------------------


def lm_shapes(*, sub_quadratic: bool = False) -> tuple[ShapeSpec, ...]:
    """The 4 assigned LM shapes.  ``long_500k`` is a decode step against a
    512k KV cache (linear in S), which every arch supports; 500k prefill is
    not an assigned shape.  ``rules_override`` names the sharding rules the
    JAX package's sharded programs use; the port runs a cell on one device
    and keeps them as data."""
    return (
        ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
        ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
        ShapeSpec(
            "decode_32k", "decode", dict(seq_len=32768, global_batch=128),
            rules_override={"kv_seq": "model"},
        ),
        ShapeSpec(
            "long_500k", "decode", dict(seq_len=524288, global_batch=1),
            rules_override={"batch": None, "kv_seq": ("pod", "data", "model")},
        ),
    )
