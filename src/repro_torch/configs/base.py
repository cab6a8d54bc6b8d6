"""Arch/shape registry: the configurations the program builder knows.

A cell is arch × shape × mesh (``launch.programs.build``).  The registry
holds the paper's engine arch (``configs/k2triples.py``); the seed's LM,
GNN and recsys families, their shape tables and the fields only they read
(an optimizer, a parameter dtype, sharding-rule overrides, skipped
shapes) are not ported yet.
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


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | engine
    cfg: Any  # full (paper-table) config
    smoke_cfg: Any  # reduced same-family config for CPU smoke tests
    shapes: tuple[ShapeSpec, ...]
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
