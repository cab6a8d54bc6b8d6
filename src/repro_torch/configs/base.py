"""Arch/shape registry: the configurations the program builder knows.

A cell is arch × shape × mesh (``launch.programs.build``).  The registry
holds the paper's engine arch (``configs/k2triples.py``), the five
transformer LM archs with their shape table (:func:`lm_shapes`), the four
GNN archs (:func:`gnn_shapes`) and the recsys arch xDeepFM
(:func:`recsys_shapes`).
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


def gnn_shapes() -> tuple[ShapeSpec, ...]:
    """The 4 assigned graph shapes: cora, reddit (sampled 15-10 from 1,024
    seed nodes), ogbn-products (full batch) and batched molecules."""
    return (
        ShapeSpec(
            "full_graph_sm", "train",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
        ),
        ShapeSpec(
            "minibatch_lg", "train",
            dict(
                n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                batch_nodes=1024, fanouts=(15, 10), n_classes=41,
            ),
        ),
        ShapeSpec(
            "ogb_products", "train",
            dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47),
        ),
        ShapeSpec(
            "molecule", "train",
            dict(n_nodes=30, n_edges=64, batch=128),
        ),
    )


def recsys_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_batch", "train", dict(batch=65_536)),
        ShapeSpec("serve_p99", "forward", dict(batch=512)),
        ShapeSpec("serve_bulk", "forward", dict(batch=262_144)),
        ShapeSpec("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
    )
