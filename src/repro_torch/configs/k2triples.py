"""k2triples — the paper's engine as an arch: a predicate-sharded k²-tree
forest serving SPARQL pattern batches over a serve mesh."""

import dataclasses

from repro_torch.configs import base


@dataclasses.dataclass(frozen=True)
class K2TriplesEngineCfg:
    name: str = "k2triples"
    # dbpedia-scale synthetic store (Table 1 ratios; preds padded to mesh)
    n_triples: int = 1_000_000
    n_subjects: int = 80_000
    n_preds: int = 512
    n_objects: int = 280_000
    cap: int = 1024  # per-scan result capacity


CFG = K2TriplesEngineCfg()
SMOKE = K2TriplesEngineCfg(
    name="k2triples-smoke", n_triples=3000, n_subjects=120, n_preds=16,
    n_objects=150, cap=256,
)

base.register(
    base.ArchSpec(
        arch_id="k2triples",
        family="engine",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=(
            base.ShapeSpec("serve_64k", "serve", dict(batch=65_536)),
            base.ShapeSpec("unbounded_4k", "serve", dict(batch=4096, unbounded=1)),
        ),
        source="this paper",
    )
)
