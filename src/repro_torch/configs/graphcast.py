"""graphcast — encoder-processor-decoder mesh GNN. [arXiv:2212.12794; unverified]"""

from repro_torch.configs import base
from repro_torch.models.gnn.graphcast import GraphCastCfg

CFG = GraphCastCfg(
    name="graphcast", n_layers=16, d_hidden=512, mesh_refinement=6,
    in_dim=227, out_dim=227, edge_dim=4,
)
SMOKE = GraphCastCfg(
    name="graphcast-smoke", n_layers=2, d_hidden=32, in_dim=16, out_dim=7, edge_dim=4
)

base.register(
    base.ArchSpec(
        arch_id="graphcast", family="gnn", cfg=CFG, smoke_cfg=SMOKE,
        shapes=base.gnn_shapes(), source="arXiv:2212.12794; unverified",
    )
)
