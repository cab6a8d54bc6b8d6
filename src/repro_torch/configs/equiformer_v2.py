"""equiformer-v2 — SO(2)/eSCN equivariant graph attention.
[arXiv:2306.12059; unverified]"""

from repro_torch.configs import base
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Cfg

CFG = EquiformerV2Cfg(
    name="equiformer-v2", n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8
)
SMOKE = EquiformerV2Cfg(
    name="equiformer-v2-smoke", n_layers=2, d_hidden=8, l_max=3, m_max=2, n_heads=2, n_rbf=4
)

base.register(
    base.ArchSpec(
        arch_id="equiformer-v2", family="gnn", cfg=CFG, smoke_cfg=SMOKE,
        shapes=base.gnn_shapes(), source="arXiv:2306.12059; unverified",
    )
)
