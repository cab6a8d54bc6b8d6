"""egnn — E(n)-equivariant GNN. [arXiv:2102.09844; paper]"""

from repro_torch.configs import base
from repro_torch.models.gnn.egnn import EGNNCfg

CFG = EGNNCfg(name="egnn", n_layers=4, d_hidden=64)
SMOKE = EGNNCfg(name="egnn-smoke", n_layers=2, d_hidden=16)

base.register(
    base.ArchSpec(
        arch_id="egnn", family="gnn", cfg=CFG, smoke_cfg=SMOKE,
        shapes=base.gnn_shapes(), source="arXiv:2102.09844; paper",
    )
)
