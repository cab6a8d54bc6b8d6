"""mace — higher-order equivariant message passing. [arXiv:2206.07697; paper]"""

from repro_torch.configs import base
from repro_torch.models.gnn.mace import MACECfg

CFG = MACECfg(
    name="mace", n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8
)
SMOKE = MACECfg(
    name="mace-smoke", n_layers=2, d_hidden=8, l_max=2, correlation=3, n_rbf=4
)

base.register(
    base.ArchSpec(
        arch_id="mace", family="gnn", cfg=CFG, smoke_cfg=SMOKE,
        shapes=base.gnn_shapes(), source="arXiv:2206.07697; paper",
    )
)
