"""xdeepfm — CIN + DNN CTR model. [arXiv:1803.05170; paper]"""

from repro_torch.configs import base
from repro_torch.models.recsys.xdeepfm import XDeepFMCfg

CFG = XDeepFMCfg(
    name="xdeepfm", n_fields=39, embed_dim=10, rows_per_field=1_000_000,
    cin_layers=(200, 200, 200), mlp_dims=(400, 400),
)
SMOKE = XDeepFMCfg(
    name="xdeepfm-smoke", n_fields=8, embed_dim=6, rows_per_field=1000,
    cin_layers=(16, 16), mlp_dims=(32, 32),
)

base.register(
    base.ArchSpec(
        arch_id="xdeepfm", family="recsys", cfg=CFG, smoke_cfg=SMOKE,
        shapes=base.recsys_shapes(), source="arXiv:1803.05170; paper",
    )
)
