"""olmoe-1b-7b — 64 experts top-8 MoE. [arXiv:2409.02060; hf]"""

from repro_torch.configs import base
from repro_torch.models.transformer import MoECfg, TransformerCfg

CFG = TransformerCfg(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024,  # per-expert ff
    vocab=50_304,
    moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024, capacity_factor=1.25),
)

SMOKE = TransformerCfg(
    name="olmoe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=32, vocab=128, chunk_q=8, chunk_kv=16,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32),
)

base.register(
    base.ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=base.lm_shapes(),
        optimizer="adamw",
        source="arXiv:2409.02060; hf",
    )
)
