"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8.
[arXiv:2501.kimi2; unverified]

bf16 parameters and Adafactor's factored state: AdamW's f32 state would
be 12 bytes a parameter, 12 TB at this size.
"""

from repro_torch.configs import base
from repro_torch.models.transformer import MoECfg, TransformerCfg

CFG = TransformerCfg(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
    d_ff=2048,  # per-expert ff
    vocab=163_840,
    moe=MoECfg(n_experts=384, top_k=8, d_ff_expert=2048, capacity_factor=1.25),
)

SMOKE = TransformerCfg(
    name="kimi-k2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=32, vocab=128, chunk_q=8, chunk_kv=16,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32),
)

base.register(
    base.ArchSpec(
        arch_id="kimi-k2-1t-a32b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=base.lm_shapes(),
        optimizer="adafactor",
        param_dtype="bfloat16",
        source="arXiv:2501.kimi2; unverified",
    )
)
