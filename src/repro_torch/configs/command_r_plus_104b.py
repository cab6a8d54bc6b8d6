"""command-r-plus-104b — dense GQA, no-bias, parallel residual.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerCfg

CFG = TransformerCfg(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab=256_000,
    parallel_residual=True,  # Cohere parallel attn/ffn block
    rope_theta=75_000_000.0,
)

SMOKE = TransformerCfg(
    name="command-r-plus-104b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=128, parallel_residual=True, chunk_q=8, chunk_kv=16,
)

base.register(
    base.ArchSpec(
        arch_id="command-r-plus-104b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=base.lm_shapes(),
        optimizer="adafactor",  # AdamW's f32 state is 12 bytes a parameter
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )
)
