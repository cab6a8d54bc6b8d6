"""tinyllama-1.1b — llama2-arch small, GQA kv=4. [arXiv:2401.02385; hf]"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerCfg

CFG = TransformerCfg(
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=5632, vocab=32_000,
)

SMOKE = TransformerCfg(
    name="tinyllama-1.1b-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=176, vocab=128, chunk_q=8, chunk_kv=16,
)

base.register(
    base.ArchSpec(
        arch_id="tinyllama-1.1b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=base.lm_shapes(),
        optimizer="adamw",
        source="arXiv:2401.02385; hf",
    )
)
