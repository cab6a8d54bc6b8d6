"""gemma2-27b — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""

from repro_torch.configs import base
from repro_torch.models.transformer import TransformerCfg

CFG = TransformerCfg(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256_000,
    window=4096, local_every=2,  # alternating local(4096)/global
    attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True,  # gemma ties in/out embeddings
)

SMOKE = TransformerCfg(
    name="gemma2-27b-smoke",
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=4, d_head=8,
    d_ff=192, vocab=128, window=16, local_every=2,
    attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    chunk_q=8, chunk_kv=16,
)

base.register(
    base.ArchSpec(
        arch_id="gemma2-27b",
        family="lm",
        cfg=CFG,
        smoke_cfg=SMOKE,
        shapes=base.lm_shapes(),
        optimizer="adamw",
        source="arXiv:2408.00118; hf",
    )
)
