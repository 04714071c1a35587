"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
local(4096)/global alternating, logit softcap 30 / attn softcap 50,
post-norms, (1+w) RMSNorm, query_pre_attn_scalar=144 [arXiv:2408.00118]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab=256000, head_dim=128, act="gelu_tanh",
    window=4096, local_global_period=2,
    attn_softcap=50.0, logit_softcap=30.0,
    post_norms=True, norm_plus_one=True, embed_scale=True,
    query_scale=144.0 ** -0.5,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"

MICROBATCHES = 2  # gradient accumulation, as the reference's config sets it
