"""phi3-medium-14b [dense] — 40L d5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE + SwiGLU [arXiv:2404.14219]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
    vocab=100352, head_dim=128, act="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"

MICROBATCHES = 2  # gradient accumulation, as the reference's config sets it
