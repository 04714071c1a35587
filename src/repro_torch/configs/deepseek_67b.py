"""deepseek-67b [dense] — 95L d8192 64H (GQA kv=8) d_ff=22016 vocab=102400,
llama architecture [arXiv:2401.02954]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-67b",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400, head_dim=128, act="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"

MICROBATCHES = 4  # gradient accumulation, as the reference's config sets it
