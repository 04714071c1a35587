"""chatglm3-6b [dense] — 28L d4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
2D RoPE (rotary on half the head dim, GLM convention) [arXiv:2406.12793]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="chatglm3-6b",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, rope_style="2d", act="silu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"
