"""qwen2-vl-2b [vlm] — 28L d1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE (t/h/w sections 16/24/24 of head_dim 128), dynamic-resolution ViT
frontend stubbed to precomputed patch embeddings [arXiv:2409.12191]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-vl-2b",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128, act="silu",
    rope_style="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    frontend="vision",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"
