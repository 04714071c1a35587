"""musicgen-medium [audio] — 48L d1536 24H (MHA kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens; codec frontend is a stub providing
precomputed frame embeddings [arXiv:2306.05284]."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, head_dim=64, act="gelu",
    frontend="audio",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"
