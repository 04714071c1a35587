"""dbrx-132b [moe] — 40L d6144 48H (GQA kv=8), fine-grained MoE 16 experts
top-4 (d_ff 10752), vocab=100352 [hf:databricks/dbrx-base]."""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, act="silu",
    moe=MoEConfig(n_experts=16, top_k=4, d_model=6144, d_ff=10752,
                  capacity_factor=1.25, norm_topk_prob=True),
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"
OPTIMIZER = "adafactor"
MICROBATCHES = 2  # gradient accumulation, as the reference's config sets it
