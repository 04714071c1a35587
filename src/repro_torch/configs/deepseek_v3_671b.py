"""deepseek-v3-671b [moe] — 61L d7168, MLA (128H, q_lora 1536, kv_lora 512,
nope 128 / rope 64 / v 128), MoE 256 routed top-8 + 1 shared expert
(d_ff 2048 each), first 3 layers dense (d_ff 18432), vocab 129280
[arXiv:2412.19437].  Optimizer: Adafactor (factored state), as the
reference's config sets it."""
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab=129280, act="silu",
    attn_type="mla",
    mla=MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                  kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_model=7168, d_ff=2048,
                  n_shared_experts=1, capacity_factor=1.25,
                  norm_topk_prob=True, router_scale=2.5),
    dense_prefix=3,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "transformer"
OPTIMIZER = "adafactor"

MICROBATCHES = 4  # gradient accumulation, as the reference's config sets it
