"""zamba2-7b [hybrid] — 81 Mamba2 blocks d3584, shared attention block
(32H on 2*d_model, kv=32) every 6 blocks with per-invocation LoRA,
d_ff=14336, vocab=32000, ssm_state=64 [arXiv:2411.15242]."""
from repro_torch.models.zamba2 import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, d_state=64, attn_every=6, lora_r=16,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "zamba2"
