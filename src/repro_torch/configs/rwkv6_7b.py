"""rwkv6-7b [ssm] — 32L d4096 attention-free d_ff=14336 vocab=65536,
Finch data-dependent decay [arXiv:2404.05892]."""
from repro_torch.models.rwkv6 import RWKV6Config

CONFIG = RWKV6Config(
    name="rwkv6-7b",
    n_layers=32, d_model=4096, d_ff=14336, vocab=65536,
    head_size=64, lora_r=64, chunk=64,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)

FAMILY = "rwkv6"
