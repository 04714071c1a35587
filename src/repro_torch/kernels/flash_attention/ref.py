"""Plain PyTorch version of the flash-attention kernel."""
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale, causal=True):
    """q, k, v: [BH, S, d] -> [BH, S, d] at q's dtype: the JAX
    ``flash_attention_ref`` with the scores summed in f32 from the inputs as
    given (the TPU kernel's ``preferred_element_type=f32``; the JAX oracle
    rounds them to the input dtype first), f32 softmax and PV product."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq = q.shape[1]
        mask = torch.tril(torch.ones((sq, sq), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~mask[None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
