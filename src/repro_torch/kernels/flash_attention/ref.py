"""Plain PyTorch version of the flash-attention kernel."""
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale, causal=True, window=None, softcap=None,
                        stats=False):
    """q, k, v: [BH, S, d] -> [BH, S, d] at q's dtype: the JAX
    ``flash_attention_ref`` with the scores summed in f32 from the inputs as
    given (the TPU kernel's ``preferred_element_type=f32``; the JAX oracle
    rounds them to the input dtype first), f32 softmax and PV product.

    ``window`` and ``softcap`` follow the model's blockwise attention
    (``src/repro/models/attention.py`` ``_span_flash``/``_flash_update``):
    s = (q . k) scale, then s = softcap tanh(s / softcap), then key j is
    masked for query i unless j <= i (causal) and i - j < window.

    With ``stats`` also each row's softmax statistics, [BH, S] f32 each: m,
    the max of the scaled, capped, masked scores, and l = sum exp(s - m)
    (the carries the reference's flash loop ends with)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    sq = q.shape[1]
    pos = torch.arange(sq, device=q.device)
    keep = torch.ones((sq, sq), dtype=torch.bool, device=q.device)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window is not None:
        keep &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~keep[None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", e / l, v.float()).to(q.dtype)
    return (out, m[..., 0], l[..., 0]) if stats else out
