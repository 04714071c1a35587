"""Plain PyTorch version of the flash-attention kernel."""
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, scale, causal=True, window=None, softcap=None, delta=0,
                        stats=False):
    """q: [BH, Sq, d]; k, v: [BH, Sk, d] -> [BH, Sq, d] at q's dtype: the JAX
    ``flash_attention_ref`` with the scores summed in f32 from the inputs as
    given (the TPU kernel's ``preferred_element_type=f32``; the JAX oracle
    rounds them to the input dtype first), f32 softmax and PV product.

    ``window`` and ``softcap`` follow the model's blockwise attention
    (``src/repro/models/attention.py`` ``_span_flash``/``_flash_update``):
    s = (q . k) scale, then s = softcap tanh(s / softcap), then key j is
    masked for query i unless j <= i + delta (causal) and i + delta - j <
    window.  ``delta`` is the position of query 0 minus that of key 0 (0:
    one span of both, Sq = Sk).

    With ``stats`` also each row's softmax statistics, [BH, Sq] f32 each: m,
    the max of the scaled, capped, masked scores, and l = sum exp(s - m)
    (the carries the reference's flash loop ends with).  A row that sees no
    key gives o = 0, m = -1e30 and l = 0."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(q.shape[1], device=q.device) + delta
    kpos = torch.arange(k.shape[1], device=q.device)
    keep = torch.ones((len(qpos), len(kpos)), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        keep &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~keep[None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    empty = ~keep.any(dim=-1)[None, :, None]
    l = e.sum(dim=-1, keepdim=True).masked_fill(empty, 0.0)
    out = torch.einsum("bqk,bkd->bqd", e / l.clamp_min(1e-30), v.float())
    out = out.masked_fill(empty, 0.0).to(q.dtype)
    return (out, m[..., 0], l[..., 0]) if stats else out
