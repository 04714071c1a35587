"""Plain PyTorch versions of the WKV6 kernel."""
import torch


def wkv6_ref(r, k, v, lw, u):
    """r, k, v, lw: [BH, T, N] (lw = log decay); u: [BH, 1, N] -> o [BH, T, N]
    f32: the per-step scan of the JAX ``wkv6_ref``, from a zero state."""
    w = lw.float().exp()
    r, k, v = r.float(), k.float(), v.float()
    bh, t, n = r.shape
    S = torch.zeros((bh, n, n), dtype=torch.float32, device=r.device)
    uu = u[:, 0, :, None].float()
    outs = []
    for i in range(t):
        kv = k[:, i, :, None] * v[:, i, None, :]
        outs.append(torch.einsum("bn,bnm->bm", r[:, i], S + uu * kv))
        S = w[:, i, :, None] * S + kv
    return torch.stack(outs, dim=1)


def wkv6_chunked(r, k, v, w, u, state, chunk: int):
    """The chunked form of the JAX ``models/rwkv6.py::wkv6_chunked``.

    r, k, v, w: [B, T, H, N] f32 (w = per-channel decay in (0, 1)); u: [H, N];
    state: [B, H, N, N] carry.  Returns (o [B, T, H, N], state').  Each chunk's
    pairwise decay tensor [B, c, c, H, N] lives only while its chunk runs."""
    B, T, H, N = r.shape
    c = min(chunk, T)
    if c < 1 or T % c:
        raise ValueError(f"wkv6: T={T} must be a multiple of the chunk {c}")
    lw = torch.log(torch.clamp(w, 1e-8, 1.0))
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for c0 in range(0, T, c):
        rr, kk, vv, ll = (a[:, c0:c0 + c] for a in (r, k, v, lw))
        lc = torch.cumsum(ll, dim=1)                   # inclusive cumulative log-decay
        lc_tm1 = lc - ll                               # cumulative up to t-1
        dec = torch.exp(torch.clamp(lc_tm1[:, :, None] - lc[:, None, :], -60.0, 0.0))
        dec = dec * tri[None, :, :, None, None]        # s < t only
        att = torch.einsum("bthn,btshn,bshn->btsh", rr, dec, kk)
        del dec
        o = torch.einsum("btsh,bshn->bthn", att, vv)
        o = o + (rr * u[None, None] * kk).sum(-1, keepdim=True) * vv     # bonus, s == t
        rdec = rr * torch.exp(torch.clamp(lc_tm1, -60.0, 0.0))
        o = o + torch.einsum("bthn,bhnm->bthm", rdec, state)             # carried state
        lc_end = lc[:, -1]
        kdec = kk * torch.exp(torch.clamp(lc_end[:, None] - lc, -60.0, 0.0))
        state = (torch.exp(torch.clamp(lc_end, -60.0, 0.0))[..., None] * state
                 + torch.einsum("bshn,bshm->bhnm", kdec, vv))
        outs.append(o)
    return torch.cat(outs, dim=1), state
