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


SUB = 8    # sub-chunk length of the kernel's factored decay (kWkvSub in csrc/wkv6.cu)


def wkv6_factored(r, k, v, w, u, state, chunk: int):
    """:func:`wkv6_chunked` with the pairwise decay factored as the CUDA
    kernel factors it: for t in sub-chunk j and s in an earlier sub-chunk
    j' (sub-chunks of SUB steps, b = SUB j, e = SUB j' + SUB - 1),

        exp(lc[t-1] - lc[s]) = exp(lc[t-1] - lc[b-1]) exp(lc[b-1] - lc[e])
                               exp(lc[e] - lc[s]),

    each factor clipped to [-60, 0] on its own; pairs inside one sub-chunk
    keep the reference's single exponential.  Where no factor's clip binds
    the two forms agree exactly; elsewhere a term differs by at most
    e^-60 |r k|.  Same arguments and results as :func:`wkv6_chunked`."""
    B, T, H, N = r.shape
    c = min(chunk, T)
    if c < 1 or T % c:
        raise ValueError(f"wkv6: T={T} must be a multiple of the chunk {c}")
    lw = torch.log(torch.clamp(w, 1e-8, 1.0))
    dec = lambda a: torch.exp(torch.clamp(a, -60.0, 0.0))
    idx = torch.arange(c, device=r.device)
    sub = idx // SUB
    same = (sub[:, None] == sub[None, :]) & (idx[None, :] < idx[:, None])     # [t, s]
    cross = sub[None, :] < sub[:, None]
    first = sub * SUB                                    # b: the start of t's sub-chunk
    last = torch.clamp(sub * SUB + SUB - 1, max=c - 1)   # e: the end of s's sub-chunk
    outs = []
    for c0 in range(0, T, c):
        rr, kk, vv, ll = (a[:, c0:c0 + c] for a in (r, k, v, lw))
        lc = torch.cumsum(ll, dim=1)
        lc_tm1 = lc - ll
        zero = torch.zeros_like(lc[:, :1])
        lc_bm1 = torch.cat([zero, lc], dim=1)[:, first]  # lc[b - 1], 0 before the chunk
        inside = dec(lc_tm1[:, :, None] - lc[:, None, :]) * same[None, :, :, None, None]
        att = torch.einsum("bthn,btshn,bshn->btsh", rr, inside, kk)
        r1 = rr * dec(lc_tm1 - lc_bm1)                    # exp(lc[t-1] - lc[b-1])
        k1 = kk * dec(lc[:, last] - lc)                   # exp(lc[e] - lc[s])
        mid = dec(lc_bm1[:, :, None] - lc[:, last][:, None, :]) * cross[None, :, :, None, None]
        att = att + torch.einsum("bthn,btshn,bshn->btsh", r1, mid, k1)
        o = torch.einsum("btsh,bshn->bthn", att, vv)
        o = o + (rr * u[None, None] * kk).sum(-1, keepdim=True) * vv     # bonus, s == t
        o = o + torch.einsum("bthn,bhnm->bthm", rr * dec(lc_tm1), state)
        lc_end = lc[:, -1]
        kdec = kk * dec(lc_end[:, None] - lc)
        state = dec(lc_end)[..., None] * state + torch.einsum("bshn,bshm->bhnm", kdec, vv)
        outs.append(o)
    return torch.cat(outs, dim=1), state
