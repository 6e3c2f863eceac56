"""Plain PyTorch SSD scans: the oracles of the SSD kernel.

``ssd_scan_ref`` is the token-by-token recurrence (slow, exact);
``ssd_chunked_ref`` the chunked algorithm the model runs, with an
initial state, the final state and ragged lengths. Both compute in
float32.

Inside a chunk the decay ``exp(cum_t - cum_s)`` is formed only where
``s <= t``: the exponent is masked before ``exp``. Above the diagonal it
is positive and, once a chunk's summed ``dt * |a|`` passes about 88.7,
``exp`` overflows; the reference package's ``models/ssd.py`` multiplies
that ``inf`` by a zero mask and returns NaN there, while its Pallas
kernel masks as here (ROADMAP caveat C5).
"""
from __future__ import annotations

import torch


def ssd_scan_ref(xh, b_mat, c_mat, dt, a, h0=None):
    """Sequential SSM recurrence.

    h_t = exp(dt_t * a) h_{t-1} + dt_t * (x_t B_t^T);  y_t = C_t . h_t

    xh (B, S, H, P), b_mat/c_mat (B, S, N), dt (B, S, H), a (H,),
    h0 (B, H, P, N) or None. Returns (y (B, S, H, P), h_last) in float32.
    """
    Bsz, S, H, P = xh.shape
    N = b_mat.shape[-1]
    xf, bf, cf = xh.float(), b_mat.float(), c_mat.float()
    dt, a = dt.float(), a.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * a[None, :])                  # (B, H)
        inc = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bf[:, t], xf[:, t])
        h = h * da[..., None, None] + inc
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, H, P), dtype=torch.float32, device=xh.device))
    return y, h


def ssd_chunked_ref(xh, b_mat, c_mat, dt, a, chunk: int, h0=None):
    """Chunked SSD scan, the algorithm of the model's ``ssd_chunked``.

    xh:    (B, S, H, P)   per-head inputs
    b_mat: (B, S, N)      input projection (one group, shared by heads)
    c_mat: (B, S, N)      output projection
    dt:    (B, S, H)      positive step sizes (post-softplus)
    a:     (H,)           negative decay rates (A = -exp(a_log))
    h0:    (B, H, P, N)   initial state or None
    Returns (y (B, S, H, P), h_last (B, H, P, N)) in float32. A ragged
    tail is padded with ``dt = 0`` steps, which keep the state.
    """
    Bsz, S, H, P = xh.shape
    N = b_mat.shape[-1]
    dev = xh.device
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    if S == 0:
        return torch.zeros((Bsz, 0, H, P), dtype=torch.float32,
                           device=dev), h
    Q = min(chunk, S)
    pad = -S % Q
    xf = torch.nn.functional.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    bf = torch.nn.functional.pad(b_mat.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(c_mat.float(), (0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    nc = (S + pad) // Q

    xf = xf.reshape(Bsz, nc, Q, H, P)
    bf = bf.reshape(Bsz, nc, Q, N)
    cf = cf.reshape(Bsz, nc, Q, N)
    dt = dt.reshape(Bsz, nc, Q, H)

    cum = torch.cumsum(dt * a.float()[None, None, None, :], dim=2)
    seg_total = cum[:, :, -1:, :]                        # (B, nc, 1, H)

    # intra-chunk: L[t, s] = exp(cum_t - cum_s) for s <= t, else 0, the
    # exponent masked before exp (C5)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    L = rel.masked_fill(~tri[None, None, :, :, None], float("-inf")).exp()
    cb = torch.einsum("bcqn,bcsn->bcqs", cf, bf)         # (B, nc, Q, Q)
    xdt = xf * dt[..., None]                             # (B, nc, Q, H, P)
    y = torch.einsum("bcqsh,bcshp->bcqhp", cb[..., None] * L, xdt)

    # per-chunk end states, then the recurrence over chunks
    decay_to_end = torch.exp(seg_total - cum)            # (B, nc, Q, H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_to_end, bf, xdt)
    seg_decay = torch.exp(seg_total[:, :, 0, :])         # (B, nc, H)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * seg_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # (B, nc, H, P, N)

    # inter-chunk contribution: exp(cum_t) C_t . h_prev
    y = y + torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, h_prev, torch.exp(cum))
    return y.reshape(Bsz, nc * Q, H, P)[:, :S], h
