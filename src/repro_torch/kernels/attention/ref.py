"""Plain PyTorch attention: the oracles of the flash-attention kernels.

:func:`attention_ref` is K4's (the forward); :func:`flash_attention_lse_ref`
and :func:`flash_attention_bwd_ref` are those of the reference's
memory-linear route (``models/flash_xla.py``): the forward with its
log-sum-exp, and the backward from it in closed form over the whole
S x T matrix, which is the reference's ``_vjp_bwd`` without its tiles.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window) -> torch.Tensor:
    """The scaled float32 scores ``(B, K, G, S, T)``, masked to
    ``NEG_INF``."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores * (D ** -0.5)
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = kj <= qi
    if window is not None:
        mask = mask & ((qi - kj) < window)
    return torch.where(mask, scores, NEG_INF)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window=None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,K,D), H % K == 0 -> (B,S,H,D). fp32 softmax.

    Query head ``h`` reads kv head ``h // (H // K)``; the result is in
    q's dtype.
    """
    B, S, H, D = q.shape
    w = torch.softmax(_scores(q, k, causal, window), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window=None):
    """(out, lse): out is :func:`attention_ref`'s, bit for bit; lse
    ``(B, H, S)`` float32 is the log-sum-exp of the same masked, scaled
    scores (the reference's ``(B, K, G, S)``, head ``h = k G + g``)."""
    B, S, H, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1)
    return attention_ref(q, k, v, causal, window), lse.reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, g: torch.Tensor,
                            causal: bool = True, window=None):
    """(dq, dk, dv) of attention at (q, k, v) against the upstream
    gradient ``g`` of its output ``out``, from the forward's ``lse``
    ``(B, H, S)``: ``P = exp(S scale - lse)`` (0 where masked),
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - rowsum(dO O))
    scale``, ``dQ = dS K``, ``dK = dS^T Q``, in float32, each gradient in
    its input's dtype."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, D).float()
    gf = g.reshape(B, S, K, G, D).float()
    of = out.reshape(B, S, K, G, D).float()
    kf, vf = k.float(), v.float()
    lse = lse.reshape(B, K, G, S, 1)
    p = torch.exp(_scores(q, k, causal, window) - lse)   # (B, K, G, S, T)
    delta = (gf * of).sum(-1).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bkgst,bskgd->btkd", p, gf)
    dp = torch.einsum("bskgd,btkd->bkgst", gf, vf)
    ds = p * (dp - delta) * (D ** -0.5)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(B, S, H, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
