"""Plain PyTorch attention: the oracle of the flash-attention kernel."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window=None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,K,D), H % K == 0 -> (B,S,H,D). fp32 softmax.

    Query head ``h`` reads kv head ``h // (H // K)``; the result is in
    q's dtype.
    """
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
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
