"""Plain PyTorch RG-LRU scan: the oracle of the RG-LRU kernel."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t, step by step in float32.

    a, b: (B, S, R) of any float dtype; h0: (B, R) or None (zeros).
    Returns h (B, S, R) float32.
    """
    B, S, R = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros((B, R), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out
