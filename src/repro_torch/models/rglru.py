"""Griffin / RecurrentGemma recurrent block (RG-LRU) — arXiv:2402.19427.

Only the depthwise causal convolution is ported so far: the Mamba-2
mixer (``models/ssd.py``) runs it over its ``xBC`` stream. The RG-LRU
recurrence itself comes with the recurrentgemma slice (ROADMAP Queue 1
item 10).
"""
from __future__ import annotations

import torch


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  conv_state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,R), w: (d_conv,R).

    conv_state: (B, d_conv-1, R) previous tokens (decode) or None (train).
    Returns (y, new_state) where new_state holds the trailing d_conv-1
    tokens (a view of a new tensor, never of ``conv_state``).
    """
    d_conv = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], d_conv - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+d_conv-1, R)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(d_conv):                          # d_conv is tiny (4)
        y = y + xp[:, i: i + S] * w[i].to(x.dtype)
    return y, xp[:, -(d_conv - 1):]
