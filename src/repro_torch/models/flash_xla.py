"""Memory-linear flash attention: the route of ``attn_impl="chunked"``.

The counterpart of the reference package's ``models/flash_xla.py``, a
``custom_vjp`` whose forward returns the output with each query row's
log-sum-exp and whose backward recomputes ``P = exp(S scale - lse)`` a
tile pair at a time, so that no S x T matrix lives in memory. Here the
forward is the Hopper kernel K4 writing the log-sum-exp and the backward
the hand-written kernel ``csrc/flash_attn_bwd.cu``, both through
``kernels.attention.ops.FlashAttentionLSE``; on the CPU the same Function
runs their plain versions.

Where no input needs a gradient (serving's prefill), the call is K4 as
the ``"pallas"`` route runs it, with no log-sum-exp written (the plain
``attention_ref`` on the CPU): the same bits as before this route had a
backward of its own.

The reference's ``block_q`` and ``block_k`` set only the tiles of its
XLA scans, and no caller passes them (``models/attention.py``'s
``_attend_full``); the kernels tile for the card themselves, so they are
not taken.

A query row with no live key (only with a window and ``S >= T +
window``, or with no key) has no log-sum-exp: where the Function would
run, the call raises on such shapes (``ops.check_live_rows``)
instead of defining a gradient there. The reference averages v over
such a row; no path of the port makes one (training has S == T).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _dtensor
from repro_torch.kernels.attention import ops as flash_ops


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,K,D), H % K == 0 -> (B,S,H,D) in q's dtype.

    With a gradient to take, through ``FlashAttentionLSE`` (on a CUDA
    tensor the kernels launch or the call raises); without, through
    ``flash_ops.flash_attention``. DTensors (training on a mesh) run the
    whole call on each rank's local part, the batch and the heads split
    at most (``_dtensor.local_kernel``), so the saved log-sum-exp is each
    rank's own (batch, head) part of it.
    """
    if _dtensor.is_dtensor(q):
        return _dtensor.local_kernel(
            lambda q, k, v: flash_attention_xla(q, k, v, causal, window),
            (q, k, v), (flash_ops.SPLIT,) * 3, flash_ops.SPLIT)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_ops.FlashAttentionLSE.apply(q, k, v, causal, window)
    return flash_ops.flash_attention(q, k, v, causal, window)
