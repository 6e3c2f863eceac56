"""Flash-attention dispatch: the Hopper kernel K4 for CUDA tensors, the
plain version for CPU tensors.

On a card the forward is always the kernel. Where an input needs a
gradient it runs inside :class:`FlashAttention`, the counterpart of the
reference package's ``custom_vjp``: the kernel forward saves q, k and v,
and the backward recomputes ``ref.attention_ref`` under autograd and
returns its gradients, as the reference's ``_bwd`` takes ``jax.vjp`` of
its oracle. On the CPU autograd differentiates the plain version
directly.

On DTensors (training on a mesh) the dispatch runs on each rank's
local part: the batch and the heads may stay split (column-parallel
``wq``/``wk``/``wv`` leave each rank its own heads), any other split is
gathered first (``_dtensor.local_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch import _dtensor
from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention import ref as _ref


# the dims of q, k, v and the output a rank may hold a part of
_SPLIT = {0: "batch", 2: "head"}


class FlashAttention(torch.autograd.Function):
    """K4 forward; backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _kernel.flash_attention_cuda(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) for t, w in zip(saved, want)]
            out = _ref.attention_ref(*ins, ctx.causal, ctx.window)
            got = torch.autograd.grad(
                out, [t for t, w in zip(ins, want) if w], g)
        # dense, as the forward's inputs are: a mesh's DTensors take the
        # local gradients to be laid out as their whole shape is
        it = iter(g.contiguous() for g in got)
        return (*(next(it) if w else None for w in want), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,K,D), H % K == 0 -> (B,S,H,D) in q's dtype.

    On a CUDA tensor this launches the kernel or raises, through
    :class:`FlashAttention` where a gradient is needed; on a CPU tensor
    it runs ``ref.attention_ref``. DTensors run on their local parts.
    """
    if _dtensor.is_dtensor(q):
        return _dtensor.local_kernel(
            lambda q, k, v: flash_attention(q, k, v, causal, window),
            (q, k, v), (_SPLIT,) * 3, _SPLIT)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window)
        return _kernel.flash_attention_cuda(q, k, v, causal, window)
    return _ref.attention_ref(q, k, v, causal, window)
