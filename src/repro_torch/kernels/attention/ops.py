"""Flash-attention dispatch: the Hopper kernels for CUDA tensors, the
plain versions for CPU tensors.

Two routes, the reference package's two:

* :func:`flash_attention`, its ``"pallas"`` route. On a card the forward
  is always K4. Where an input needs a gradient it runs inside
  :class:`FlashAttention`, the counterpart of the reference's
  ``kernels/attention`` ``custom_vjp``: the kernel forward saves q, k and
  v, and the backward recomputes ``ref.attention_ref`` under autograd and
  returns its gradients, as the reference's ``_bwd`` takes ``jax.vjp`` of
  its oracle. On the CPU autograd differentiates the plain version
  directly.
* :class:`FlashAttentionLSE`, the training half of its ``"chunked"``
  route (``models/flash_xla.py``, the reference's memory-linear
  ``custom_vjp``): the forward :func:`flash_attention_lse` (K4 writing
  each row's log-sum-exp) saves (q, k, v, out, lse), and the backward
  :func:`flash_attention_bwd` computes dq, dk and dv from them in one
  call of the hand-written backward, with no S x T matrix in device
  memory. On the CPU the same Function runs the plain versions of both.

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
SPLIT = {0: "batch", 2: "head"}


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


class FlashAttentionLSE(torch.autograd.Function):
    """K4 forward with its log-sum-exp; backward from it by the
    hand-written kernel (plain versions of both on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_lse(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                    ctx.causal, ctx.window)
        want = ctx.needs_input_grad[:3]
        return (*(d if w else None for d, w in zip(grads, want)), None,
                None)


def check_live_rows(S: int, T: int, window) -> None:
    """Raise where a query row keeps no live key, which has no
    log-sum-exp: with no key at all, or with a window and ``S >= T +
    window`` (causal or not, row ``i`` sees keys from ``i - window +
    1``)."""
    if T == 0 or (window is not None and S >= T + int(window)):
        raise ValueError(f"a query row keeps no live key (S {S}, T {T}, "
                         f"window {window}): it has no log-sum-exp")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None):
    """(out, lse): attention ``(B, S, H, D)`` in q's dtype and each query
    row's log-sum-exp ``(B, H, S)`` float32. On a CUDA tensor one launch
    of K4 or a raise; on a CPU tensor ``ref.flash_attention_lse_ref``.
    Raises on shapes where a query row keeps no live key
    (:func:`check_live_rows`), on either device."""
    check_live_rows(q.shape[1], k.shape[1], window)
    if q.is_cuda:
        return _kernel.flash_attention_lse_cuda(q, k, v, causal, window)
    return _ref.flash_attention_lse_ref(q, k, v, causal, window)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, causal: bool = True, window=None):
    """(dq, dk, dv) from :func:`flash_attention_lse`'s ``out`` and ``lse``
    and the upstream gradient ``g``. On a CUDA tensor one call of the
    hand-written backward or a raise; on a CPU tensor
    ``ref.flash_attention_bwd_ref``."""
    if q.is_cuda:
        return _kernel.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal,
                                                window)
    return _ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal, window)


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
            (q, k, v), (SPLIT,) * 3, SPLIT)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window)
        return _kernel.flash_attention_cuda(q, k, v, causal, window)
    return _ref.attention_ref(q, k, v, causal, window)
