"""Flash-attention dispatch: the Hopper kernel K4 for CUDA tensors, the
plain version for CPU tensors.

Forward only. The reference package wraps its kernel in a
``custom_vjp`` whose backward recomputes through the plain version; the
port's ``torch.autograd.Function`` counterpart comes with the training
path. Until then a CUDA input that needs a gradient raises rather than
silently taking the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B,S,H,D); k,v: (B,T,K,D), H % K == 0 -> (B,S,H,D) in q's dtype.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor
    it runs ``ref.attention_ref``.
    """
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "the flash-attention backward is not ported yet (ROADMAP "
                "Queue 1 item 10: training); run under torch.no_grad() or "
                "torch.inference_mode()")
        return _kernel.flash_attention_cuda(q, k, v, causal, window)
    return _ref.attention_ref(q, k, v, causal, window)
