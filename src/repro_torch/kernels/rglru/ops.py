"""RG-LRU scan dispatch: the Hopper kernel K6 for CUDA tensors, the plain
version for CPU tensors.

Forward only. The reference package wraps its kernel in a
``custom_vjp`` whose backward recomputes through the plain scan; the
port's ``torch.autograd.Function`` counterpart comes with the training
path. Until then a CUDA input that needs a gradient raises rather than
silently taking the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru import kernel as _kernel
from repro_torch.kernels.rglru import ref as _ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B,S,R); h0: (B,R) or None -> h (B,S,R) float32.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor
    it runs ``ref.rglru_scan_ref``.
    """
    if a.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (a, b, h0)):
            raise NotImplementedError(
                "the RG-LRU scan backward is not ported yet (ROADMAP Queue "
                "1 item 10: training); run under torch.no_grad() or "
                "torch.inference_mode()")
        return _kernel.rglru_scan_cuda(a, b, h0)
    return _ref.rglru_scan_ref(a, b, h0)
