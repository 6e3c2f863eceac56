"""SSD scan dispatch: the Hopper kernel K5 for CUDA tensors, the chunked
plain version for CPU tensors.

Forward only. The reference package wraps its kernel in a
``custom_vjp`` whose backward runs through the plain recurrence; the
port's ``torch.autograd.Function`` counterpart comes with the training
path. Until then a CUDA input that needs a gradient raises rather than
silently taking the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref


def ssd_scan(xh: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor, chunk: int,
             h0: torch.Tensor | None = None):
    """xh (B,S,H,P), b_mat/c_mat (B,S,N), dt (B,S,H), a (H,), h0
    (B,H,P,N) or None -> (y (B,S,H,P), h_last (B,H,P,N)) in float32.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor
    it runs ``ref.ssd_chunked_ref``.
    """
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xh, b_mat, c_mat, dt, a, h0)):
            raise NotImplementedError(
                "the SSD scan backward is not ported yet (ROADMAP Queue 1 "
                "item 10: training); run under torch.no_grad() or "
                "torch.inference_mode()")
        return _kernel.ssd_scan_cuda(xh, b_mat, c_mat, dt, a, chunk, h0)
    return _ref.ssd_chunked_ref(xh, b_mat, c_mat, dt, a, chunk, h0)
