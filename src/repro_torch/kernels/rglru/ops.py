"""RG-LRU scan dispatch: the Hopper kernel K6 for CUDA tensors, the plain
version for CPU tensors.

On a card the forward is always the kernel. Where an input needs a
gradient it runs inside :class:`RGLRUScan`, the counterpart of the
reference package's ``custom_vjp``: the kernel forward saves ``a``,
``b`` and ``h0``, and the backward recomputes ``ref.rglru_scan_ref``
under autograd and returns its gradients. On the CPU autograd
differentiates the plain version directly. DTensors (training on a
mesh) run on each rank's local part, the batch and the channels split at
most (``_dtensor.local_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch import _dtensor
from repro_torch.kernels.rglru import kernel as _kernel
from repro_torch.kernels.rglru import ref as _ref


class RGLRUScan(torch.autograd.Function):
    """K6 forward; backward through the plain scan."""

    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _kernel.rglru_scan_cuda(a, b, h0)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(saved, want)]
            out = _ref.rglru_scan_ref(*ins)
            got = torch.autograd.grad(
                out, [t for t, w in zip(ins, want) if w], g)
        # dense, as a mesh's DTensors take the local gradients to be
        it = iter(g.contiguous() for g in got)
        return tuple(next(it) if w else None for w in want)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B,S,R); h0: (B,R) or None -> h (B,S,R) float32.

    On a CUDA tensor this launches the kernel or raises, through
    :class:`RGLRUScan` where a gradient is needed; on a CPU tensor it
    runs ``ref.rglru_scan_ref``. DTensors run on their local parts.
    """
    if _dtensor.is_dtensor(a):
        bsr = {0: "batch", 2: "channel"}
        return _dtensor.local_kernel(
            rglru_scan, (a, b, h0),
            (bsr, bsr, {0: "batch", 1: "channel"}), bsr)
    if a.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (a, b, h0)):
            return RGLRUScan.apply(a, b, h0)
        return _kernel.rglru_scan_cuda(a, b, h0)
    return _ref.rglru_scan_ref(a, b, h0)
