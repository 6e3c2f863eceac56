"""SSD scan dispatch: the Hopper kernel K5 for CUDA tensors, the chunked
plain version for CPU tensors.

On a card the forward is always the kernel. Where an input needs a
gradient it runs inside :class:`SSDScan`, the counterpart of the
reference package's ``custom_vjp``: the kernel forward saves its inputs,
and the backward recomputes ``ref.ssd_chunked_ref`` (which masks before
``exp``, caveat C5) under autograd and returns the gradients of both
outputs, ``y`` and ``h_last``, for every tensor input, ``h0`` included
(the reference's kernel takes no ``h0``). On the CPU autograd
differentiates the plain version directly. DTensors (training on a
mesh) run on each rank's local part, the batch and the heads split at
most (``_dtensor.local_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch import _dtensor
from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref


class SSDScan(torch.autograd.Function):
    """K5 forward; backward through the plain chunked version."""

    @staticmethod
    def forward(ctx, xh, b_mat, c_mat, dt, a, chunk, h0):
        ctx.save_for_backward(xh, b_mat, c_mat, dt, a, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _kernel.ssd_scan_cuda(xh, b_mat, c_mat, dt, a, chunk, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        xh, b_mat, c_mat, dt, a, h0 = ctx.saved_tensors
        saved = (xh, b_mat, c_mat, dt, a, h0)
        need = ctx.needs_input_grad
        want = (*need[:5], need[6])
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(saved, want)]
            y, h_last = _ref.ssd_chunked_ref(*ins[:5], ctx.chunk, ins[5])
            outs = [(o, g) for o, g in ((y, gy), (h_last, gh))
                    if g is not None]
            got = torch.autograd.grad(
                [o for o, _ in outs],
                [t for t, w in zip(ins, want) if w],
                [g for _, g in outs], allow_unused=True)
        # dense, as a mesh's DTensors take the local gradients to be
        it = iter(None if g is None else g.contiguous() for g in got)
        grads = [next(it) if w else None for w in want]
        return (*grads[:5], None, grads[5])


def ssd_scan(xh: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor, chunk: int,
             h0: torch.Tensor | None = None):
    """xh (B,S,H,P), b_mat/c_mat (B,S,N), dt (B,S,H), a (H,), h0
    (B,H,P,N) or None -> (y (B,S,H,P), h_last (B,H,P,N)) in float32.

    On a CUDA tensor this launches the kernel or raises, through
    :class:`SSDScan` where a gradient is needed; on a CPU tensor it runs
    ``ref.ssd_chunked_ref``. DTensors run on their local parts.
    """
    if _dtensor.is_dtensor(xh):
        bh, b = {0: "batch", 2: "head"}, {0: "batch"}
        return _dtensor.local_kernel(
            lambda *t: ssd_scan(*t[:5], chunk, t[5]),
            (xh, b_mat, c_mat, dt, a, h0),
            (bh, b, b, bh, {0: "head"}, {0: "batch", 1: "head"}),
            (bh, {0: "batch", 1: "head"}))
    if xh.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xh, b_mat, c_mat, dt, a, h0)):
            return SSDScan.apply(xh, b_mat, c_mat, dt, a, chunk, h0)
        return _kernel.ssd_scan_cuda(xh, b_mat, c_mat, dt, a, chunk, h0)
    return _ref.ssd_chunked_ref(xh, b_mat, c_mat, dt, a, chunk, h0)
