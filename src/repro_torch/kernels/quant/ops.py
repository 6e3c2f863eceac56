"""int8 quantisation dispatch: the Hopper kernels K3 and K3' for CUDA
tensors, the plain versions for CPU tensors.

Forward only, as in the reference package (no ``custom_vjp`` there): a
CUDA input that needs a gradient raises rather than silently taking the
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import kernel as _kernel
from repro_torch.kernels.quant import ref as _ref
from repro_torch.kernels.quant.ref import DEFAULT_BLOCK


def quantize_int8(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """x: any shape -> (q (n_pad,) int8, scales (n_blocks,) float32).

    On a CUDA tensor this launches K3 or raises; on a CPU tensor it runs
    ``ref.quantize_int8_ref``.
    """
    if x.is_cuda:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "int8 quantisation has no backward; pass a tensor that "
                "does not require grad")
        return _kernel.quantize_int8_cuda(x, block)
    return _ref.quantize_int8_ref(x, block)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(n_pad,) float32; K3' on CUDA tensors, the plain version on CPU."""
    if q.is_cuda:
        return _kernel.dequantize_int8_cuda(q, scales, block)
    return _ref.dequantize_int8_ref(q, scales, block)


def roundtrip(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Quantise and dequantise, same shape and dtype back (the wire
    transform)."""
    q, s = quantize_int8(x, block)
    flat = dequantize_int8(q, s, block)
    return flat[: x.numel()].reshape(x.shape).to(x.dtype)
