"""Hopper kernels K3 and K3': blockwise symmetric int8 quantisation and
its inverse.

Binds ``csrc/quant_int8.cu``, the port of the TPU kernels
``repro/kernels/quant/kernel.py::quantize_int8_fwd`` and
``::dequantize_int8_fwd``. K3 reads float32 or bfloat16 in place: a block
of at most :data:`TILE` elements is one CTA in one pass; a larger block
spreads over CTAs of :data:`TILE` elements, which reduce ``|x|`` into a
per-block word by ``atomicMax`` before a second pass writes ``q``. K3'
multiplies back, four int8 a load. ``ref.quantize_int8_ref`` and
``ref.dequantize_int8_ref`` are their plain versions, equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda
from repro_torch.kernels.quant.ref import DEFAULT_BLOCK, block_size

DTYPES = (torch.float32, torch.bfloat16)
TILE = 4096                     # elements a CTA (kTile in quant_int8.cu)
quantize_launches = 0           # K3 launches since the last reset
dequantize_launches = 0         # K3' launches since the last reset


def quantize_int8_cuda(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """``(q (n_pad,) int8, scales (n_blocks,) float32)`` of the contiguous
    CUDA tensor ``x`` (float32 or bfloat16, any shape), as
    ``ref.quantize_int8_ref``."""
    global quantize_launches
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    _cuda.require(x, "x", x.dtype, (None,) * x.dim())
    n = x.numel()
    block = block_size(block, n)
    n_blocks = -(-n // block)
    q = torch.empty(n_blocks * block, dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    if n:
        bits = (torch.empty(n_blocks, dtype=torch.int32, device=x.device)
                if block > TILE else None)
        lib = _cuda.library()
        with torch.cuda.device(x.device):
            rc = lib.repro_quant_int8_fwd(
                x.data_ptr(), n, block, int(x.dtype == torch.bfloat16),
                q.data_ptr(), scales.data_ptr(),
                None if bits is None else bits.data_ptr(),
                _cuda.stream_handle(x))
        _cuda.check(rc, "int8 quantise")
        quantize_launches += 1
    return q, scales


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``(n_pad,)`` float32 of ``q (n_pad,)`` int8 and ``scales
    (n_pad / block,)`` float32, contiguous CUDA tensors on one device, as
    ``ref.dequantize_int8_ref``."""
    global dequantize_launches
    _cuda.require(q, "q", torch.int8, (None,))
    n_pad = q.numel()
    block = block_size(block, n_pad)
    if n_pad % block:
        raise ValueError(f"q's {n_pad} elements are not whole blocks of "
                         f"{block}")
    _cuda.require(scales, "scales", torch.float32, (n_pad // block,))
    if scales.device != q.device:
        raise ValueError("q and scales must lie on one device")
    out = torch.empty(n_pad, dtype=torch.float32, device=q.device)
    if n_pad:
        lib = _cuda.library()
        with torch.cuda.device(q.device):
            rc = lib.repro_dequant_int8_fwd(
                q.data_ptr(), scales.data_ptr(), n_pad, block,
                out.data_ptr(), _cuda.stream_handle(q))
        _cuda.check(rc, "int8 dequantise")
        dequantize_launches += 1
    return out
