"""Plain PyTorch blockwise int8 quantisation: the oracle of K3 and K3'.

The same function as the reference package's ``kernels/quant/ref.py``:
the flat input in float32, zero-padded to whole blocks; per block
``scale = amax / 127`` (1 for an all-zero block) and
``q = clip(round(x / scale), -127, 127)``, rounding half to even.

Both divisions divide by a tensor of the divisor's full shape. PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which rounds
apart from ``amax / 127`` on about one value in twenty; dividing by a
tensor is the IEEE division on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DEFAULT_BLOCK = 4096


def block_size(block: int, n: int) -> int:
    """The block the functions use: ``min(block, max(n, 1))``."""
    if block < 1:
        raise ValueError(f"block must be at least 1; got {block}")
    return min(block, max(n, 1))


def quantize_int8_ref(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """x: any shape, any float dtype -> (q (n_pad,) int8, scales
    (n_blocks,) float32), ``n_pad = ceil(n / block) * block``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    block = block_size(block, n)
    n_pad = -(-n // block) * block
    blocks = F.pad(flat, (0, n_pad - n)).view(-1, block)
    amax = blocks.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                         torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.reshape(-1).to(torch.int8), scales


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """q (n_pad,) int8, scales (n_blocks,) -> (n_pad,) float32."""
    block = block_size(block, q.numel())
    blocks = q.reshape(-1, block).float()
    return (blocks * scales[:, None]).reshape(-1)


def roundtrip_ref(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Quantise and dequantise: float32 of ``x``'s shape."""
    q, s = quantize_int8_ref(x, block)
    return dequantize_int8_ref(q, s, block)[: x.numel()].reshape(x.shape)
