"""Hopper kernels K3 and K3': blockwise symmetric int8 quantisation and
its inverse.

Binds ``csrc/quant_int8.cu``, the port of the TPU kernels
``repro/kernels/quant/kernel.py::quantize_int8_fwd`` (kernel.py:46) and
``::dequantize_int8_fwd`` (kernel.py:69). Both are bound by bytes. K3
is one kernel launch at every block size and reads float32 or bfloat16
in place. A block of at most :data:`TILE` elements is one CTA in one
pass. A larger block (the FL round's leaves, one block each) is one
cooperative launch of one CTA an SM: each CTA copies its share of x into
shared memory by TMA, writes its partial ``max |x|`` to a scratch slot,
waits at a grid-wide barrier, and writes ``q`` from shared memory, so x
is read once while the card holds it (30.5 MB on an H100; past that each
CTA reads the rest of its share twice). K3' multiplies back, four int8 a
load. ``ref.quantize_int8_ref`` and ``ref.dequantize_int8_ref`` are
their plain versions, equal bit for bit.

The scratch of the large-block launch (one uint32 slot for each pair of
CTA and block that meet) needs no initial value and keeps nothing
between launches. The wrapper keeps one buffer for each device and
stream, grown when a call needs more, so a call allocates nothing but
its outputs, and launches on two streams never share a buffer.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import _cuda
from repro_torch.kernels.quant.ref import DEFAULT_BLOCK, block_size

DTYPES = (torch.float32, torch.bfloat16)
TILE = 4096                     # elements a CTA (kTile in quant_int8.cu)
quantize_launches = 0           # K3 launches since the last reset
dequantize_launches = 0         # K3' launches since the last reset
_scratch: dict = {}             # (device index, stream) -> uint32 slots


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _partials(x: torch.Tensor, stream: int, n_blocks: int) -> torch.Tensor:
    """The large-block launch's scratch on ``x``'s device and ``stream``:
    at least the SM count + ``n_blocks`` words."""
    dev = x.device
    key = (dev.index, stream)
    words = _sm_count(dev.index) + n_blocks
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = _scratch[key] = torch.empty(words, dtype=torch.int32,
                                          device=dev)
    return buf


def _check_quantize(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    _cuda.require(x, "x", x.dtype, (None,) * x.dim())


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor,
                      block: int) -> int:
    """Raise unless K3' takes q and scales; returns the block it uses."""
    _cuda.require(q, "q", torch.int8, (None,))
    n_pad = q.numel()
    block = block_size(block, n_pad)
    if n_pad % block:
        raise ValueError(f"q's {n_pad} elements are not whole blocks of "
                         f"{block}")
    _cuda.require(scales, "scales", torch.float32, (n_pad // block,))
    if scales.device != q.device:
        raise ValueError("q and scales must lie on one device")
    return block


@torch.library.custom_op(
    "repro_torch::quantize_int8", mutates_args=(),
    schema="(Tensor x, int block) -> (Tensor, Tensor)")
def _quantize_int8(x, block):
    """K3 as one operator, as the TPU kernel is one custom call in the
    reference's program: the kernel's launch on a card."""
    global quantize_launches
    _check_quantize(x)
    n = x.numel()
    block = block_size(block, n)
    n_blocks = -(-n // block)
    q = torch.empty(n_blocks * block, dtype=torch.int8, device=x.device)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    if n:
        lib = _cuda.library()
        stream = _cuda.stream_handle(x)
        with torch.cuda.device(x.device):
            slots = _partials(x, stream, n_blocks) if block > TILE else None
            rc = lib.repro_quant_int8_fwd(
                x.data_ptr(), n, block, int(x.dtype == torch.bfloat16),
                q.data_ptr(), scales.data_ptr(),
                None if slots is None else slots.data_ptr(),
                0 if slots is None else slots.numel(), stream)
        _cuda.check(rc, "int8 quantise")
        quantize_launches += 1
    return q, scales


@_quantize_int8.register_fake
def _(x, block):
    _check_quantize(x)
    block = block_size(block, x.numel())
    n_blocks = -(-x.numel() // block)
    return (x.new_empty(n_blocks * block, dtype=torch.int8),
            x.new_empty(n_blocks, dtype=torch.float32))


@torch.library.custom_op(
    "repro_torch::dequantize_int8", mutates_args=(),
    schema="(Tensor q, Tensor scales, int block) -> Tensor")
def _dequantize_int8(q, scales, block):
    """K3' as one operator: the kernel's launch on a card."""
    global dequantize_launches
    block = _check_dequantize(q, scales, block)
    n_pad = q.numel()
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


@_dequantize_int8.register_fake
def _(q, scales, block):
    _check_dequantize(q, scales, block)
    return q.new_empty(q.numel(), dtype=torch.float32)


def quantize_int8_cuda(x: torch.Tensor, block: int = DEFAULT_BLOCK):
    """``(q (n_pad,) int8, scales (n_blocks,) float32)`` of the contiguous
    CUDA tensor ``x`` (float32 or bfloat16, any shape), as
    ``ref.quantize_int8_ref``: one kernel launch. A block past
    :data:`TILE` elements uses the scratch kept for this device and the
    current stream. Runs as the operator
    ``torch.ops.repro_torch.quantize_int8``; on a fake tensor (a dry run)
    it gives the outputs' shapes alone."""
    return _quantize_int8(x, int(block))


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``(n_pad,)`` float32 of ``q (n_pad,)`` int8 and ``scales
    (n_pad / block,)`` float32, contiguous CUDA tensors on one device, as
    ``ref.dequantize_int8_ref``. Runs as the operator
    ``torch.ops.repro_torch.dequantize_int8``."""
    return _dequantize_int8(q, scales, int(block))
