"""Hopper kernel K6: the RG-LRU linear scan.

Binds ``csrc/rglru_scan.cu``, the port of the TPU kernel
``repro/kernels/rglru/kernel.py::rglru_scan_fwd`` (kernel.py:69). It is
bound by bytes (a and b read, h written). A CTA takes one batch row and
:data:`CHANNELS` neighbouring channels and walks the time axis in
windows of :data:`WINDOW` steps, copied into a ring of shared-memory
stages by ``cp.async`` several windows ahead. Within a window each
thread takes :data:`CHUNK` steps of one channel: it forms its chunk's
``(prod a, scan from 0)``, one warp combines the chunks in order from
the carry, and each chunk rescans from the ``h`` that enters it and
writes ``h`` once. a and b ``(B, S, R)`` are read in place, float32 or
bfloat16; ragged S and R are masked in the kernel; h is float32.
``ref.rglru_scan_ref`` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

DTYPES = (torch.float32, torch.bfloat16)
CHANNELS = 32                     # channels a CTA (kC in rglru_scan.cu)
CHUNK = 8                         # steps a thread scans (kL)
WINDOW = 64                       # steps a window: 8 chunks (kW)
launches = 0                      # kernel launches since the last reset


def _check(a: torch.Tensor, b: torch.Tensor, h0) -> None:
    """Raise unless the kernel takes a, b and h0: their devices, dtypes,
    shapes and layouts."""
    if a.dtype not in DTYPES:
        raise ValueError(f"a must be float32 or bfloat16; got {a.dtype}")
    _cuda.require(a, "a", a.dtype, (None,) * 3)
    B, S, R = a.shape
    _cuda.require(b, "b", a.dtype, (B, S, R))
    if h0 is not None:
        _cuda.require(h0, "h0", torch.float32, (B, R))
    if b.device != a.device or (h0 is not None and h0.device != a.device):
        raise ValueError("a, b and h0 must lie on one device")


@torch.library.custom_op(
    "repro_torch::rglru_scan", mutates_args=(),
    schema="(Tensor a, Tensor b, Tensor? h0) -> Tensor")
def _rglru_scan(a, b, h0):
    """K6 as one operator, as the TPU kernel is one custom call in the
    reference's program: the kernel's launch on a card."""
    global launches
    _check(a, b, h0)
    B, S, R = a.shape
    out = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    if out.numel():
        lib = _cuda.library()
        with torch.cuda.device(a.device):
            rc = lib.repro_rglru_scan_fwd(
                a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), out.data_ptr(),
                B, S, R, int(a.dtype == torch.bfloat16),
                _cuda.stream_handle(a))
        _cuda.check(rc, "rglru scan")
        launches += 1
    return out


@_rglru_scan.register_fake
def _(a, b, h0):
    _check(a, b, h0)
    return a.new_empty(tuple(a.shape), dtype=torch.float32)


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h (B, S, R)`` float32, as ``ref.rglru_scan_ref``.

    ``a``, ``b`` ``(B, S, R)``: contiguous CUDA tensors of one dtype
    (float32 or bfloat16) on one device; ``h0`` ``(B, R)`` contiguous
    float32, or None (zeros). Runs as the operator
    ``torch.ops.repro_torch.rglru_scan``: one launch on a card, its
    output's shape alone on a fake tensor (a dry run).
    """
    return _rglru_scan(a, b, h0)
