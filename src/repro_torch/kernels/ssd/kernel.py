"""Hopper kernel K5: the chunked SSD scan.

Binds ``csrc/ssd_scan.cu`` (the port of the TPU kernel
``repro/kernels/ssd/kernel.py::ssd_scan_fwd``): one block per (64 state
rows, head, batch) loops over the chunks with its state slab in shared
memory; the in-chunk decay is masked before ``exp``; products on CUDA
cores in fp32. Beyond the TPU kernel it takes an initial state and
returns the final one. It reads x ``(B, S, H, P)`` and B/C ``(B, S, N)``
in place, with any batch and position strides (the model passes slices
of one projection), and masks a ragged tail itself: no padding, no
copies. ``ref.ssd_chunked_ref`` is its plain version.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

MAX_CHUNK = 128
MAX_STATE = 256                   # N: the state slab's shared memory
DTYPES = (torch.float32, torch.bfloat16)
launches = 0                      # kernel launches since the last reset


def _require_rows(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: tuple, inner: tuple) -> None:
    """Like ``_cuda.require``, but only the dims after the first two
    must be dense: their strides must equal ``inner``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}; got "
                         f"{tuple(t.shape)}")
    if t.stride()[2:] != inner:
        raise ValueError(f"{name} must be dense past its position axis; "
                         f"got strides {t.stride()}")


def ssd_scan_cuda(xh: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor, chunk: int,
                  h0: torch.Tensor | None = None):
    """``(y (B, S, H, P), h_last (B, H, P, N))`` float32, as
    ``ref.ssd_chunked_ref``.

    ``xh`` ``(B, S, H, P)`` and ``b_mat``/``c_mat`` ``(B, S, N)``: CUDA
    tensors of one dtype (float32 or bfloat16), dense past the position
    axis. ``dt`` ``(B, S, H)``, ``a`` ``(H,)`` and ``h0`` ``(B, H, P, N)``
    (or None: zeros): contiguous float32. ``min(chunk, S) <= 128``,
    ``N <= 256``.
    """
    global launches
    if xh.dtype not in DTYPES:
        raise ValueError(f"xh must be float32 or bfloat16; got {xh.dtype}")
    if xh.dim() != 4:
        raise ValueError(f"xh must be (B, S, H, P); got {tuple(xh.shape)}")
    Bsz, S, H, P = xh.shape
    _require_rows(xh, "xh", xh.dtype, (Bsz, S, H, P), (P, 1))
    _require_rows(b_mat, "b_mat", xh.dtype, (Bsz, S, None), (1,))
    N = b_mat.shape[2]
    _require_rows(c_mat, "c_mat", xh.dtype, (Bsz, S, N), (1,))
    _cuda.require(dt, "dt", torch.float32, (Bsz, S, H))
    _cuda.require(a, "a", torch.float32, (H,))
    if h0 is not None:
        _cuda.require(h0, "h0", torch.float32, (Bsz, H, P, N))
    if any(t.device != xh.device for t in (b_mat, c_mat, dt, a)) or (
            h0 is not None and h0.device != xh.device):
        raise ValueError("all inputs must lie on one device")
    Q = min(int(chunk), S)
    if S and not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not supported; the kernel takes "
                         f"1..{MAX_CHUNK}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} not supported; the kernel takes "
                         f"1..{MAX_STATE}")
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=xh.device)
    if not (Bsz and S and H and P):
        h_last = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                              device=xh.device) if h0 is None else h0.clone())
        return y, h_last
    h_last = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                         device=xh.device)
    lib = _cuda.library()
    with torch.cuda.device(xh.device):
        rc = lib.repro_ssd_scan_fwd(
            xh.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(), dt.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), Bsz, S, H, P, N, Q,
            xh.stride(0), xh.stride(1), b_mat.stride(0), b_mat.stride(1),
            c_mat.stride(0), c_mat.stride(1), int(xh.dtype == torch.bfloat16),
            _cuda.stream_handle(xh))
    _cuda.check(rc, "ssd scan")
    launches += 1
    return y, h_last
