"""Hopper kernel K5: the chunked SSD scan.

Binds two sources, both ports of the TPU kernel
``repro/kernels/ssd/kernel.py::ssd_scan_fwd``; :func:`route` picks one
from the dtype, the shape and the strides:

* ``"tensor_cores"`` (``csrc/ssd_scan_tc.cu``), bfloat16 at head dim
  64, state size 64 or 128 and chunk 64 or 128, with x, B and C at
  16-byte aligned addresses and strides (every mamba2 model): three
  kernels, each over all chunks in parallel. Chunk states
  ``(x w)ᵀ·B`` on ``wgmma``, a float32 scan over the chunk states, then
  chunk outputs with ``C·Bᵀ`` formed once for a group of heads. The
  fp32 operands (``x w``, the scores, the carried state) go to the
  tensor cores as hi + lo bf16 pairs. B, C and x arrive by TMA;
* ``"cuda_cores"`` (``csrc/ssd_scan.cu``), every other input, float32
  among them: one block per (64 state rows, head, batch) loops over the
  chunks with its state slab in shared memory, fp32 products on CUDA
  cores. A float32 operand would need a three-way split on the tensor
  cores, and the float32 serving comparison must not move.

Both mask the in-chunk decay before ``exp``, take an initial state and
return the final one, and read x ``(B, S, H, P)`` and B/C ``(B, S, N)``
in place with any batch and position strides (the model passes slices
of one projection), masking a ragged tail themselves: no padding, no
copies. ``ref.ssd_chunked_ref`` is their plain version.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

MAX_CHUNK = 128
MAX_STATE = 256                   # N: the CUDA-core kernel's state slab
DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (64,)              # the tensor-core kernels', bf16 only
TC_STATES = (64, 128)
TC_CHUNKS = (64, 128)
ROUTES = ("tensor_cores", "cuda_cores")
launches = 0                      # scan calls (either route) since the last reset
launches_tc = 0                   # of them, on the tensor-core route


def tma_strides(xh: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor) -> tuple:
    """The byte addresses and the batch and position byte strides of x,
    B and C, each of which TMA needs at a multiple of 16. A batch of one
    has no batch stride to honour: it counts as S position strides."""
    out = []
    for t in (xh, b_mat, c_mat):
        size = t.element_size()
        sb = t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.stride(1)
        out += [t.data_ptr(), sb * size, t.stride(1) * size]
    return tuple(out)


def route(dtype: torch.dtype, P: int, N: int, chunk: int,
          strides: tuple) -> str:
    """The kernel that takes inputs of ``dtype`` at head dim ``P``, state
    size ``N`` and ``chunk``, with the byte addresses and strides
    ``strides`` (:func:`tma_strides`): ``"tensor_cores"`` or
    ``"cuda_cores"``."""
    if (dtype == torch.bfloat16 and P in TC_HEAD_DIMS and N in TC_STATES
            and chunk in TC_CHUNKS and all(s % 16 == 0 for s in strides)):
        return "tensor_cores"
    return "cuda_cores"


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


def _check(xh, b_mat, c_mat, dt, a, chunk: int, h0, route_to) -> None:
    """Raise unless the kernels take these inputs: their devices, dtypes,
    shapes and layouts (not their addresses)."""
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
    if route_to is not None and route_to not in ROUTES:
        raise ValueError(f"route_to must be one of {ROUTES}; got "
                         f"{route_to!r}")


def _choose(xh, b_mat, c_mat, chunk: int, route_to) -> str:
    """The route of a launch: :func:`route`'s, or ``route_to`` where it
    names one the inputs allow."""
    chosen = route(xh.dtype, xh.shape[3], b_mat.shape[2], int(chunk),
                   tma_strides(xh, b_mat, c_mat))
    if route_to is not None:
        if route_to == "tensor_cores" and chosen != route_to:
            raise ValueError(
                "the tensor-core kernel takes bfloat16 at head dim "
                f"{TC_HEAD_DIMS}, state {TC_STATES}, chunk {TC_CHUNKS} and "
                "16-byte aligned addresses and strides")
        chosen = route_to
    return chosen


@torch.library.custom_op(
    "repro_torch::ssd_scan", mutates_args=(),
    schema="(Tensor xh, Tensor b_mat, Tensor c_mat, Tensor dt, Tensor a, "
           "int chunk, Tensor? h0, str? route_to) -> (Tensor, Tensor)")
def _ssd_scan(xh, b_mat, c_mat, dt, a, chunk, h0, route_to):
    """K5 as one operator, as the TPU kernel is one custom call in the
    reference's program: the kernels' launches on a card."""
    global launches, launches_tc
    _check(xh, b_mat, c_mat, dt, a, chunk, h0, route_to)
    chosen = _choose(xh, b_mat, c_mat, chunk, route_to)
    Bsz, S, H, P = xh.shape
    N = b_mat.shape[2]
    Q = min(int(chunk), S)
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=xh.device)
    if not (Bsz and S and H and P):
        h_last = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                              device=xh.device) if h0 is None else h0.clone())
        return y, h_last
    h_last = torch.empty((Bsz, H, P, N), dtype=torch.float32,
                         device=xh.device)
    h0_ptr = None if h0 is None else h0.data_ptr()
    strides = (xh.stride(0), xh.stride(1), b_mat.stride(0), b_mat.stride(1),
               c_mat.stride(0), c_mat.stride(1))
    lib = _cuda.library()
    with torch.cuda.device(xh.device):
        if chosen == "tensor_cores":
            n_chunks = -(-S // int(chunk))
            states = torch.empty((Bsz, n_chunks, H, P, N),
                                 dtype=torch.float32, device=xh.device)
            cum = torch.empty((Bsz, n_chunks, H, int(chunk)),
                              dtype=torch.float32, device=xh.device)
            rc = lib.repro_ssd_scan_tc(
                xh.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                dt.data_ptr(), a.data_ptr(), h0_ptr, y.data_ptr(),
                h_last.data_ptr(), states.data_ptr(), cum.data_ptr(), Bsz,
                S, H, P, N, int(chunk), *strides, _cuda.stream_handle(xh))
        else:
            rc = lib.repro_ssd_scan_fwd(
                xh.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
                dt.data_ptr(), a.data_ptr(), h0_ptr, y.data_ptr(),
                h_last.data_ptr(), Bsz, S, H, P, N, Q, *strides,
                int(xh.dtype == torch.bfloat16), _cuda.stream_handle(xh))
    _cuda.check(rc, "ssd scan")
    launches += 1
    launches_tc += chosen == "tensor_cores"
    return y, h_last


@_ssd_scan.register_fake
def _(xh, b_mat, c_mat, dt, a, chunk, h0, route_to):
    _check(xh, b_mat, c_mat, dt, a, chunk, h0, route_to)
    Bsz, S, H, P = xh.shape
    N = b_mat.shape[2]
    return (xh.new_empty((Bsz, S, H, P), dtype=torch.float32),
            xh.new_empty((Bsz, H, P, N), dtype=torch.float32))


def ssd_scan_cuda(xh: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
                  dt: torch.Tensor, a: torch.Tensor, chunk: int,
                  h0: torch.Tensor | None = None, route_to: str | None = None):
    """``(y (B, S, H, P), h_last (B, H, P, N))`` float32, as
    ``ref.ssd_chunked_ref``.

    ``xh`` ``(B, S, H, P)`` and ``b_mat``/``c_mat`` ``(B, S, N)``: CUDA
    tensors of one dtype (float32 or bfloat16), dense past the position
    axis. ``dt`` ``(B, S, H)``, ``a`` ``(H,)`` and ``h0`` ``(B, H, P, N)``
    (or None: zeros): contiguous float32. ``min(chunk, S) <= 128``,
    ``N <= 256``. ``route_to`` names the kernel (:data:`ROUTES`); by
    default :func:`route` picks it. Asking for the tensor-core kernel on
    inputs it does not take raises. Runs as the operator
    ``torch.ops.repro_torch.ssd_scan``: the launches on a card, the
    outputs' shapes alone on a fake tensor (a dry run).
    """
    return _ssd_scan(xh, b_mat, c_mat, dt, a, int(chunk), h0, route_to)
