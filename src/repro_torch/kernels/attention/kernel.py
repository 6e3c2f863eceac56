"""Hopper kernel K4, the flash-attention forward, and the backward from
its log-sum-exp.

Binds ``csrc/flash_attn.cu`` (the port of the TPU kernel
``repro/kernels/attention/kernel.py::flash_attention_fwd``), which holds
two kernels; :func:`route` picks one from the dtype and head dim:

* ``"tensor_cores"``, bfloat16 at head dims 64, 128 and 256 (every
  served model): one warpgroup per (64 query rows, head, batch), S = Q·Kᵀ
  and O += P·V on ``wgmma`` with fp32 accumulators, P rounded to bf16
  in registers, K and V tiles through TMA into a two-stage ring on
  ``mbarrier``s, the output stored through TMA;
* ``"cuda_cores"``, float32 at every head dim and bfloat16 at 16 and 32
  (test shapes only): one block per (64 query rows, head, batch), fp32
  products on CUDA cores. Tensor cores would mean TF32 for float32
  inputs, about three decimal digits: that fails K4's 2e-5 float32
  tolerance and the serving paths' float32 logit gates.

Both loop over the live band of key tiles with an online softmax, and
read q ``(B, S, H, D)`` and k/v ``(B, T, K, D)`` in place: no padding,
no transposes. ``ref.attention_ref`` is their plain version.

A query row with no live key (only possible with a window and
S >= T + window) is written as 0, the TPU kernel's
``l == 0`` guard; the plain version, like the reference package's,
averages v uniformly there. No path of the port makes such rows: the
prefill has S == T, so every row sees at least its own key.

:func:`flash_attention_lse_cuda` is the same launch that also writes each
row's log-sum-exp, ``(B, H, S)`` float32, and
:func:`flash_attention_bwd_cuda` binds ``csrc/flash_attn_bwd.cu``, the
port of the reference's XLA backward ``repro/models/flash_xla.py::_vjp_bwd``:
dq, dk and dv from (q, k, v, out, lse) and the upstream gradient in
float32 on CUDA cores, three launches a call (delta, dK/dV, dQ), no
atomics. A query row with no live key has no log-sum-exp to
differentiate from; the dispatch (``ops.check_live_rows``) refuses such
shapes on either device before they reach these wrappers.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)     # the tensor-core kernel's, bf16 only
DTYPES = (torch.float32, torch.bfloat16)
launches = 0                      # launches of either kernel since the last reset
launches_tc = 0                   # of them, the tensor-core kernel's
bwd_launches = 0                  # launches of the backward's kernels
BWD_LAUNCHES_A_CALL = 3           # delta, dK/dV, dQ


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes inputs of ``dtype`` at ``head_dim``:
    ``"tensor_cores"`` or ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window) -> None:
    """Raise unless the kernel takes q, k, v and ``window``: their
    devices, dtypes, shapes and layouts (not their addresses)."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    _cuda.require(q, "q", q.dtype, (None,) * 4)
    B, S, H, D = q.shape
    _cuda.require(k, "k", q.dtype, (B, None, None, D))
    T, K = k.shape[1], k.shape[2]
    _cuda.require(v, "v", q.dtype, (B, T, K, D))
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; the kernel takes "
                         f"{HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1; got {window}")
    if route(q.dtype, D) == "tensor_cores" and T == 0:
        raise ValueError("the tensor-core kernel needs at least one key")


def _forward(q, k, v, causal, window, lse) -> torch.Tensor:
    """One K4 launch into a new output (and ``lse`` where given)."""
    global launches, launches_tc
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    tensor_cores = route(q.dtype, D) == "tensor_cores"
    out = torch.empty_like(q)
    if tensor_cores and any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("the tensor-core kernel's TMA copies need "
                         "16-byte aligned q, k and v")
    if out.numel():
        lib = _cuda.library()
        with torch.cuda.device(q.device):
            rc = lib.repro_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, S, T, H, K, D, int(causal),
                0 if window is None else int(window), D ** -0.5,
                int(q.dtype == torch.bfloat16), int(tensor_cores),
                _cuda.stream_handle(q))
        _cuda.check(rc, "flash attention")
        launches += 1
        launches_tc += tensor_cores
    return out


@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window) "
           "-> Tensor")
def _flash_attention(q, k, v, causal, window):
    """K4 as one operator, as the TPU kernel is one custom call in the
    reference's program: the kernel's launch on a card."""
    _check(q, k, v, window)
    return _forward(q, k, v, causal, window, None)


@_flash_attention.register_fake
def _(q, k, v, causal, window):
    _check(q, k, v, window)
    return torch.empty_like(q)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window=None) -> torch.Tensor:
    """Attention ``(B, S, H, D)`` in q's dtype, as ``ref.attention_ref``.

    ``q`` ``(B, S, H, D)``, ``k``/``v`` ``(B, T, K, D)`` with
    ``H % K == 0``: contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device, ``D`` in ``HEAD_DIMS``. ``window`` is None
    or a positive number of keys (``q_pos - k_pos < window``). Runs as
    the operator ``torch.ops.repro_torch.flash_attention``: one launch
    on a card, its output's shape alone on a fake tensor (a dry run).
    """
    return _flash_attention(q, k, v, bool(causal),
                            None if window is None else int(window))


@torch.library.custom_op(
    "repro_torch::flash_attention_lse", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window) "
           "-> (Tensor, Tensor)")
def _flash_attention_lse(q, k, v, causal, window):
    """K4 with its log-sum-exp: one launch, counted as K4's."""
    _check(q, k, v, window)
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, lse), lse


@_flash_attention_lse.register_fake
def _(q, k, v, causal, window):
    _check(q, k, v, window)
    B, S, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, S), dtype=torch.float32))


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window=None):
    """(out, lse): :func:`flash_attention_cuda`'s output, bit for bit, and
    each query row's log-sum-exp of its masked, scaled scores, ``(B, H,
    S)`` float32 (natural log), as ``ref.flash_attention_lse_ref``. One
    launch of K4 (``torch.ops.repro_torch.flash_attention_lse``). A row
    with no live key has no log-sum-exp: its lse is not defined."""
    return _flash_attention_lse(q, k, v, bool(causal),
                                None if window is None else int(window))


def _check_bwd(q, k, v, out, lse, g, window) -> None:
    _check(q, k, v, window)
    B, S, H, D = q.shape
    _cuda.require(out, "out", q.dtype, (B, S, H, D))
    _cuda.require(g, "g", q.dtype, (B, S, H, D))
    _cuda.require(lse, "lse", torch.float32, (B, H, S))
    if any(t.device != q.device for t in (out, lse, g)):
        raise ValueError("q, out, lse and g must lie on one device")


@torch.library.custom_op(
    "repro_torch::flash_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor g, bool causal, int? window) -> (Tensor, Tensor, Tensor)")
def _flash_attention_bwd(q, k, v, out, lse, g, causal, window):
    """The backward as one operator: three launches on a card."""
    global bwd_launches
    _check_bwd(q, k, v, out, lse, g, window)
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B and S and H:
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        lib = _cuda.library()
        with torch.cuda.device(q.device):
            rc = lib.repro_flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), g.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, S, T, H, K, D, int(causal),
                0 if window is None else int(window), D ** -0.5,
                int(q.dtype == torch.bfloat16), _cuda.stream_handle(q))
        _cuda.check(rc, "flash attention backward")
        bwd_launches += BWD_LAUNCHES_A_CALL
    else:                         # no query: no gradient reaches k or v
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


@_flash_attention_bwd.register_fake
def _(q, k, v, out, lse, g, causal, window):
    _check_bwd(q, k, v, out, lse, g, window)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor,
                             causal: bool = True, window=None):
    """(dq, dk, dv) in the inputs' dtype, as ``ref.flash_attention_bwd_ref``.

    ``out`` and ``lse`` are :func:`flash_attention_lse_cuda`'s on the same
    (q, k, v, causal, window); ``g`` ``(B, S, H, D)`` the upstream
    gradient, contiguous, in q's dtype. Runs as the operator
    ``torch.ops.repro_torch.flash_attention_bwd``: on a card one call of
    ``csrc/flash_attn_bwd.cu`` (``BWD_LAUNCHES_A_CALL`` launches, each
    counted in ``bwd_launches``), the same inputs giving the same bits;
    its outputs' shapes alone on a fake tensor. Every query row must keep
    a live key (``ops.check_live_rows``)."""
    return _flash_attention_bwd(q, k, v, out, lse, g, bool(causal),
                                None if window is None else int(window))
