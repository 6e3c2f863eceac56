"""Hopper kernel K4: the flash-attention forward.

Binds ``csrc/flash_attn.cu`` (the port of the TPU kernel
``repro/kernels/attention/kernel.py::flash_attention_fwd``): one block per
(64 query rows, head, batch), a loop over the live band of 32-key tiles,
online softmax with fp32 accumulators, products on CUDA cores. It reads
q ``(B, S, H, D)`` and k/v ``(B, T, K, D)`` in place: no padding, no
transposes. ``ref.attention_ref`` is its plain version.

A query row with no live key (only possible with a window and
S >= T + window) is written as 0, the TPU kernel's
``l == 0`` guard; the plain version, like the reference package's,
averages v uniformly there. No path of the port makes such rows: the
prefill has S == T, so every row sees at least its own key.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
launches = 0                      # kernel launches since the last reset


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window=None) -> torch.Tensor:
    """Attention ``(B, S, H, D)`` in q's dtype, as ``ref.attention_ref``.

    ``q`` ``(B, S, H, D)``, ``k``/``v`` ``(B, T, K, D)`` with
    ``H % K == 0``: contiguous CUDA tensors of one dtype (float32 or
    bfloat16) on one device, ``D`` in ``HEAD_DIMS``. ``window`` is None
    or a positive number of keys (``q_pos - k_pos < window``).
    """
    global launches
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
    out = torch.empty_like(q)
    if out.numel():
        lib = _cuda.library()
        with torch.cuda.device(q.device):
            rc = lib.repro_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, T, H, K, D, int(causal),
                0 if window is None else int(window), D ** -0.5,
                int(q.dtype == torch.bfloat16), _cuda.stream_handle(q))
        _cuda.check(rc, "flash attention")
        launches += 1
    return out
