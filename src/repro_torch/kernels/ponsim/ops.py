"""Waterfill grant dispatch: the Hopper kernel K2 for CUDA tensors, the
plain version for CPU tensors.

The fused on-device phase program of the JAX package
(``run_phase_device``) is not ported yet; the engine calls this per
cycle.
"""
from __future__ import annotations

import torch

from repro_torch._device import DEFAULT_DEVICE, FLOAT, resolve_device
from repro_torch.kernels.ponsim import kernel as _kernel
from repro_torch.kernels.ponsim import ref as _ref


def waterfill_grants(backlog, hol, cap, hard=None, *,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Oldest-first waterfill grants ``(R, N)`` float64 on ``device``.

    ``backlog`` ``(R, N)``, ``hol`` ``(R, N)`` head-of-line keys (float
    times or int64 cycles; lower is older), ``cap`` ``(R,)``; ``hard``
    optionally the precomputed ``ref.hard_rows``. Rows that are not
    hard get their backlog back unchanged.
    """
    dev = resolve_device(device)
    backlog = torch.as_tensor(backlog, dtype=FLOAT, device=dev)
    cap = torch.as_tensor(cap, dtype=FLOAT, device=dev)
    hol = torch.as_tensor(hol, device=dev)
    if hard is None:
        hard = _ref.hard_rows(backlog, cap)
    if dev.type == "cuda":
        # int64 cycle keys stay ordered (ties included) as float64 below
        # 2**53, and the empty-queue sentinel still sorts last
        return _kernel.waterfill_grants_cuda(
            backlog.contiguous(), hol.to(FLOAT).contiguous(),
            cap.contiguous(), hard.contiguous())
    return _ref.waterfill_grants_ref(backlog, hol, cap, hard)
