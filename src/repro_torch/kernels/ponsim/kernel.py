"""Hopper kernel K2: the oldest-first waterfill grant, in float64.

Binds ``csrc/waterfill.cu`` (the port of the TPU kernel
``repro/kernels/ponsim/kernel.py::waterfill_grants_pallas``): one block
per row, stable ranks by a bitonic sort of (key, index), a sequential
prefix in rank order. It takes rows of any width: past the card's
shared memory the wrapper hands the kernel a global scratch buffer. It
equals ``ref.waterfill_grants_ref`` on the CPU bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import _cuda

launches = 0                      # kernel launches since the last reset


def waterfill_grants_cuda(backlog: torch.Tensor, key: torch.Tensor,
                          cap: torch.Tensor, hard: torch.Tensor
                          ) -> torch.Tensor:
    """Grants ``(R, N)`` float64: the waterfill for ``hard`` rows, the
    backlog itself for the rest.

    ``backlog``/``key`` float64 ``(R, N)`` (keys must not be NaN),
    ``cap`` float64 ``(R,)``, ``hard`` bool ``(R,)``; contiguous CUDA
    tensors on one device.
    """
    global launches
    R, N = backlog.shape
    _cuda.require(backlog, "backlog", torch.float64, (R, N))
    _cuda.require(key, "key", torch.float64, (R, N))
    _cuda.require(cap, "cap", torch.float64, (R,))
    _cuda.require(hard, "hard", torch.bool, (R,))
    grants = torch.empty_like(backlog)
    if R and N:
        lib = _cuda.library()
        with torch.cuda.device(backlog.device):
            row_bytes = lib.repro_waterfill_scratch_bytes(N)
            if row_bytes < 0:
                raise RuntimeError("waterfill: cannot query the device's "
                                   "shared memory")
            scratch = (torch.empty(R * row_bytes, dtype=torch.uint8,
                                   device=backlog.device)
                       if row_bytes else None)
            rc = lib.repro_waterfill_grants(
                backlog.data_ptr(), key.data_ptr(), cap.data_ptr(),
                hard.data_ptr(), grants.data_ptr(), R, N,
                None if scratch is None else scratch.data_ptr(),
                _cuda.stream_handle(backlog))
        _cuda.check(rc, "waterfill")
        launches += 1
    return grants
