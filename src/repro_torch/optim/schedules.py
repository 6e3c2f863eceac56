"""Learning-rate schedules (pure functions of the step counter).

The counterparts of the reference package's ``optim/schedules.py``. A
schedule maps a step (an int or a 0-d integer tensor) to a 0-d float32
tensor on the step's device. The arithmetic is the reference's, in
float32, done on the host: the step is one scalar, and ``int(step)``
reads it once. The reference's cosine is XLA's float32 ``cos`` on the
CPU, which is the C library's ``cosf``; the port calls the same
function, so each lr equals the reference's float32 value bit for bit
(``tests/test_torch_optim.py``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

_F32 = np.float32


@functools.cache
def libm() -> ctypes.CDLL:
    """The C library's math functions ``cosf`` and ``powf`` (float32),
    which XLA's CPU code calls for ``cos`` and ``pow``."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def host_count(step: torch.Tensor) -> int:
    """``int(step)``. A fake tensor (a dry run traces a step with shapes
    alone) holds no count: it reads as 1, which changes no shape and no
    operation of a step."""
    from torch._subclasses.fake_tensor import is_fake

    return 1 if is_fake(step) else int(step)


def _host_step(step):
    """(step as float32, device of the result)."""
    if isinstance(step, torch.Tensor):
        return _F32(host_count(step)), step.device
    return _F32(step), torch.device("cpu")


def _out(value, device) -> torch.Tensor:
    return torch.tensor(_F32(value), dtype=torch.float32, device=device)


def constant(lr: float):
    return lambda step: _out(lr, _host_step(step)[1])


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    peak = _F32(peak_lr)
    warm_div = _F32(max(warmup_steps, 1))
    span = _F32(max(total_steps - warmup_steps, 1))

    def fn(step):
        s, dev = _host_step(step)
        if s < warmup_steps:
            return _out(peak * min(s / warm_div, _F32(1.0)), dev)
        progress = min(max((s - _F32(warmup_steps)) / span, _F32(0.0)),
                       _F32(1.0))
        cos = _F32(libm().cosf(float(_F32(math.pi) * progress)))
        cos = _F32(final_frac) + _F32((1 - final_frac) * 0.5) * (
            _F32(1.0) + cos)
        return _out(peak * cos, dev)

    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    peak = _F32(peak_lr)

    def fn(step):
        s, dev = _host_step(step)
        if s < warmup_steps:
            return _out(peak * s / _F32(max(warmup_steps, 1)), dev)
        return _out(peak * np.sqrt(_F32(warmup_steps)
                                   / max(s, _F32(warmup_steps))), dev)

    return fn
