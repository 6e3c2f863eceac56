"""Device and dtype policy of the port.

* Every public entry point takes ``device=`` and defaults to
  :data:`DEFAULT_DEVICE` (``"cuda"``). Without CUDA it raises
  ``RuntimeError``; it never drops to the CPU on its own. Callers that
  want the CPU (the tests) pass ``device="cpu"``.
* Queue state is float64 (:data:`FLOAT`), built with an explicit
  ``dtype=``; the global default dtype is never changed.
* 32-bit counter words (threefry keys, counters, outputs) ride in int64
  tensors masked with ``& MASK32``: PyTorch on the CPU has no uint32
  add, shift or compare.
* The FL model's float32 math (convolutions, products, their backward)
  runs inside :func:`full_float32`, with TF32 off, as the reference
  computes it.
"""
from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"
FLOAT = torch.float64
MASK32 = 0xFFFFFFFF


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    return dev


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 added strictly left to right,
    like ``np.cumsum``.

    PyTorch's CPU ``cumsum`` is sequential and equals numpy bit for bit;
    the CUDA one is a parallel scan and may round differently, so on a
    card the columns are added one at a time. Meant for the narrow
    widths where the engine needs it (PONs of a case, live slots).
    """
    if x.device.type == "cpu" or x.shape[1] <= 1:
        return torch.cumsum(x, dim=1)
    out = torch.empty_like(x)
    acc = x[:, 0]
    out[:, 0] = acc
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
        out[:, j] = acc
    return out


@contextlib.contextmanager
def full_float32():
    """Float32 products and convolutions in full float32 inside the block.

    cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
    three decimal digits; the reference computes them in float32. The
    flags in force before are restored on the way out. Autograd reads
    the flags when the backward runs, so a training step enters this
    around its backward too.
    """
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
