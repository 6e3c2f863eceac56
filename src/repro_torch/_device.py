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
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu "
                         f"(or meta for shapes alone)")
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


_PW_BLOCK = 128      # numpy's pairwise-sum leaf size (PW_BLOCKSIZE)
_NP_BUFSIZE = 8192   # numpy reduces in chunks of its buffer size
_LEAF_IDX: dict = {}  # (n, leaf length, device) -> leaf column indices


def _pw_leaves(n: int, start: int = 0):
    """numpy's pairwise-sum split of ``n`` elements: a leaf
    ``(start, length)`` or a pair of subtrees."""
    if n <= _PW_BLOCK:
        return (start, n)
    half = n // 2
    half -= half % 8
    return (_pw_leaves(half, start), _pw_leaves(n - half, start + half))


def np_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums ``(R,)`` of ``x`` ``(R, n)`` added in ``np.sum(axis=1)``'s
    order, bit for bit: under 8 elements left to right; else numpy's
    pairwise sum, leaves of at most 128 elements each summed in eight
    strided accumulators, ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, then
    its tail, and the leaves added up the split tree. Leaves of one
    length are summed together, so the cost is a few dozen tensor
    operations at any width. Past 8,192 elements numpy adds the rows'
    8,192-element chunks in turn, and so does this."""
    R, n = x.shape
    if n > _NP_BUFSIZE:
        acc = torch.zeros(R, dtype=x.dtype, device=x.device)
        for s in range(0, n, _NP_BUFSIZE):
            acc = acc + np_sum(x[:, s:s + _NP_BUFSIZE])
        return acc
    if n < 8:
        acc = torch.zeros(R, dtype=x.dtype, device=x.device)
        for j in range(n):
            acc = acc + x[:, j]
        return acc
    tree = _pw_leaves(n)
    leaves = []

    def collect(node):
        if isinstance(node[0], tuple):
            collect(node[0])
            collect(node[1])
        else:
            leaves.append(node)

    collect(tree)
    sums = {}
    for length in sorted({ln for _, ln in leaves}):
        starts = [s for s, ln in leaves if ln == length]
        key = (n, length, str(x.device))
        idx = _LEAF_IDX.get(key)
        if idx is None:
            idx = _LEAF_IDX[key] = (
                torch.as_tensor(starts, device=x.device)[:, None]
                + torch.arange(length, device=x.device))
        seg = x[:, idx]                              # (R, leaves, length)
        body = length - length % 8
        r = seg[:, :, :8]
        for i in range(8, body, 8):
            r = r + seg[:, :, i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(body, length):
            res = res + seg[:, :, i]
        for k, s in enumerate(starts):
            sums[s] = res[:, k]

    def add(node):
        if isinstance(node[0], tuple):
            return add(node[0]) + add(node[1])
        return sums[node[0]]

    return add(tree)


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
