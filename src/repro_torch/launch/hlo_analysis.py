"""Op counts of one step: the roofline inputs of a dry run.

The counterpart of the reference package's ``launch/hlo_analysis.py``.
There the optimised (post-SPMD) HLO text of a lowered step is parsed;
here one step runs eagerly under :class:`OpCounter`, a
``TorchDispatchMode`` that sees every ATen operator a device runs (real
tensors on a card, or fake ones in a dry run) and every kernel operator
of the port: K3, K3', K4, K5 and K6 are ``torch.library`` operators, as
each TPU kernel is one custom call in the reference's HLO.

Counts are **per device**. On DTensors the counter steps aside from the
DTensor-level operator and counts the local operators and collectives
that DTensor issues on this rank; the operators DTensor's sharding
propagation runs on fake tensors of the whole shape, to learn an
output's metadata, are not counted.

* ``flops``: 2 x prod(result) x prod(contracting dims) for each ``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot`` and convolution; a
  kernel operator counts the work of its bound: K4 4·B·H·D·Σ(live
  keys) (with its log-sum-exp too), the backward from it the
  reference's five products, 10·B·H·D·Σ(live keys), K5 the products of
  its chunked scan, K6, K3 and K3' no dot FLOPs.
* ``hbm_bytes``: the bytes of every tensor an operator reads and of
  every tensor it writes, each once. Eager PyTorch fuses nothing, so
  each operator is an HBM boundary, as each fusion is in the reference's
  model. Views (a result that aliases an operand, nothing written) and
  allocations (``empty``) count 0: the reference's ``_SKIP_OPS``.
* ``dot_count``: the matrix products above (not the kernel operators).
* ``collectives``: result bytes by kind of the ``_c10d_functional``
  collectives, under the reference's kind names; ``wait_tensor`` is not
  counted, as the reference counts a ``-start``/``-done`` pair once.

The port runs eagerly, its layer stack unrolled: every loop body is seen
as often as it runs, so nothing takes the reference's ``loop_trips``.
Besides, the counter tracks the bytes of the storages operators make on
this device as they are made and freed (``peak_bytes``), and counts each
operator by name (``ops``) and each kernel operator (``kernels``).
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all",
)
# collectives (``_c10d_functional``, and DTensor's own all-to-all of a
# shard) -> the reference's kind names
_COLLECTIVES = {
    **{("_c10d_functional", op): kind for op, kind in (
        ("all_reduce", "all-reduce"), ("all_reduce_", "all-reduce"),
        ("all_reduce_coalesced", "all-reduce"),
        ("all_reduce_coalesced_", "all-reduce"),
        ("all_gather_into_tensor", "all-gather"),
        ("all_gather_into_tensor_out", "all-gather"),
        ("all_gather_into_tensor_coalesced", "all-gather"),
        ("reduce_scatter_tensor", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
        ("all_to_all_single", "all-to-all"),
        ("broadcast", "collective-permute"),
        ("broadcast_", "collective-permute"))},
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}
_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot"}
_CONVS = ("convolution", "convolution_backward")
# operators that move no bytes: allocations, host reads, metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense",
               "wait_tensor", "device", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_same_size",
               "record_stream"}
KERNEL_NAMESPACE = "repro_torch"


def live_keys(S: int, T: int, causal: bool, window) -> int:
    """Sum over queries of the keys K4's mask leaves live (query ``i``
    at position ``i``, key ``j`` at ``j``)."""
    qi = np.arange(S, dtype=np.int64)
    hi = np.minimum(T - 1, qi) if causal else np.full(S, T - 1)
    lo = np.maximum(0, qi - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Products the chunked SSD scan needs: C.B^T once per (batch,
    chunk) and scores.x over the live s <= t only; C.h and the chunk
    states in full."""
    Q = min(chunk, S)
    if Q < 1:
        return 0
    full, tail = divmod(S, Q)

    def chunk_flops(L: int) -> int:
        tri = L * (L + 1) // 2
        return B * (2 * tri * N + H * (2 * tri * P + 4 * L * P * N))

    return full * chunk_flops(Q) + (chunk_flops(tail) if tail else 0)


def _flash_attention_flops(q, k, v, causal, window) -> int:
    B, S, H, D = q.shape
    return 4 * B * H * D * live_keys(S, k.shape[1], causal, window)


def _flash_attention_bwd_flops(q, k, v, out, lse, g, causal, window) -> int:
    B, S, H, D = q.shape
    return 10 * B * H * D * live_keys(S, k.shape[1], causal, window)


def _ssd_scan_flops(xh, b_mat, c_mat, dt, a, chunk, h0=None,
                    route_to=None) -> int:
    B, S, H, P = xh.shape
    return ssd_flops(B, S, H, P, b_mat.shape[2], chunk)


KERNEL_FLOPS: Dict[str, Callable] = {
    "flash_attention": _flash_attention_flops,
    "flash_attention_lse": _flash_attention_flops,
    "flash_attention_bwd": _flash_attention_bwd_flops,
    "ssd_scan": _ssd_scan_flops,
    "rglru_scan": lambda *a: 0,
    "quantize_int8": lambda *a: 0,
    "dequantize_int8": lambda *a: 0,
}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _dot_flops(name: str, args) -> int:
    """2 x prod(result) x contracted size of a matrix product."""
    if name in ("addmm", "baddbmm", "addmv"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("mm", "addmm"):
        return 2 * a.shape[0] * b.shape[1] * a.shape[1]
    if name in ("bmm", "baddbmm"):
        return 2 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]
    if name in ("mv", "addmv"):
        return 2 * a.shape[0] * a.shape[1]
    return 2 * a.shape[0]                                   # dot


def _conv_flops(name: str, args, out) -> int:
    """2 x prod(output) x (input channels a group x kernel size) a
    convolution; its backward that for each gradient it computes."""
    if name == "convolution":
        x, w, groups = args[0], args[1], args[8]
        return 2 * _numel(out.shape) * (x.shape[1] // groups) * _numel(
            w.shape[2:])
    grad, x, w = args[0], args[1], args[2]
    groups, mask = args[9], args[10]
    fwd = 2 * _numel(grad.shape) * (x.shape[1] // groups) * _numel(
        w.shape[2:])
    return fwd * (int(bool(mask[0])) + int(bool(mask[1])))


def _is_wrapper(cls) -> bool:
    """A tensor subclass that wraps others (DTensor, the collectives'
    async tensors): its operators are counted as the ones it issues."""
    return hasattr(cls, "__tensor_flatten__")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An operator whose results alias an operand and that writes
    nothing (``view``, ``t``, ``slice``, ``select``, ``split``, ...)."""
    return bool(func.is_view) and not func._schema.is_mutable


class OpCounter(TorchDispatchMode):
    """Counts the operators run under it on this device (module
    docstring); with ``device_type``, only operators that read or write
    a tensor of that type (not the host's bookkeeping beside a card's
    work). ``known(tree)`` marks tensors that exist before the step (its
    arguments), whose storages are not new bytes."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.flops = 0
        self.hbm_bytes = 0
        self.dot_count = 0
        self.per_kind: Dict[str, float] = {}
        self.collective_ops = 0
        self.ops: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict = {}          # storage key -> bytes (new ones)
        self._known: set = set()           # storage keys of the arguments
        self._hidden = 0
        self._patched = None

    # -- storages ---------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def known(self, tree) -> None:
        """Mark the storages of the tensors in ``tree`` (DTensors' local
        parts) as existing before the step."""
        from repro_torch import _dtensor

        for t in _tensors(tree):
            t = _dtensor.local(t)
            key = self._key(t)
            if key not in self._known:
                self._known.add(key)
                weakref.finalize(t.untyped_storage(), self._known.discard,
                                 key)

    def _made(self, out) -> None:
        for t in _tensors(out):
            if _is_wrapper(type(t)):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in self._known:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # -- DTensor's metadata runs -------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            name = "_propagate_tensor_meta"
        original = getattr(ShardingPropagator, name)
        counter = self

        def hidden(prop, *args, **kwargs):
            counter._hidden += 1
            try:
                return original(prop, *args, **kwargs)
            finally:
                counter._hidden -= 1

        setattr(ShardingPropagator, name, hidden)
        self._patched = (ShardingPropagator, name, original)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cls, name, original = self._patched
            setattr(cls, name, original)
            self._patched = None

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_wrapper(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if name in _NO_TRAFFIC or ns == "prim":
            return
        if self.device_type is not None and not any(
                t.device.type == self.device_type
                for t in _tensors((args, kwargs, out))):
            return
        self.ops[f"{ns}.{name}"] += 1
        self._made(out)
        if _is_view(func) or name == "_unsafe_view":
            return
        kind = _COLLECTIVES.get((ns, name))
        if kind is not None:
            n = sum(_nbytes(t) for t in _tensors(out))
            self.per_kind[kind] = self.per_kind.get(kind, 0.0) + n
            self.collective_ops += 1
        if ns == KERNEL_NAMESPACE:
            self.kernels[name] += 1
            self.flops += KERNEL_FLOPS[name](*args, **kwargs)
        elif ns == "aten" and name in _DOTS:
            self.flops += _dot_flops(name, args)
            self.dot_count += 1
        elif ns == "aten" and name in _CONVS:
            self.flops += _conv_flops(name, args, out)
            self.dot_count += 1
        # every tensor read and every tensor written, each storage once
        seen = set()
        n = 0
        for t in _tensors((args, kwargs)) + _tensors(out):
            key = (self._key(t), t.storage_offset(), tuple(t.shape))
            if key not in seen:
                seen.add(key)
                n += _nbytes(t)
        self.hbm_bytes += n

    def summary(self) -> dict:
        """The reference's ``analyze`` keys, plus ``ops``, ``kernels``
        and ``peak_bytes``."""
        return {
            "flops": float(self.flops),
            "dot_count": self.dot_count,
            "hbm_bytes": float(self.hbm_bytes),
            "collectives": {
                "per_kind": dict(self.per_kind),
                "total_bytes": float(sum(self.per_kind.values())),
                "static_op_count": self.collective_ops,
            },
            "ops": dict(sorted(self.ops.items())),
            "kernels": dict(sorted(self.kernels.items())),
            "peak_bytes": self.peak_bytes,
        }


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` and
    return its :meth:`~OpCounter.summary`."""
    counter = OpCounter()
    counter.known((args, kwargs))
    with counter:
        fn(*args, **kwargs)
    return counter.summary()
