"""Cross-pod federated operations of the port: FedAvg and FedBuff over
the pod axis, with the wire compression of a pod's update.

The counterparts of the reference package's ``dist/fedops.py``. A
federated state keeps a leading ``n_pods`` axis on every leaf; a FedAvg
round is a weighted reduction over that axis broadcast back to every
pod, each pod's update optionally pushed through the int8/top-k
compression of ``fl/compression.py`` first: the cross-site ``M_i^UD``
upload the BS slice is sized for. Compression acts on the delta from
pod 0 (FedAvg) or on each pod's snapshotted delta from its own download
reference (FedBuff), with optional float32 error-feedback residuals
that stay pod-local.

The reference maps ``quantize_int8`` over the pod axis with
``jax.vmap``; here the stacked leaf goes through the blockwise
quantiser of ``kernels/quant`` with one block a pod (``block =
leaf.numel() // n_pods``): one K3 and one K3' launch a stacked leaf on a
card, the plain versions on the CPU. Top-k runs pod by pod
(``torch.topk``). Nothing is written into a caller's tensors; every
returned leaf owns its storage (a pod-broadcast is materialised).

On a mesh (DTensor leaves, the pod axis ``Shard(0)`` over the ``pod``
mesh dim, the rest as the parameters' specs say) a leaf's reduction
gathers its pods and keeps the other splits: each rank holds every
pod's part of the leaf (one all-gather over ``pod``) and runs the same
arithmetic on it (the pod-axis ``tensordot`` element by element, in the
pods' order), keeping its own pods of the result (no communication).
The wire round trip needs each pod's whole leaf (one int8 scale a pod,
top-k over the pod): where the leaf is split beyond the pod axis, each
rank gathers its own pods whole over the other mesh dims, runs K3/K3'
(or top-k) on them, and gathers the decoded parts over ``pod`` again, so
that codes and scales are the one device's. A rank so holds at most its
own pods' whole leaves, never every pod's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import _dtensor
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.fl.compression import topk_sparsify
from repro_torch.kernels.quant import ops as quant_ops

SCHEMES = ("none", "int8", "topk", "int8+topk")


def check_scheme(scheme) -> str:
    """Normalise/validate a compression scheme name (None -> "none")."""
    scheme = scheme or "none"
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown compression scheme {scheme!r}; have {SCHEMES}"
        )
    return scheme


def _pod_broadcast(row: torch.Tensor, n_pods: int) -> torch.Tensor:
    """``row`` repeated over a new leading pod axis, in storage of its
    own (no pod shares another's memory)."""
    return row.unsqueeze(0).repeat((n_pods,) + (1,) * row.dim())


def pod_weighted_mean(leaf: torch.Tensor,
                      w_norm: torch.Tensor) -> torch.Tensor:
    """Weighted mean over the leading pod axis, broadcast back to all
    pods: float32 accumulate, cast back to the leaf's dtype."""
    g = torch.tensordot(w_norm, leaf.float(), dims=1)
    return _pod_broadcast(g.to(leaf.dtype), leaf.shape[0])


def init_residuals(params):
    """Zero float32 error-feedback residuals, one per pod-stacked leaf."""
    return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                    params)


def _roundtrip(target: torch.Tensor, scheme: str, topk_frac: float,
               layout=None) -> torch.Tensor:
    """Each pod's row of the float32 ``target`` ``(n_pods, ...)``
    through the wire encoding and back: top-k pod by pod, then int8
    with one block (one scale) a pod. With ``layout`` (a
    :class:`_PodLayout`) the rows are every pod's part of a split leaf,
    made whole pod by pod for the encoding."""
    if layout is not None and layout.split:
        return layout.from_own_pods(
            _roundtrip(layout.own_pods(target), scheme, topk_frac))
    comp = target
    if "topk" in scheme:
        comp = torch.stack([topk_sparsify(row, topk_frac) for row in comp])
    if "int8" in scheme:
        per_pod = comp[0].numel()
        q, scales = quant_ops.quantize_int8(comp.contiguous(),
                                            block=per_pod)
        comp = quant_ops.dequantize_int8(q, scales, block=per_pod)
        comp = comp.reshape(target.shape)
    return comp


def compress_pod_updates(leaf: torch.Tensor, scheme: str,
                         topk_frac: float = 0.05,
                         residual: Optional[torch.Tensor] = None,
                         layout=None):
    """Round-trip each pod's update through the wire compression.

    ``leaf`` is ``(n_pods, ...)``. Each pod's payload is its delta from
    pod 0; the result is what the aggregator reconstructs (``ref +
    decode(encode(delta))``). With ``residual`` (float32, the leaf's
    shape) the residual is added to the delta before encoding and the
    call returns ``(decoded, new_residual)``, ``new_residual = target -
    decode(encode(target))``; a ``"none"`` scheme passes it through.
    ``layout``: as :func:`_roundtrip`'s.
    """
    scheme = check_scheme(scheme)
    if scheme == "none":
        return leaf if residual is None else (leaf, residual)
    ref = leaf[0]
    target = (leaf - ref[None]).float()
    if residual is not None:
        target = target + residual
    comp = _roundtrip(target, scheme, topk_frac, layout)
    decoded = (ref.float()[None] + comp).to(leaf.dtype)
    if residual is None:
        return decoded
    return decoded, target - comp


class _PodLayout:
    """The placements of a pod-stacked DTensor leaf (the pod axis
    ``Shard(0)``, the rest of the leaf perhaps split over other mesh
    dims), and the moves between it and the plain local tensors that the
    pod-axis arithmetic runs on."""

    def __init__(self, like):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh = like.device_mesh
        self.shape = torch.Size(like.shape)
        self.placements = tuple(like.placements)
        pod = [p == Shard(0) for p in self.placements]
        # every pod, the other splits kept / the own pods, whole
        self.pods = tuple(Replicate() if is_pod else p
                          for p, is_pod in zip(self.placements, pod))
        self.own = tuple(p if is_pod else Replicate()
                         for p, is_pod in zip(self.placements, pod))
        # split beyond the pod axis over a mesh dim of more than one rank
        self.split = any(p != o and self.mesh.size(m) > 1 for m, (p, o)
                         in enumerate(zip(self.placements, self.own)))

    def _dtensor(self, t: torch.Tensor, placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            t, self.mesh, placements, run_check=False, shape=self.shape,
            stride=_dtensor.contiguous_strides(self.shape))

    def gather(self, leaf) -> torch.Tensor:
        """Every pod's local part of a leaf placed like this one."""
        return leaf.redistribute(self.mesh, self.pods).to_local()

    def place(self, t: torch.Tensor):
        """Every pod's part back as a DTensor in the placements (the
        rank keeps its own pods, no communication)."""
        return self._dtensor(t, self.pods).redistribute(self.mesh,
                                                        self.placements)

    def own_pods(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's own pods, whole, from every pod's part."""
        return self.place(t).redistribute(self.mesh, self.own).to_local()

    def from_own_pods(self, t: torch.Tensor) -> torch.Tensor:
        """Every pod's part, from the rank's own pods whole (cut to the
        rank's part first, so that no rank holds every pod whole)."""
        parts = self._dtensor(t, self.own).redistribute(self.mesh,
                                                         self.placements)
        return parts.redistribute(self.mesh, self.pods).to_local()


def _on_pods(fn):
    """``fn`` over leaves, plain leaves as they are; on DTensor leaves
    over every pod's local part of each (``layout=`` the first leaf's
    :class:`_PodLayout`), each output placed back as the first leaf
    is."""
    def run(*leaves):
        if not _dtensor.is_dtensor(leaves[0]):
            return fn(*leaves)
        layout = _PodLayout(leaves[0])
        out = fn(*(layout.gather(leaf) for leaf in leaves), layout=layout)
        if isinstance(out, tuple):
            return tuple(layout.place(o) for o in out)
        return layout.place(out)

    return run


def _split_pairs(pairs, like):
    """A tree of ``(a, b)`` leaves shaped like ``like`` -> two trees."""
    return (tree_map(lambda _, p: p[0], like, pairs),
            tree_map(lambda _, p: p[1], like, pairs))


def fedavg_pods(params, weights: torch.Tensor, scheme: str = "none",
                topk_frac: float = 0.05, residuals=None):
    """Compressed weighted FedAvg over the pod axis of a parameter tree.

    With ``residuals`` (a tree from :func:`init_residuals`) applies
    error-feedback compression and returns ``(avg_params,
    new_residuals)``; without, returns ``avg_params``.
    """
    w = torch.as_tensor(weights, device=tree_leaves(params)[0].device)
    w = w.float()
    w_norm = w / torch.sum(w)

    if residuals is None:
        def avg(leaf, layout=None):
            decoded = compress_pod_updates(leaf, scheme, topk_frac,
                                           layout=layout)
            return pod_weighted_mean(decoded, w_norm)

        return tree_map(_on_pods(avg), params)

    def avg_ef(leaf, res, layout=None):
        decoded, new_res = compress_pod_updates(leaf, scheme, topk_frac,
                                                residual=res, layout=layout)
        return pod_weighted_mean(decoded, w_norm), new_res

    return _split_pairs(tree_map(_on_pods(avg_ef), params, residuals),
                        params)


# ---------------------------------------------------------------------------
# asynchronous (FedBuff) aggregation
# ---------------------------------------------------------------------------


def staleness_discount(staleness, power: float = 0.5) -> torch.Tensor:
    """``(1 + τ)^-p``, the FedBuff staleness weight (p = 0.5 default)."""
    s = torch.as_tensor(staleness).float()
    return (1.0 + s) ** (-power)


def compress_deltas(deltas: torch.Tensor, scheme: str,
                    topk_frac: float = 0.05, residual=None, layout=None):
    """Round-trip pod-stacked update deltas through the wire encoding.

    ``deltas`` already are the wire payloads (each pod's parameters
    minus its own download reference), so there is no pod-0 reference.
    With ``residual`` returns ``(decoded, new_residual)``; the caller
    masks the residual update to the pods that transmitted. ``layout``:
    as :func:`_roundtrip`'s.
    """
    scheme = check_scheme(scheme)
    if scheme == "none":
        return deltas if residual is None else (deltas, residual)
    target = deltas.float()
    if residual is not None:
        target = target + residual
    comp = _roundtrip(target, scheme, topk_frac, layout)
    decoded = comp.to(deltas.dtype)
    if residual is None:
        return decoded
    return decoded, target - comp


def _bmask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a ``(n_pods,)`` mask to broadcast over a stacked leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def fedbuff_pods(pending, global_params, weights: torch.Tensor,
                 arrived: torch.Tensor, staleness: torch.Tensor,
                 server_lr: float = 1.0, scheme: str = "none",
                 topk_frac: float = 0.05, staleness_power: float = 0.5,
                 frac=None, residuals=None,
                 quorum_frac: Optional[float] = None,
                 n_expected=None):
    """Buffered staleness-weighted (FedBuff) merge over the pod axis.

    ``pending``: tree of ``(n_pods, ...)`` snapshotted update deltas;
    ``global_params``: pod-stacked copies of the current global model;
    ``arrived`` ``(n_pods,)`` bool: whose upload completed this round;
    ``staleness`` ``(n_pods,)``: rounds since each pod downloaded the
    model it trained on; ``frac``: optional served fraction. The new
    global is

        ``G' = G + server_lr · Σ_i (w_i/Σ_j w_j) · s_i · f_i · Δ_i``

    over arrived pods, ``s_i = (1+τ_i)^-p``: data weights mix the
    co-arrivals relatively, staleness and fraction discount each update
    absolutely (a no-op when nothing arrived). With ``residuals`` the
    arrived pods' encodings run through error feedback (the others'
    residuals pass through) and the call returns ``(new_global,
    new_residuals)``. ``quorum_frac`` gates the merge: fewer than
    ``ceil(quorum_frac * n_expected)`` arrivals (``n_expected`` defaults
    to ``n_pods``) zero every merge weight, so the global passes through.
    """
    dev = tree_leaves(global_params)[0].device
    arrived = torch.as_tensor(arrived, device=dev)
    m = arrived.float()
    w = torch.as_tensor(weights, device=dev).float() * m
    s = staleness_discount(torch.as_tensor(staleness, device=dev),
                           staleness_power)
    f = (torch.ones_like(w) if frac is None
         else torch.as_tensor(frac, device=dev).float())
    # no arrivals (Σ w = 0) must leave the global untouched
    w_norm = w / torch.clamp(w.sum(), min=1e-12) * s * f * m
    if quorum_frac is not None:
        # float32 arithmetic, as the reference's traced gate
        n_exp = np.float32(arrived.shape[0] if n_expected is None
                           else n_expected)
        need = max(float(np.ceil(np.float32(quorum_frac) * n_exp)), 1.0)
        w_norm = w_norm * (m.sum() >= need).float()

    def merge(leaf_delta, g, res=None, layout=None):
        if res is None:
            decoded = compress_deltas(leaf_delta, scheme, topk_frac,
                                      layout=layout)
        else:
            decoded, cand = compress_deltas(leaf_delta, scheme, topk_frac,
                                            residual=res, layout=layout)
        upd = torch.tensordot(w_norm, decoded.float(), dims=1)
        newg = (g.float() + server_lr * upd[None]).to(g.dtype)
        if res is None:
            return newg
        return newg, torch.where(_bmask(arrived, res), cand, res)

    if residuals is None:
        return tree_map(_on_pods(merge), pending, global_params)
    return _split_pairs(tree_map(_on_pods(merge), pending, global_params,
                                 residuals), pending)
