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
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    return tree_map(lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                          device=l.device), params)


def _roundtrip(target: torch.Tensor, scheme: str,
               topk_frac: float) -> torch.Tensor:
    """Each pod's row of the float32 ``target`` ``(n_pods, ...)``
    through the wire encoding and back: top-k pod by pod, then int8
    with one block (one scale) a pod."""
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
                         residual: Optional[torch.Tensor] = None):
    """Round-trip each pod's update through the wire compression.

    ``leaf`` is ``(n_pods, ...)``. Each pod's payload is its delta from
    pod 0; the result is what the aggregator reconstructs (``ref +
    decode(encode(delta))``). With ``residual`` (float32, the leaf's
    shape) the residual is added to the delta before encoding and the
    call returns ``(decoded, new_residual)``, ``new_residual = target -
    decode(encode(target))``; a ``"none"`` scheme passes it through.
    """
    scheme = check_scheme(scheme)
    if scheme == "none":
        return leaf if residual is None else (leaf, residual)
    ref = leaf[0]
    target = (leaf - ref[None]).float()
    if residual is not None:
        target = target + residual
    comp = _roundtrip(target, scheme, topk_frac)
    decoded = (ref.float()[None] + comp).to(leaf.dtype)
    if residual is None:
        return decoded
    return decoded, target - comp


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
        def avg(leaf):
            decoded = compress_pod_updates(leaf, scheme, topk_frac)
            return pod_weighted_mean(decoded, w_norm)

        return tree_map(avg, params)

    def avg_ef(leaf, res):
        decoded, new_res = compress_pod_updates(leaf, scheme, topk_frac,
                                                residual=res)
        return pod_weighted_mean(decoded, w_norm), new_res

    return _split_pairs(tree_map(avg_ef, params, residuals), params)


# ---------------------------------------------------------------------------
# asynchronous (FedBuff) aggregation
# ---------------------------------------------------------------------------


def staleness_discount(staleness, power: float = 0.5) -> torch.Tensor:
    """``(1 + τ)^-p``, the FedBuff staleness weight (p = 0.5 default)."""
    s = torch.as_tensor(staleness).float()
    return (1.0 + s) ** (-power)


def compress_deltas(deltas: torch.Tensor, scheme: str,
                    topk_frac: float = 0.05, residual=None):
    """Round-trip pod-stacked update deltas through the wire encoding.

    ``deltas`` already are the wire payloads (each pod's parameters
    minus its own download reference), so there is no pod-0 reference.
    With ``residual`` returns ``(decoded, new_residual)``; the caller
    masks the residual update to the pods that transmitted.
    """
    scheme = check_scheme(scheme)
    if scheme == "none":
        return deltas if residual is None else (deltas, residual)
    target = deltas.float()
    if residual is not None:
        target = target + residual
    comp = _roundtrip(target, scheme, topk_frac)
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

    def merge(leaf_delta, g, res=None):
        if res is None:
            decoded = compress_deltas(leaf_delta, scheme, topk_frac)
        else:
            decoded, cand = compress_deltas(leaf_delta, scheme, topk_frac,
                                            residual=res)
        upd = torch.tensordot(w_norm, decoded.float(), dims=1)
        newg = (g.float() + server_lr * upd[None]).to(g.dtype)
        if res is None:
            return newg
        return newg, torch.where(_bmask(arrived, res), cand, res)

    if residuals is None:
        return tree_map(merge, pending, global_params)
    return _split_pairs(tree_map(merge, pending, global_params, residuals),
                        pending)
