"""Update compression — the ``M_i^UD`` lever of the paper's Algorithm 1.

The slice bandwidth demand is ``Σ M_i^UD / τ``; shrinking the update bytes
shrinks the slice (or lets more clients share it). Two standard schemes, both
with error feedback so compression noise does not bias FedAvg:

* int8 symmetric per-tensor quantisation (4x vs fp32): the blockwise
  quantiser of ``kernels.quant`` with one block of the whole leaf, so on
  a card every int8 leaf goes through the Hopper kernels K3 and K3'.
* top-k sparsification (magnitude): keep the k largest entries per tensor.

Updates are nested dicts of tensors, walked in the reference's sorted-key
order; the per-client error-feedback residual is a dict of the same keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.quant import ops as quant_ops

# --------------------------- int8 quantisation -----------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q of ``x``'s shape, 0-d scale)."""
    q, scales = quant_ops.quantize_int8(x, block=x.numel())
    return q.reshape(x.shape), scales.reshape(())


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    flat = quant_ops.dequantize_int8(q.reshape(-1), scale.reshape(1),
                                     block=q.numel())
    return flat.reshape(q.shape)


# --------------------------- top-k sparsification --------------------------


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero all but the top-``frac`` fraction of entries by magnitude
    (every entry at least as large as the k-th largest survives). A
    dropped entry becomes +0.0, as the reference's masked product does
    once XLA turns it into a select."""
    flat = x.reshape(-1).float()
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    return torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape)


# --------------------------- error-feedback pipeline ------------------------


@dataclass
class CompressorConfig:
    scheme: str = "int8"       # "none" | "int8" | "topk" | "int8+topk"
    topk_frac: float = 0.05
    error_feedback: bool = True


def init_error_state(params):
    return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                    params)


def compress_delta(delta, cfg: CompressorConfig, error_state=None):
    """Compress an update tree. Returns (decoded_delta, new_error, bits).

    ``decoded_delta`` is what the server will see after decode (simulation
    runs both directions at once); ``bits`` is the wire size, which is what
    feeds ``M_i^UD`` in the BS algorithm.
    """
    if cfg.scheme == "none":
        bits = sum(32 * l.numel() for l in tree_leaves(delta))
        return delta, error_state, bits

    if error_state is None and cfg.error_feedback:
        error_state = init_error_state(delta)

    leaves_d = tree_leaves(delta)
    leaves_e = (
        tree_leaves(error_state) if error_state is not None
        else [None] * len(leaves_d)
    )
    out_d, out_e, bits_total = [], [], 0
    for d, e in zip(leaves_d, leaves_e):
        target = d.float()
        if cfg.error_feedback and e is not None:
            target = target + e
        comp = target
        bits = 0
        if "topk" in cfg.scheme:
            comp = topk_sparsify(comp, cfg.topk_frac)
            k = max(1, int(cfg.topk_frac * comp.numel()))
            bits += k * (32 + 32)           # value + index
        if "int8" in cfg.scheme:
            q, scale = quantize_int8(comp)
            comp = dequantize_int8(q, scale)
            if "topk" in cfg.scheme:
                k = max(1, int(cfg.topk_frac * comp.numel()))
                bits = k * (8 + 32) + 32    # int8 payload + index + scale
            else:
                bits = 8 * comp.numel() + 32
        elif "topk" not in cfg.scheme:
            bits = 32 * comp.numel()
        out_d.append(comp.to(d.dtype))
        out_e.append(target - comp if cfg.error_feedback else None)
        bits_total += bits

    decoded = tree_unflatten(delta, out_d)
    new_error = (
        tree_unflatten(delta, out_e) if cfg.error_feedback else None
    )
    return decoded, new_error, int(bits_total)


def compressed_update_bits(params, cfg: CompressorConfig) -> int:
    """Wire size of one update under ``cfg`` (without compressing)."""
    total = 0
    for l in tree_leaves(params):
        if cfg.scheme == "none":
            total += 32 * l.numel()
        elif cfg.scheme == "int8":
            total += 8 * l.numel() + 32
        elif cfg.scheme == "topk":
            total += max(1, int(cfg.topk_frac * l.numel())) * 64
        elif cfg.scheme == "int8+topk":
            total += max(1, int(cfg.topk_frac * l.numel())) * 40 + 32
    return total
