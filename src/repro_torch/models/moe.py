"""Mixture-of-Experts layer: top-k routing, capacity-based GShard dispatch.

The port of the reference package's ``models/moe.py``. Expert weights
are stacked along a leading expert axis ``(E, d_in, d_out)``. Tokens go
through in GShard groups of about ``moe.group_tokens``; each expert
takes at most ``capacity`` tokens of a group, slot 0 of every token
first, then slot 1 and so on, and the rest are dropped. The reference
builds one-hot ``(n, E, C)`` dispatch and combine tensors and contracts
them; the port computes the same function with an index gather into the
``(E, C, D)`` expert inputs and a gather of the ``top_k`` expert outputs
of each token, which hold at most one token a slot, so no sum changes.

The router runs in full float32 (no TF32: it picks the experts), and
``top_k`` breaks ties by the lower expert index, as ``jax.lax.top_k``
does. The combine weights are rounded to the compute dtype before the
product, as the reference's ``combine.astype(dt)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import full_float32
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, torch_dtype


def moe_init(generator, cfg: ModelConfig, device=None, out=None) -> dict:
    """Router ``(D, E)`` and experts ``(E, D, F)``, ``(E, D, F)``,
    ``(E, F, D)`` in ``param_dtype``. Each expert is drawn alone and
    written into its stacked leaf (``out``'s tensors where given, else
    new ones), so no leaf is ever held twice."""
    e = cfg.moe
    D, E, Fe = cfg.d_model, e.n_experts, e.d_ff_expert
    dt = cfg.param_dtype

    def stack_init(name, d_in, d_out):
        w = (out[name] if out is not None else
             torch.empty((E, d_in, d_out), dtype=torch_dtype(dt),
                         device=device))
        if w.is_meta:        # shapes alone (launch/specs.py): no draws
            return w
        for i in range(E):
            w[i] = dense_init(generator, d_in, d_out, dt, device=device)
        return w

    return {
        "router": dense_init(generator, D, E, dt, scale=0.02, device=device),
        "w_gate": stack_init("w_gate", D, Fe),
        "w_up": stack_init("w_up", D, Fe),
        "w_down": stack_init("w_down", Fe, D),
    }


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, equal values in order of their index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int,
           capacity: int):
    """Route one group ``xt`` ``(n, D)``. Returns the router's
    probabilities ``(n, E)`` float32, the experts ``(n, k)``, their
    normalised gate weights ``(n, k)`` float32, each choice's position
    in its expert ``(n, k)`` (GShard order: slot 0 of every token, then
    slot 1, ...) and whether it is kept (``pos < capacity``)."""
    n = xt.shape[0]
    E = router.shape[1]
    with full_float32():
        logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_val, gate_idx = _top_k(probs, top_k)
    gate_val = gate_val / torch.clamp_min(
        gate_val.sum(dim=-1, keepdim=True), 1e-9)
    flat = gate_idx.T.reshape(-1)                        # (k*n,) slot-major
    onehot = F.one_hot(flat, E)
    before = torch.cumsum(onehot, dim=0) - onehot        # earlier picks
    pos = before.gather(1, flat[:, None])[:, 0].view(top_k, n).T
    return probs, gate_idx, gate_val, pos, pos < capacity


def _moe_group(params: dict, xt: torch.Tensor, cfg: ModelConfig,
               capacity: int):
    """Dispatch and compute one token group. xt: (n, D) -> (y, aux)."""
    e = cfg.moe
    n, D = xt.shape
    dt = xt.dtype
    E, C = e.n_experts, capacity
    probs, gate_idx, gate_val, pos, keep = _route(xt, params["router"],
                                                  e.top_k, capacity)
    slot = torch.where(keep, gate_idx * C + pos, 0)       # (n, k) in E*C
    # a dropped choice is written to the spare row E*C, cut off after,
    # so that no shape depends on the routing
    dest = torch.where(keep, slot, E * C).reshape(-1)
    expert_in = xt.new_zeros((E * C + 1, D))    # a DTensor like xt
    expert_in.index_put_((dest,), xt[:, None].expand(n, e.top_k, D)
                         .reshape(-1, D))
    expert_in = expert_in[:E * C].view(E, C, D)
    h = F.silu(torch.bmm(expert_in, params["w_gate"].to(dt))) * torch.bmm(
        expert_in, params["w_up"].to(dt))
    expert_out = torch.bmm(h, params["w_down"].to(dt)).view(E * C, D)
    combine = torch.where(keep, gate_val, 0.0).to(dt)     # (n, k)
    y = (combine.float()[..., None] * expert_out[slot].float()).sum(1)

    top1 = gate_idx[:, 0]
    frac_tokens = top1.new_zeros(E).scatter_add(
        0, top1, torch.ones_like(top1)).float() / n
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y.to(dt), aux * e.load_balance_weight


def _n_groups(n_tokens: int, group_tokens: int) -> int:
    """Largest power-of-two group count with groups >= ~group_tokens."""
    g = 1
    while n_tokens % (g * 2) == 0 and n_tokens // (g * 2) >= group_tokens:
        g *= 2
    return g


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float | None = None):
    """x: (B, S, D) -> (y, aux_loss), aux a 0-d float32 tensor.

    Tokens are processed in GShard groups (``moe.group_tokens``), one
    after another, as the reference maps over them; the aux loss is the
    mean over groups.
    """
    e = cfg.moe
    if capacity_factor is None:
        capacity_factor = e.capacity_factor
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    g = _n_groups(N, e.group_tokens)
    n = N // g
    capacity = int(max(e.top_k, capacity_factor * n * e.top_k / e.n_experts))
    capacity = min(capacity, n)
    ys, auxs = zip(*(_moe_group(params, xi, cfg, capacity)
                     for xi in xt.split(n)))
    return torch.cat(ys).reshape(B, S, D), torch.stack(auxs).mean()
