"""Griffin / RecurrentGemma recurrent block (RG-LRU) — arXiv:2402.19427.

Temporal-mixing block: two branches from the (pre-normed) input,
  branch1 = GeLU(x @ W_b1)                      (gate branch)
  branch2 = RG-LRU(causal_conv1d(x @ W_b2))     (recurrent branch)
  out     = (branch1 * branch2) @ W_out

RG-LRU recurrence (element-wise, width R):
  r_t = sigmoid(u_t @ W_a + b_a)            recurrence gate
  i_t = sigmoid(u_t @ W_i + b_i)            input gate
  log_a_t = -c * softplus(Lambda) * r_t
  h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2*log_a_t)) * (i_t * u_t)

The gates are float32 products whatever the compute dtype, as in the
reference package. ``softplus`` is ``F.softplus`` (linear above 20; the
reference's ``jax.nn.softplus`` has no threshold, which is the same
function within float32 rounding at the block's ``Lambda`` values), and
GeLU the tanh approximation (``jax.nn.gelu``'s default). The
full-sequence forward (training forward, prefill) runs the linear scan
through ``kernels.rglru.ops.rglru_scan``: on a card the hand-written
kernel K6, on the CPU its plain version. Where the reference adds
``a_0 * h0`` into the first input and scans from zero, the scan here
takes ``h0`` itself: the same function, rounded in another order. The
decode is the one-token recurrence in plain ops, as in the reference. A
prefill or decode writes the layer's cache (``h``, ``conv``) in place
and returns the same tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.layers import dense_init, torch_dtype


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  conv_state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,R), w: (d_conv,R).

    conv_state: (B, d_conv-1, R) previous tokens (decode) or None (train).
    Returns (y, new_state) where new_state holds the trailing d_conv-1
    tokens (a view of a new tensor, never of ``conv_state``).
    """
    d_conv = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], d_conv - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+d_conv-1, R)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(d_conv):                          # d_conv is tiny (4)
        y = y + xp[:, i: i + S] * w[i].to(x.dtype)
    return y, xp[:, -(d_conv - 1):]


def _log_a(lam: torch.Tensor, r: torch.Tensor, c_const: float):
    return -c_const * F.softplus(lam.float()) * r


def _gate_input(log_a: torch.Tensor, i: torch.Tensor, u: torch.Tensor):
    """``sqrt(max(1 - exp(2 log_a), 1e-12)) * (i * u)``."""
    return torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                      1e-12)) * (i * u)


def rglru_scan(u, r, i, lam, c_const: float, h0=None) -> torch.Tensor:
    """RG-LRU over a sequence. u, r, i: (B,S,R) float32; lam: (R,);
    h0: (B,R) float32 or None. Returns h (B,S,R) float32."""
    log_a = _log_a(lam, r, c_const)
    return rglru_ops.rglru_scan(torch.exp(log_a), _gate_input(log_a, i, u),
                                h0)


def rglru_block_init(generator, cfg: ModelConfig, device=None) -> dict:
    D = cfg.d_model
    R = cfg.recurrent.rnn_width
    dc = cfg.recurrent.d_conv
    dt = cfg.param_dtype
    tdt = torch_dtype(dt)
    conv_w = torch.randn((dc, R), generator=generator,
                         device=device) * (dc ** -0.5)
    return {
        "w_branch1": dense_init(generator, D, R, dt, device=device),
        "w_branch2": dense_init(generator, D, R, dt, device=device),
        "conv_w": conv_w.to(tdt),
        "w_a": dense_init(generator, R, R, dt, device=device),
        "b_a": torch.zeros((R,), dtype=tdt, device=device),
        "w_i": dense_init(generator, R, R, dt, device=device),
        "b_i": torch.zeros((R,), dtype=tdt, device=device),
        # softplus(2) ~ 2.1 -> moderate decay
        "lam": torch.full((R,), 2.0, dtype=tdt, device=device),
        "w_out": dense_init(generator, R, D, dt, device=device),
    }


def _branches(params, x, cfg: ModelConfig, conv_state=None):
    dt = x.dtype
    b1 = F.gelu(x @ params["w_branch1"].to(dt), approximate="tanh")
    u = x @ params["w_branch2"].to(dt)
    u, new_conv = causal_conv1d(u, params["conv_w"], conv_state)
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(uf @ params["w_i"].float() + params["b_i"])
    return b1, uf, r, i, new_conv


def _out(params, b1, h, x):
    return (b1 * h.to(x.dtype)) @ params["w_out"].to(x.dtype)


def rglru_full(params, x, cfg: ModelConfig, spec=None, positions=None):
    b1, u, r, i, _ = _branches(params, x, cfg)
    h = rglru_scan(u, r, i, params["lam"], cfg.recurrent.c_const)
    return _out(params, b1, h, x)


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Cache of one RG-LRU layer: the state ``h`` ``(B, R)`` float32 and
    the last ``d_conv - 1`` conv inputs ``(B, d_conv - 1, R)`` in
    ``cfg.dtype``."""
    R = cfg.recurrent.rnn_width
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.recurrent.d_conv - 1, R),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def rglru_prefill(params, x, cfg, spec, positions, cache):
    b1, u, r, i, new_conv = _branches(params, x, cfg, cache["conv"])
    h = rglru_scan(u, r, i, params["lam"], cfg.recurrent.c_const,
                   cache["h"])
    cache["h"].copy_(h[:, -1])
    cache["conv"].copy_(new_conv)
    return _out(params, b1, h, x), {"h": cache["h"], "conv": cache["conv"]}


def rglru_decode(params, x, cfg, spec, pos, cache):
    """x: (B,1,D)."""
    b1, u, r, i, new_conv = _branches(params, x, cfg, cache["conv"])
    log_a = _log_a(params["lam"], r[:, 0], cfg.recurrent.c_const)
    h = torch.exp(log_a) * cache["h"] + _gate_input(log_a, i[:, 0], u[:, 0])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return _out(params, b1, h[:, None], x), {"h": cache["h"],
                                             "conv": cache["conv"]}
