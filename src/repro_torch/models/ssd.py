"""Mamba-2 mixer built on SSD (state-space duality) — arXiv:2405.21060.

Block: in_proj -> [z | xBC | dt] -> causal conv on xBC -> SiLU ->
SSD recurrence over heads -> gated RMSNorm(y * silu(z)) -> out_proj.

The full-sequence forward (training forward, prefill) runs the chunked
SSD scan through ``kernels.ssd.ops.ssd_scan``: on a card the
hand-written kernel K5, on the CPU its plain version
(``kernels.ssd.ref.ssd_chunked_ref``, the reference package's
``ssd_chunked`` with the in-chunk exponent masked before ``exp``). The
decode is the one-token recurrence in plain ops, as in the reference
package. A prefill or decode writes the layer's cache (``h``, ``conv``)
in place and returns the same tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.models.rglru import causal_conv1d


def ssd_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.d_head
    d_xbc = d_inner + 2 * s.d_state
    return d_inner, n_heads, d_xbc


def ssd_block_init(generator, cfg: ModelConfig, device=None) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    d_inner, n_heads, d_xbc = ssd_dims(cfg)
    dt = cfg.param_dtype
    tdt = torch_dtype(dt)
    d_proj = d_inner + d_xbc + n_heads  # z | xBC | dt
    conv_w = torch.randn((s.d_conv, d_xbc), generator=generator,
                         device=device) * (s.d_conv ** -0.5)
    return {
        "in_proj": dense_init(generator, D, d_proj, dt, device=device),
        "conv_w": conv_w.to(tdt),
        "a_log": torch.zeros((n_heads,), dtype=tdt, device=device),  # A = -1
        "dt_bias": torch.zeros((n_heads,), dtype=tdt, device=device),
        "d_skip": torch.ones((n_heads,), dtype=tdt, device=device),
        "gate_norm_scale": torch.ones((d_inner,), dtype=tdt, device=device),
        "out_proj": dense_init(generator, d_inner, D, dt, device=device),
    }


def _split_proj(params, x, cfg: ModelConfig):
    d_inner, n_heads, d_xbc = ssd_dims(cfg)
    proj = x @ params["in_proj"].to(x.dtype)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: d_inner + d_xbc]
    dt_raw = proj[..., d_inner + d_xbc:]
    return z, xbc, dt_raw


def _conv_split(params, xbc, cfg: ModelConfig, conv_state=None):
    s = cfg.ssm
    d_inner, _, _ = ssd_dims(cfg)
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner]
    B_mat = xbc[..., d_inner: d_inner + s.d_state]
    C_mat = xbc[..., d_inner + s.d_state:]
    return xs, B_mat, C_mat, new_conv


def _gated_norm(y, z, scale, eps: float = 1e-6):
    g = y * F.silu(z.to(y.dtype))
    ms = g.square().mean(dim=-1, keepdim=True)
    return g * torch.rsqrt(ms + eps) * scale.to(y.dtype)


def _dt_a(params, dt_raw):
    """Step sizes ``softplus(dt_raw + dt_bias)`` and decay rates
    ``-exp(a_log)``, in float32."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def _ssd_core(params, x, cfg, conv_state=None, h0=None):
    s = cfg.ssm
    d_inner, n_heads, _ = ssd_dims(cfg)
    Bsz, S, _ = x.shape
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xs, B_mat, C_mat, new_conv = _conv_split(params, xbc, cfg, conv_state)
    dt, a = _dt_a(params, dt_raw)
    xh = xs.reshape(Bsz, S, n_heads, s.d_head)
    y, h_last = ssd_ops.ssd_scan(xh, B_mat, C_mat, dt, a, s.chunk, h0)
    y = y + xh.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["gate_norm_scale"])
    return y @ params["out_proj"].to(x.dtype), new_conv, h_last


def ssd_full(params, x, cfg: ModelConfig, spec, positions):
    y, _, _ = _ssd_core(params, x, cfg)
    return y


def init_ssd_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Cache of one SSD layer: the state ``h`` ``(B, H, P, N)`` float32
    and the last ``d_conv - 1`` conv inputs ``(B, d_conv - 1, d_xbc)`` in
    ``cfg.dtype``."""
    s = cfg.ssm
    d_inner, n_heads, d_xbc = ssd_dims(cfg)
    return {
        "h": torch.zeros((batch, n_heads, s.d_head, s.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def ssd_prefill(params, x, cfg, spec, positions, cache):
    y, new_conv, h_last = _ssd_core(params, x, cfg, cache["conv"],
                                    cache["h"])
    cache["h"].copy_(h_last)
    cache["conv"].copy_(new_conv)
    return y, {"h": cache["h"], "conv": cache["conv"]}


def ssd_decode(params, x, cfg, spec, pos, cache):
    """Single-token state update. x: (B,1,D)."""
    s = cfg.ssm
    d_inner, n_heads, _ = ssd_dims(cfg)
    Bsz = x.shape[0]
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xs, B_mat, C_mat, new_conv = _conv_split(params, xbc, cfg, cache["conv"])
    dt, a = _dt_a(params, dt_raw[:, 0])                  # (B, H), (H,)
    xh = xs[:, 0].reshape(Bsz, n_heads, s.d_head).float()
    dA = torch.exp(dt * a[None, :])                      # (B, H)
    inc = torch.einsum("bh,bn,bhp->bhpn", dt, B_mat[:, 0].float(), xh)
    h = cache["h"] * dA[..., None, None] + inc
    y = torch.einsum("bn,bhpn->bhp", C_mat[:, 0].float(), h)
    y = y + xh * params["d_skip"].float()[None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["gate_norm_scale"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return y @ params["out_proj"].to(x.dtype), {"h": cache["h"],
                                                "conv": cache["conv"]}
