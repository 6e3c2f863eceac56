"""Shared neural-net building blocks, as plain functions on tensors.

Parameters are nested dicts of tensors mirroring the reference package's
pytrees; every block exposes ``init(generator, cfg, ..., device) ->
params`` and ``apply(params, x, ...) -> y``. Parameters are stored in
``cfg.param_dtype`` and cast to the compute dtype of ``x`` at each use;
norms, RoPE and softmax run in fp32 inside. Initial values are drawn from
an explicit ``torch.Generator`` (which must live on ``device``) at the
reference's scales; they cannot equal ``jax.random``'s bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import _dtensor
from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, ...)."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator, d_in: int, d_out: int, dtype, scale=None,
               device=None) -> torch.Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    return (w * scale).to(torch_dtype(dtype))


def embed_init(generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device)
    return (w * 0.02).to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d: int | None = None, device=None) -> dict:
    d = d or cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    if cfg.norm == "layernorm_nonparam":          # olmo: no scale / bias
        return {}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dt, device=device),
                "bias": torch.zeros((d,), dtype=dt, device=device)}
    return {"scale": torch.ones((d,), dtype=dt, device=device)}  # rmsnorm


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm.startswith("layernorm"):
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if params:
            y = y * params["scale"].float() + params["bias"].float()
        return y.to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)   # rmsnorm
    y = xf * torch.rsqrt(ms + eps)
    if params:
        y = y * params["scale"].float()
    return y.to(x.dtype)


def rms_head_norm_init(d_head: int, dtype, device=None) -> dict:
    """qk-norm (qwen3): RMSNorm over the head dimension."""
    return {"scale": torch.ones((d_head,), dtype=torch_dtype(dtype),
                                device=device)}


def apply_head_norm(params: dict, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32,
                             device=device) / d_head
    return 1.0 / (theta ** exponents)  # (d_head//2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq) int.

    Split-half layout: the first and second halves of the head dim are
    the two coordinates of each rotated pair.
    """
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs         # (..., s, d/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., s, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embed(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding. positions: (..., S) int."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_init(generator, cfg: ModelConfig, d_ff: int | None = None,
             device=None) -> dict:
    d_ff = cfg.d_ff if d_ff is None else d_ff
    dt, D = cfg.param_dtype, cfg.d_model
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": dense_init(generator, D, d_ff, dt, device=device),
            "w_up": dense_init(generator, D, d_ff, dt, device=device),
            "w_down": dense_init(generator, d_ff, D, dt, device=device),
        }
    return {
        "w_in": dense_init(generator, D, d_ff, dt, device=device),
        "w_down": dense_init(generator, d_ff, D, dt, device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act == "swiglu":
        gate = x @ params["w_gate"].to(dt)
        up = x @ params["w_up"].to(dt)
        h = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_in"].to(dt), approximate="tanh")
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor | None = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy in float32: logits (..., V) of any float dtype,
    integer labels (...), optional weights (...) for a weighted mean over
    at least 1; ``z_loss`` adds ``z_loss * logsumexp**2``. DTensor
    logits are first made whole along the vocabulary on every rank."""
    logits = _dtensor.whole_dim(logits, -1).float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if weights is None:
        return torch.mean(loss)
    total = torch.clamp(torch.sum(weights), min=1.0)
    return torch.sum(loss * weights) / total
