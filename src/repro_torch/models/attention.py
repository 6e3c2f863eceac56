"""Grouped-query attention with RoPE, sliding windows, qk-norm and KV caches.

Public layouts follow the reference package: q/k/v ``(B, S, H, Dh)``,
caches ``(B, cap, K*Dh)`` with post-RoPE keys, a ring buffer for
windowed layers (slot = position % cap).

Full-sequence attention (training forward, prefill) dispatches on
``cfg.attn_impl``:

* ``"pallas"`` goes to ``kernels.attention.ops.flash_attention``, as the
  reference sends it to its Pallas kernel: on a card the hand-written
  flash kernel K4, whose backward (training) recomputes the plain
  attention under autograd, the reference's ``pallas`` backward; on the
  CPU the plain version.
* ``"chunked"``, every config's own, goes to
  ``models.flash_xla.flash_attention_xla``, as the reference sends it to
  its memory-linear XLA flash scan: in training K4 writing each row's
  log-sum-exp and the hand-written backward from it (their plain
  versions on the CPU); with no gradient (prefill) K4 alone, as
  ``"pallas"`` runs it.
* ``"reference"`` goes to the plain ``_sdpa`` with an explicit mask.

Decode (one query against the cache) always runs ``_sdpa``: a plain
product, as in the reference. With ``kv_cache_dtype="int8"`` the cache
holds per-row int8 codes and float32 scales (``_quant_rows``): prefill
attends over the unquantised k and v and writes the codes, decode
quantises its new row and dequantises the whole cache before ``_sdpa``. The caches are written in place: the
tensors of the ``cache`` passed in are updated and returned in a new
dict, so a caller keeps using the returned cache and drops the old one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _dtensor
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.models import flash_xla
from repro_torch.models.layers import (
    apply_head_norm,
    apply_rope,
    dense_init,
    rms_head_norm_init,
    torch_dtype,
)

NEG_INF = -1e30


def attn_init(generator, cfg: ModelConfig, device=None) -> dict:
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.param_dtype
    p = {
        "wq": dense_init(generator, D, H * Dh, dt, device=device),
        "wk": dense_init(generator, D, K * Dh, dt, device=device),
        "wv": dense_init(generator, D, K * Dh, dt, device=device),
        "wo": dense_init(generator, H * Dh, D, dt, scale=(H * Dh) ** -0.5,
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_head_norm_init(Dh, dt, device=device)
        p["k_norm"] = rms_head_norm_init(Dh, dt, device=device)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device=None) -> dict:
    """Cache of one attention layer, ``(B, cap, K*Dh)`` in ``cfg.dtype``;
    a ring buffer of ``cap = min(window, max_len)`` slots if windowed.

    With ``kv_cache_dtype="int8"`` the payload is int8 and each
    (batch, slot) row carries a float32 scale, ``k_scale``/``v_scale``
    ``(B, cap)``, set to ones as the reference sets them.
    """
    cap = max_len if spec.window is None else min(spec.window, max_len)
    shape = (batch, cap, cfg.n_kv_heads * cfg.d_head)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones((batch, cap), dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones((batch, cap), dtype=torch.float32,
                                      device=device)}
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _quant_rows(x: torch.Tensor):
    """x: (B, S, KD) -> (int8 codes, float32 scales (B, S)), symmetric
    per row: ``scale = amax / 127`` (1 for a zero row), codes rounded
    half to even and clipped to +-127. The scale is a division, as the
    reference computes it eagerly."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _mask_full(seq_q: int, seq_k: int, window: Optional[int],
               device=None) -> torch.Tensor:
    """Causal (+window) mask ``(seq_q, seq_k)`` for full-sequence attention."""
    qi = torch.arange(seq_q, device=device)[:, None]
    kj = torch.arange(seq_k, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,Dh) k,v: (B,T,K,Dh) mask: broadcastable to (B,K,G,S,T).

    Scores in fp32 (the products of the working dtype summed in fp32),
    softmax in fp32, weights cast back to q's dtype for the value product.
    Returns ``(B, S, H*Dh)``.
    """
    B, S, H, Dh = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = _dtensor.unflatten(q, 2, (Kh, G))
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (Dh ** -0.5)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return _dtensor.merge(out, 2, 3)                      # (B, S, H*Dh)


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q = _dtensor.unflatten(x @ params["wq"].to(dt), 2, (H, Dh))
    k = _dtensor.unflatten(x @ params["wk"].to(dt), 2, (K, Dh))
    v = _dtensor.unflatten(x @ params["wv"].to(dt), 2, (K, Dh))
    if cfg.qk_norm:
        q = apply_head_norm(params["q_norm"], q)
        k = apply_head_norm(params["k_norm"], k)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend_full(q, k, v, cfg: ModelConfig, spec: LayerSpec,
                 seq: int) -> torch.Tensor:
    """Dispatch full-sequence attention by ``cfg.attn_impl``."""
    if cfg.attn_impl == "pallas":
        out = flash_ops.flash_attention(q, k, v, causal=True,
                                        window=spec.window)
        return _dtensor.merge(out, 2, 2)                  # (B, S, H*Dh)
    if cfg.attn_impl == "chunked":
        out = flash_xla.flash_attention_xla(q, k, v, causal=True,
                                            window=spec.window)
        return _dtensor.merge(out, 2, 2)
    if cfg.attn_impl != "reference":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    mask = _mask_full(seq, seq, spec.window, device=q.device)
    return _sdpa(q, k, v, mask)


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig,
              spec: LayerSpec, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (training forward / prefill compute)."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend_full(q, k, v, cfg, spec, x.shape[1])
    return out @ params["wo"].to(x.dtype)


def attn_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 spec: LayerSpec, positions: torch.Tensor, cache: dict):
    """Full attention + fill the layer cache (ring layout for windows)."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend_full(q, k, v, cfg, spec, x.shape[1])
    cap = cache["k"].shape[1]
    B, S = x.shape[:2]
    KD = cache["k"].shape[2]
    kf = k.reshape(B, S, KD)
    vf = v.reshape(B, S, KD)
    parts = [("k", kf), ("v", vf)]
    if "k_scale" in cache:        # the cache holds int8; attention read kf, vf
        kq, ks = _quant_rows(kf)
        vq, vs = _quant_rows(vf)
        parts = [("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)]
    for name, t in parts:
        if S >= cap:
            # keep the last `cap` tokens, rolled so slot = position % cap
            cache[name].copy_(torch.roll(t[:, S - cap:], shifts=S % cap,
                                         dims=1))
        else:
            cache[name][:, :S] = t
    return out @ params["wo"].to(x.dtype), {n: cache[n] for n, _ in parts}


def attn_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                spec: LayerSpec, pos: int, cache: dict):
    """One-token decode against the cache.

    x: (B, 1, D); pos: int — absolute position of the new token
    (== number of tokens already in the cache).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    cap = cache["k"].shape[1]
    KD = cache["k"].shape[2]
    slot = pos % cap if spec.window is not None else pos
    kf, vf = k.reshape(B, KD), v.reshape(B, KD)
    quant = "k_scale" in cache
    if quant:
        kf, ks = _quant_rows(kf)
        vf, vs = _quant_rows(vf)
        cache["k_scale"][:, slot] = ks
        cache["v_scale"][:, slot] = vs
    cache["k"][:, slot] = kf
    cache["v"][:, slot] = vf
    if spec.window is not None and pos + 1 >= cap:
        # ring: slots hold tokens (pos-cap, pos]; all valid after wrap-around
        valid = torch.ones(cap, dtype=torch.bool, device=x.device)
    else:
        valid = torch.arange(cap, device=x.device) <= pos
    K, Dh = cfg.n_kv_heads, cfg.d_head
    if quant:      # the whole cache to the compute dtype, as the reference
        k_read = _dequant_rows(cache["k"], cache["k_scale"], x.dtype)
        v_read = _dequant_rows(cache["v"], cache["v_scale"], x.dtype)
    else:
        k_read, v_read = cache["k"], cache["v"]
    out = _sdpa(q, _dtensor.unflatten(k_read, 2, (K, Dh)),
                _dtensor.unflatten(v_read, 2, (K, Dh)), valid)
    return out @ params["wo"].to(x.dtype), dict(cache)
