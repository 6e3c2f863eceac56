"""Grouped-query attention with RoPE, sliding windows, qk-norm and KV caches.

Public layouts follow the reference package: q/k/v ``(B, S, H, Dh)``,
caches ``(B, cap, K*Dh)`` with post-RoPE keys, a ring buffer for
windowed layers (slot = position % cap).

Full-sequence attention (training forward, prefill) dispatches on
``cfg.attn_impl``:

* ``"pallas"`` and ``"chunked"`` both go to
  ``kernels.attention.ops.flash_attention``: on a card the hand-written
  flash kernel K4, on the CPU its plain version. The reference package
  runs the Pallas kernel for ``"pallas"`` and its XLA flash scan
  (``flash_xla``) for ``"chunked"``; both are the same tiled
  online-softmax forward of one function, which the Hopper kernel is
  here. So olmo-1b's own config (``attn_impl="chunked"``) runs the
  kernel.
* ``"reference"`` goes to the plain ``_sdpa`` with an explicit mask.

Decode (one query against the cache) always runs ``_sdpa``: a plain
product, as in the reference. The caches are written in place: the
tensors of the ``cache`` passed in are updated and returned in a new
dict, so a caller keeps using the returned cache and drops the old one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.attention import ops as flash_ops
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
    a ring buffer of ``cap = min(window, max_len)`` slots if windowed."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP Queue 1 item 10)")
    cap = max_len if spec.window is None else min(spec.window, max_len)
    shape = (batch, cap, cfg.n_kv_heads * cfg.d_head)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


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
    qg = q.reshape(B, S, Kh, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (Dh ** -0.5)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H * Dh)


def _project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, H, Dh)
    k = (x @ params["wk"].to(dt)).reshape(B, S, K, Dh)
    v = (x @ params["wv"].to(dt)).reshape(B, S, K, Dh)
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
    if cfg.attn_impl in ("pallas", "chunked"):
        out = flash_ops.flash_attention(q, k, v, causal=True,
                                        window=spec.window)
        return out.reshape(out.shape[0], seq, cfg.n_heads * cfg.d_head)
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
    if S >= cap:
        # keep the last `cap` tokens, rolled so slot = position % cap
        shift = S % cap
        cache["k"].copy_(torch.roll(kf[:, S - cap:], shifts=shift, dims=1))
        cache["v"].copy_(torch.roll(vf[:, S - cap:], shifts=shift, dims=1))
    else:
        cache["k"][:, :S] = kf
        cache["v"][:, :S] = vf
    return out @ params["wo"].to(x.dtype), {"k": cache["k"],
                                            "v": cache["v"]}


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
    cache["k"][:, slot] = k.reshape(B, KD)
    cache["v"][:, slot] = v.reshape(B, KD)
    if spec.window is not None and pos + 1 >= cap:
        # ring: slots hold tokens (pos-cap, pos]; all valid after wrap-around
        valid = torch.ones(cap, dtype=torch.bool, device=x.device)
    else:
        valid = torch.arange(cap, device=x.device) <= pos
    K, Dh = cfg.n_kv_heads, cfg.d_head
    out = _sdpa(q, cache["k"].reshape(B, cap, K, Dh),
                cache["v"].reshape(B, cap, K, Dh), valid)
    return out @ params["wo"].to(x.dtype), {"k": cache["k"],
                                            "v": cache["v"]}
