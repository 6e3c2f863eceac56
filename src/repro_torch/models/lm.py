"""Decoder-only language model assembled from the config-driven blocks.

Parameters mirror the reference package's pytree: the config's repeating
*pattern unit* is stored with a leading ``n_units`` axis on every leaf of
``params["units"]``, remainder layers (n_layers % unit_len) unstacked
under ``params["rem"]``. Where the reference scans the units with
``lax.scan``, the port loops over them in Python, over views of the
stacked leaves (``torch.unbind``: autograd stacks their gradients back
in one step). ``cfg.remat`` wraps one unit's call on the training path
as the reference wraps its scan body (``_remat_wrap``).

Entry points:
  ``forward_train``  — full logits over a sequence
  ``loss_fn``        — the training loss (cross-entropy)
  ``prefill``        — forward over the prompt, filling the KV caches
  ``decode_step``    — one token against the caches

Every block kind of the reference is ported: attention and RG-LRU
mixers with a dense MLP, Mamba-2 SSD blocks (no FFN), and attention
blocks whose FFN is a Mixture-of-Experts (``models/moe.py``), with
arctic's dense residual MLP beside it. The MoE load-balancing loss
(``aux``) is summed through the units as the reference carries it
through its scan: ``forward_train`` returns it beside the logits and
``loss_fn`` adds it.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import _dtensor
from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.configs.base import ATTN, RGLRU, SSD, LayerSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (
    apply_norm,
    embed_init,
    mlp_apply,
    mlp_init,
    norm_init,
    sinusoidal_embed,
    softmax_cross_entropy,
    torch_dtype,
)


def _add_abs_pos(x, cfg, positions):
    if cfg.abs_sinusoidal:
        x = x + sinusoidal_embed(positions, cfg.d_model).to(x.dtype)
    return x


def _tree_index(tree, u: int):
    """Unit ``u`` of a tree whose leaves carry a leading ``n_units`` axis."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, u) for k, v in tree.items()}
    return tree[u]


def _tree_unbind(tree, n: int) -> list:
    """The ``n`` units of a stacked tree, each leaf a view
    (``torch.unbind``; ``_dtensor.unbind`` on a mesh)."""
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][u] for k in parts} for u in range(n)]
    return list(_dtensor.unbind(tree))


def _stack_units(make, like, n: int, device):
    """``n`` units made by ``make``, stacked along a new leading axis
    without a second copy: the stacked leaves are allocated first
    (shapes and dtypes from ``like``, a unit on the meta device), then
    each unit is made and its leaves copied in. ``make(dest)`` gets the
    unit's views of the stack and may draw a leaf straight into its view
    (the MoE experts do, so a unit of them is never whole beside the
    stack)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=device)

    def put(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k])
        elif src is not dst:
            dst.copy_(src)

    out = alloc(like)
    for u in range(n):
        dest = _tree_index(out, u)
        put(dest, make(dest))
    return out


# ---------------------------------------------------------------------------
# block = mixer (attention, RG-LRU or SSD) + MLP or MoE, with pre-norms
# ---------------------------------------------------------------------------


def _block_init(generator, cfg: ModelConfig, spec: LayerSpec, device,
                dest=None):
    """A block's parameters; ``dest`` (a like tree of tensors, or None)
    receives the MoE experts in place (``moe_init``'s ``out``)."""
    p = {"mix_norm": norm_init(cfg, device=device)}
    if spec.kind == SSD:
        p["mixer"] = ssd_mod.ssd_block_init(generator, cfg, device=device)
    elif spec.kind == RGLRU:
        p["mixer"] = rglru_mod.rglru_block_init(generator, cfg,
                                                device=device)
    else:
        p["mixer"] = attn_mod.attn_init(generator, cfg, device=device)
    if spec.kind == SSD:                   # mamba2 blocks carry no FFN
        return p
    if cfg.moe is not None and spec.kind == ATTN:
        p["ffn_norm"] = norm_init(cfg, device=device)
        p["moe"] = moe_mod.moe_init(generator, cfg, device=device,
                                    out=None if dest is None
                                    else dest["moe"])
        if cfg.moe.dense_residual:         # arctic's dense branch
            p["mlp"] = mlp_init(generator, cfg, device=device)
    elif cfg.d_ff > 0:
        p["ffn_norm"] = norm_init(cfg, device=device)
        p["mlp"] = mlp_init(generator, cfg, device=device)
    return p


def _block_apply(params, x, cfg, spec, positions, mode, cache, pos):
    """(the block's output, its MoE aux loss or None); a prefill or
    decode writes ``cache`` in place."""
    h = apply_norm(params["mix_norm"], x, cfg)
    if spec.kind == SSD:
        full, fill, step = (ssd_mod.ssd_full, ssd_mod.ssd_prefill,
                            ssd_mod.ssd_decode)
    elif spec.kind == RGLRU:
        full, fill, step = (rglru_mod.rglru_full, rglru_mod.rglru_prefill,
                            rglru_mod.rglru_decode)
    else:
        full, fill, step = (attn_mod.attn_full, attn_mod.attn_prefill,
                            attn_mod.attn_decode)
    if mode == "train":
        mix = full(params["mixer"], h, cfg, spec, positions)
    elif mode == "prefill":
        mix, _ = fill(params["mixer"], h, cfg, spec, positions, cache)
    else:
        mix, _ = step(params["mixer"], h, cfg, spec, pos, cache)
    x = x + mix
    aux = None
    if "moe" in params:
        h2 = apply_norm(params["ffn_norm"], x, cfg)
        ffn_out, aux = moe_mod.moe_apply(params["moe"], h2, cfg)
        if "mlp" in params:                # arctic's dense residual
            ffn_out = ffn_out + mlp_apply(params["mlp"], h2, cfg)
        x = x + ffn_out
    elif "mlp" in params:
        h2 = apply_norm(params["ffn_norm"], x, cfg)
        x = x + mlp_apply(params["mlp"], h2, cfg)
    return x, aux


def _unit_init(generator, cfg: ModelConfig, pattern, device, dest=None):
    return {f"b{i}": _block_init(generator, cfg, spec, device,
                                 None if dest is None else dest[f"b{i}"])
            for i, spec in enumerate(pattern)}


def _unit_apply(params, x, cfg, pattern, positions, mode, cache, pos):
    """(the unit's output, the sum of its blocks' aux losses or None)."""
    aux = None
    for i, spec in enumerate(pattern):
        x, a = _block_apply(params[f"b{i}"], x, cfg, spec, positions, mode,
                            cache[f"b{i}"] if cache else None, pos)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def _init(cfg: ModelConfig, generator, device: torch.device) -> dict:
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                            cfg.param_dtype, device=device),
        "units": _stack_units(
            lambda dest: _unit_init(generator, cfg, cfg.pattern, device,
                                    dest),
            _unit_init(None, cfg, cfg.pattern, torch.device("meta")),
            cfg.n_units, device),
        "final_norm": norm_init(cfg, device=device),
    }
    if cfg.n_remainder:
        params["rem"] = _unit_init(generator, cfg, cfg.remainder_pattern,
                                   device)
    if not cfg.tie_embeddings:
        w = torch.randn((cfg.d_model, cfg.vocab_size), generator=generator,
                        device=device)
        params["lm_head"] = (w * 0.02).to(torch_dtype(cfg.param_dtype))
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=DEFAULT_DEVICE) -> dict:
    """Random parameters at the reference's scales, drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; seed 0 if None).
    On the meta device the leaves hold shapes and dtypes alone and
    nothing is drawn (``generator`` is not used)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _init(cfg, None, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _init(cfg, generator, dev)


def _lookup(table, tokens):
    """``table[tokens]``; on DTensors each rank looks its own tokens up
    in the whole table (a split table gathered first), so that the
    lookup and its backward are the plain ones on local tensors."""
    if _dtensor.is_dtensor(table):
        return _dtensor.local_kernel(lambda t, i: t[i], (table, tokens),
                                     ({}, {0: "batch"}), {0: "batch"})
    return table[tokens]


def _embed(params, cfg, tokens, extra_embeds):
    dt = torch_dtype(cfg.dtype)
    x = _lookup(params["embed"], tokens).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dt), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = apply_norm(params["final_norm"], x, cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(torch_dtype(cfg.dtype))
    logits = x @ head
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dimensions (``mm``, ``addmm``),
    recompute the rest: the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing by ``cfg.remat``: ``"full"``
    keeps only its inputs and recomputes it in the backward, ``"dots"``
    keeps the products too, ``"none"`` is ``fn``. Values never change."""
    if cfg.remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    if cfg.remat != "none":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return fn


def _run_stack(params, cfg, x, positions, mode, cache, pos):
    """Loop over the stacked units, then the remainder unit. On the
    training path (no cache, autograd on) each unit runs under
    ``_remat_wrap``. Returns (x, cache, aux): aux the float32 sum of
    the units' MoE aux losses, 0 without MoE."""
    unit_caches = cache["units"] if cache else None
    run = _unit_apply
    if cache is None and torch.is_grad_enabled():
        run = _remat_wrap(_unit_apply, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u, unit_params in enumerate(_tree_unbind(params["units"],
                                                 cfg.n_units)):
        x, a = run(unit_params, x, cfg, cfg.pattern, positions, mode,
                   None if unit_caches is None
                   else _tree_index(unit_caches, u), pos)
        if a is not None:
            aux = aux + a
    if cfg.n_remainder:
        x, a = _unit_apply(params["rem"], x, cfg, cfg.remainder_pattern,
                           positions, mode, cache["rem"] if cache else None,
                           pos)
        if a is not None:
            aux = aux + a
    if cache is None:
        return x, None, aux
    # the per-unit caches are views of the stacked tensors, written in place
    new_cache = dict(cache)
    new_cache["pos"] = (positions.shape[-1] if mode == "prefill"
                        else cache["pos"] + 1)
    return x, new_cache, aux


def forward_train(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """(full logits ``(B, S, V)``, the MoE aux loss: a 0-d float32
    tensor, 0 without MoE).

    tokens: (B, S_text) int; extra_embeds: (B, n_frontend, D) or None.
    """
    x = _embed(params, cfg, tokens, extra_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x = _add_abs_pos(x, cfg, positions)
    x, _, aux = _run_stack(params, cfg, x, positions, "train", None, None)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean cross-entropy in float32 plus the MoE aux loss. batch:
    ``tokens`` (B, S), ``labels`` (B, S), optional ``weights`` (B, S)
    and ``extra_embeds``."""
    extra = batch.get("extra_embeds")
    logits, aux = forward_train(params, cfg, batch["tokens"], extra)
    n_front = cfg.n_frontend_tokens if extra is not None else 0
    loss = softmax_cross_entropy(logits[:, n_front:], batch["labels"],
                                 batch.get("weights"))
    return loss + aux


# ---------------------------------------------------------------------------
# caches / serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=DEFAULT_DEVICE) -> dict:
    """Caches: ``units`` stacked over ``n_units``, ``rem`` for the
    remainder layers, ``pos`` (an int) the tokens cached so far.

    As in the reference, every stacked leaf is zeros (an int8 cache's
    scales too, where ``init_layer_cache`` sets ones: the reference
    builds the stack with ``jnp.zeros`` of each leaf's shape); the
    remainder unit's caches are ``init_layer_cache``'s own. The two
    differ only in slots that no decode reads before writing."""
    dev = resolve_device(device)

    def block(spec):
        if spec.kind == SSD:
            return ssd_mod.init_ssd_cache(cfg, batch, device=dev)
        if spec.kind == RGLRU:
            return rglru_mod.init_rglru_cache(cfg, batch, device=dev)
        return attn_mod.init_layer_cache(cfg, spec, batch, max_len,
                                         device=dev)

    def unit(pattern):
        return {f"b{i}": block(spec) for i, spec in enumerate(pattern)}

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return tree.new_zeros((cfg.n_units,) + tuple(tree.shape))

    cache = {"units": zeros(unit(cfg.pattern)), "pos": 0}
    if cfg.n_remainder:
        cache["rem"] = unit(cfg.remainder_pattern)
    return cache


def prefill(params, cfg: ModelConfig, tokens, cache, extra_embeds=None):
    """Forward over the prompt, filling caches (in place). Returns
    (logits of the last position ``(B, 1, V)``, cache)."""
    x = _embed(params, cfg, tokens, extra_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    x = _add_abs_pos(x, cfg, positions)
    x, new_cache, _ = _run_stack(params, cfg, x, positions, "prefill",
                                 cache, None)
    return _logits(params, cfg, x[:, -1:]), new_cache


def decode_step(params, cfg: ModelConfig, token, cache):
    """token: (B, 1) int. Returns (logits (B, 1, V), cache)."""
    pos = int(cache["pos"])
    x = _embed(params, cfg, token, None)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    x = _add_abs_pos(x, cfg, positions)
    x, new_cache, _ = _run_stack(params, cfg, x, positions, "decode", cache,
                                 pos)
    return _logits(params, cfg, x), new_cache
