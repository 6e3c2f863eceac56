"""The port's LM stack against the JAX package's, on the CPU.

Configs must equal the reference's field by field. Blocks (norms, RoPE,
MLPs) and the whole model are fed the same inputs (numpy seeds) and the
same weights: the reference's ``init_params`` pytree, carried across by
``models.convert.from_reference_params``. At smoke size in float32,
``forward_train``, ``prefill`` (logits and caches) and 8 teacher-forced
``decode_step``s (both sides fed the reference's greedy tokens, so a
near tie cannot fork the sequences) must agree within 2e-5: the same
float32 arithmetic summed in another order. Every ``attn_impl`` is run:
the port sends ``pallas`` and ``chunked`` to its flash-attention op (the
plain version on the CPU), the reference to its Pallas kernel (interpret
mode) and its XLA flash scan. mamba2-780m's smoke model (2 SSD layers,
heads of 16, state 16, chunk 8) is held the same way, its ``h``/``conv``
caches included, on ragged (12 tokens over chunks of 8) and whole (16)
prompts: at chunk 8 the reference's in-chunk product is finite (caveat
C5 shows only past ~88.7 of summed dt |a| in one chunk). On the CPU the
port runs its plain chunked scan; K5 runs on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). recurrentgemma-2b's
smoke model (rec, rec, local attention with a window of 8, MQA, heads of
16, RNN width 64) and its ``n_layers=8`` variant (two units and a
remainder unit of two RG-LRU layers, as the full model has) are held
the same way under ``reference`` and ``chunked`` attention, every cache
of every layer included, on 12-token prompts and 8 decode steps, so the
windowed layers' ring buffer of 8 slots wraps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssd as jssd
from repro_torch import configs as tcfgs
from repro_torch.configs.base import ATTN, RGLRU, SSD, LayerSpec, MoEConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssd as tssd
from repro_torch.models.convert import from_reference_params

TOL = dict(atol=2e-5, rtol=2e-5)
IMPLS = ("reference", "pallas", "chunked")
BATCH, PROMPT, N_DECODE = 2, 12, 8


def _np_tree(tree):
    """Writable numpy copies of a JAX pytree's leaves."""
    return jax.tree.map(np.array, tree)


def _torch_cfg(jcfg):
    """The port's config with the same fields as a reference config."""
    kw = dataclasses.asdict(jcfg)
    kw["pattern"] = tuple(LayerSpec(**s) for s in kw["pattern"])
    for key, cls in (("moe", tcfgs.MoEConfig), ("ssm", tcfgs.SSMConfig),
                     ("recurrent", tcfgs.RecurrentConfig)):
        if kw[key] is not None:
            kw[key] = cls(**kw[key])
    return tcfgs.ModelConfig(**kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _assert_config_equals_reference(name, smoke):
    want = jcfgs.get_config(name, smoke=smoke)
    got = tcfgs.get_config(name, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("unit_len", "n_units", "n_remainder", "d_attn",
                 "has_attention", "max_window", "is_subquadratic",
                 "supports_long_context"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert tcfgs.param_count(got) == jcfgs.param_count(want)
    return got, want


ARCHS = ("olmo-1b", "mamba2-780m", "recurrentgemma-2b", "llama3-8b",
         "qwen3-14b", "gemma3-12b", "mixtral-8x22b", "arctic-480b",
         "pixtral-12b", "musicgen-large")


def _check_mamba2(got, want, smoke):
    if smoke:
        assert (got.ssm.d_state, got.ssm.d_head, got.ssm.chunk,
                got.n_layers) == (16, 16, 8, 2)
    else:
        assert (got.n_layers, got.d_model, got.ssm.chunk) == (48, 1536, 128)
        assert tssd.ssd_dims(got) == jssd.ssd_dims(want) == (3072, 48, 3328)


def _check_recurrentgemma(got, want, smoke):
    assert [s.kind for s in got.pattern] == [RGLRU, RGLRU, ATTN]
    if smoke:
        assert (got.n_layers, got.n_remainder, got.recurrent.rnn_width,
                got.pattern[2].window) == (6, 0, 64, 8)
    else:
        assert (got.n_layers, got.n_units, got.n_remainder, got.d_head,
                got.n_kv_heads, got.pattern[2].window) == (26, 8, 2, 256, 1,
                                                           2048)


def _check_arctic(got, want, smoke):
    assert got.moe.dense_residual and got.moe.n_experts == (4 if smoke
                                                           else 128)
    # smoke() keeps the bf16 cache; the full config quantises it
    assert got.kv_cache_dtype == ("bfloat16" if smoke else "int8")
    assert got.param_dtype == ("float32" if smoke else "bfloat16")


CONFIG_CHECKS = {"mamba2-780m": _check_mamba2,
                 "recurrentgemma-2b": _check_recurrentgemma,
                 "arctic-480b": _check_arctic}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_reference(name, smoke):
    got, want = _assert_config_equals_reference(name, smoke)
    if name in CONFIG_CHECKS:
        CONFIG_CHECKS[name](got, want, smoke)


def test_registry_and_shapes():
    assert tcfgs.list_architectures() == jcfgs.list_architectures()
    assert sorted(tcfgs.list_architectures()) == sorted(
        a.replace("-", "_") for a in ARCHS)
    with pytest.raises(KeyError, match="port has"):
        tcfgs.get_config("no-such-arch")
    assert [dataclasses.asdict(s) for s in tcfgs.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in jcfgs.ALL_SHAPES]
    cfg = tcfgs.get_config("olmo-1b")
    assert [s.name for s in tcfgs.applicable_shapes(cfg)] == [
        s.name for s in jcfgs.applicable_shapes(jcfgs.get_config("olmo-1b"))]
    assert round(tcfgs.param_count(cfg)["total"] / 1e9, 2) == 1.18


@pytest.mark.parametrize("name", ["mixtral-8x22b", "mamba2-780m",
                                  "recurrentgemma-2b", "gemma3-12b"])
def test_smoke_of_other_families_equals_reference(name):
    """``smoke()`` and ``replace()`` of the copied schema, on configs with
    MoE / SSM / recurrent sub-configs and windows."""
    jcfg = jcfgs.get_config(name)
    tcfg = _torch_cfg(jcfg)
    assert dataclasses.asdict(tcfg.smoke()) == dataclasses.asdict(
        jcfg.smoke())
    assert tcfgs.param_count(tcfg) == jcfgs.param_count(jcfg)
    assert tcfg.max_window == jcfg.max_window


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["layernorm_nonparam", "layernorm",
                                  "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm(norm, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3 + 1
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(norm=norm)
    params = {}
    if norm != "layernorm_nonparam":
        params["scale"] = rng.standard_normal(64, np.float32)
    if norm == "layernorm":
        params["bias"] = rng.standard_normal(64, np.float32)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x, dtype), jcfg)
    got = tlayers.apply_norm(
        {k: torch.as_tensor(v) for k, v in params.items()},
        torch.as_tensor(x).to(tlayers.torch_dtype(dtype)), _torch_cfg(jcfg))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_apply_head_norm():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16), np.float32)
    s = rng.standard_normal(16, np.float32)
    want = jlayers.apply_head_norm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = tlayers.apply_head_norm({"scale": torch.as_tensor(s)},
                                  torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16), np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    # angles up to ~4096 rad: cos/sin of a large fp32 argument differ by
    # a few ulp of the argument between the two libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(16, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(16, theta)), **TOL)


def test_sinusoidal_embed():
    pos = np.arange(24, dtype=np.int32).reshape(2, 12)
    want = jlayers.sinusoidal_embed(jnp.asarray(pos), 64)
    got = tlayers.sinusoidal_embed(torch.as_tensor(pos), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply(act):
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(mlp_act=act)
    params = _np_tree(jlayers.mlp_init(jax.random.PRNGKey(1), jcfg))
    x = np.random.default_rng(6).standard_normal((2, 5, 64), np.float32)
    want = jlayers.mlp_apply(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jcfg)
    got = tlayers.mlp_apply({k: torch.as_tensor(v) for k, v in params.items()},
                            torch.as_tensor(x), _torch_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_scales_follow_the_reference():
    cfg = tcfgs.get_config("olmo-1b", smoke=True)
    g = torch.Generator().manual_seed(0)
    p = tlm.init_params(cfg, g, device="cpu")
    assert p["final_norm"] == {} and p["units"]["b0"]["mix_norm"] == {}
    wq = p["units"]["b0"]["mixer"]["wq"]
    assert wq.shape == (cfg.n_units, 64, 64) and wq.dtype == torch.float32
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    again = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], p["embed"])


# ---------------------------------------------------------------------------
# weights across
# ---------------------------------------------------------------------------


def test_from_reference_params_round_trips_every_leaf():
    jcfg = jcfgs.get_config("olmo-1b", smoke=True)
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    _assert_same_leaves(tree, got)


def test_from_reference_params_carries_the_ssd_leaves():
    jcfg = jcfgs.get_config("mamba2-780m", smoke=True)
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    assert set(got["units"]["b0"]) == {"mix_norm", "mixer"}   # no FFN
    assert set(got["units"]["b0"]["mixer"]) == {
        "in_proj", "conv_w", "a_log", "dt_bias", "d_skip",
        "gate_norm_scale", "out_proj"}
    _assert_same_leaves(tree, got)


@pytest.mark.parametrize("n_layers", [6, 8])
def test_from_reference_params_carries_the_rglru_leaves(n_layers):
    """Stacked under ``units`` and, with 8 layers, unstacked under
    ``rem`` (a unit of two RG-LRU layers)."""
    jcfg = jcfgs.get_config("recurrentgemma-2b", smoke=True).replace(
        n_layers=n_layers)
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    leaves = {"w_branch1", "w_branch2", "conv_w", "w_a", "b_a", "w_i", "b_i",
              "lam", "w_out"}
    assert set(got["units"]["b0"]) == {"mix_norm", "mixer", "ffn_norm",
                                       "mlp"}
    assert set(got["units"]["b0"]["mixer"]) == leaves
    assert got["units"]["b1"]["mixer"]["w_a"].shape == (2, 64, 64)
    assert ("rem" in got) == (n_layers == 8)
    if n_layers == 8:
        assert set(got["rem"]) == {"b0", "b1"}
        assert set(got["rem"]["b1"]["mixer"]) == leaves
        assert got["rem"]["b1"]["mixer"]["w_a"].shape == (64, 64)
    _assert_same_leaves(tree, got)


def _assert_same_leaves(tree, got):
    leaves_w = jax.tree_util.tree_leaves_with_path(tree)
    leaves_g = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (_, a), (_, b) in zip(leaves_w, leaves_g):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_from_reference_params_carries_the_moe_leaves():
    """arctic's smoke model in bfloat16 (its published ``param_dtype``):
    the router and the stacked experts under ``units``, the dense
    residual MLP beside them; and its train state (bf16 moments)."""
    from repro.dist import stepfns as jstep
    from repro.optim import optimizers as jopt
    from repro_torch.models.convert import from_reference_train_state

    jcfg = jcfgs.get_config("arctic-480b", smoke=True).replace(
        param_dtype="bfloat16", opt_state_dtype="bfloat16")
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    b0 = got["units"]["b0"]
    assert set(b0) == {"mix_norm", "mixer", "ffn_norm", "moe", "mlp"}
    assert b0["moe"]["w_gate"].shape == (jcfg.n_units, 4, 64, 64)
    assert b0["moe"]["router"].dtype == torch.bfloat16

    def bits(t):          # a leaf's bits: bfloat16 as int16 on both sides
        if isinstance(t, torch.Tensor):
            return t.view(torch.int16).numpy()
        return np.asarray(t).view(np.int16)

    _assert_same_leaves(jax.tree.map(bits, tree),
                        jax.tree.map(lambda t: torch.from_numpy(bits(t)),
                                     got))
    state = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(1), jcfg,
        jopt.OptimizerConfig(state_dtype="bfloat16")))
    tstate = from_reference_train_state(state, _torch_cfg(jcfg), "cpu")
    mu = tstate.opt.mu["units"]["b0"]["moe"]["w_down"]
    assert mu.dtype == torch.bfloat16 and mu.shape == (jcfg.n_units, 4, 64,
                                                       64)
    assert np.array_equal(
        bits(tstate.params["units"]["b0"]["moe"]["w_up"]),
        bits(state.params["units"]["b0"]["moe"]["w_up"]))


def test_from_reference_params_rejects_a_wrong_tree():
    jcfg = jcfgs.get_config("olmo-1b", smoke=True)
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tree["units"]["b0"]["mixer"]["wq"] = tree["units"]["b0"]["mixer"]["wq"][1:]
    with pytest.raises(ValueError, match="wq"):
        from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_reference_params(tree, _torch_cfg(jcfg), device="cpu")


def test_from_reference_params_carries_bfloat16():
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(
        param_dtype="bfloat16")
    tree = _np_tree(jlm.init_params(jax.random.PRNGKey(2), jcfg))
    got = from_reference_params(tree, _torch_cfg(jcfg), device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

VARIANTS = {
    "olmo": lambda c: c,
    # GQA + sliding window shorter than the prompt: the ring-buffer cache
    "gqa_window": lambda c: c.replace(n_kv_heads=2,
                                      pattern=(LayerSpec(ATTN, 8),)),
}


def _run_reference(jcfg, tokens, extra=None):
    """The reference's outputs, greedy tokens included, as numpy. With
    ``extra`` (frontend embeddings) before the prompt, the cache holds
    their tokens too (the port's ``serve()`` sizing, caveat C9)."""
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    train = jax.jit(lambda p, t, e: jlm.forward_train(p, jcfg, t, e))
    logits_train, aux = train(params, tokens, extra)
    n_front = 0 if extra is None else extra.shape[1]
    max_len = n_front + tokens.shape[1] + N_DECODE + 8
    cache = jlm.init_cache(jcfg, tokens.shape[0], max_len)
    pre = jax.jit(lambda p, t, c, e: jlm.prefill(p, jcfg, t, c, e))
    dec = jax.jit(lambda p, t, c: jlm.decode_step(p, jcfg, t, c))
    logits, cache = pre(params, tokens, cache, extra)
    out = {"params": _np_tree(params), "train": np.asarray(logits_train),
           "aux": float(aux), "prefill": np.asarray(logits),
           "cache": _np_tree(cache), "max_len": max_len, "tokens": [],
           "decode": []}
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for _ in range(N_DECODE):
        out["tokens"].append(np.array(tok))
        logits, cache = dec(params, tok, cache)
        out["decode"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out["final_cache"] = _np_tree(cache)
    return out


def _assert_cache(got, want):
    """Every tensor of every block's cache (k/v and an int8 cache's
    scales, or the SSD or RG-LRU h/conv), the stacked units' and the
    remainder unit's, in the reference's dtype. int8 codes may differ by
    1 where float32 noise moves a value across a rounding edge."""
    assert set(got) == set(want)
    for part in ("units", "rem"):
        if part not in want:
            continue
        assert set(got[part]) == set(want[part])
        for block, tensors in want[part].items():
            assert set(got[part][block]) == set(tensors)
            for key, value in tensors.items():
                g = got[part][block][key].numpy()
                assert g.dtype == value.dtype, (block, key)
                if value.dtype == np.int8:
                    diff = np.abs(g.astype(np.int32) - value)
                    assert diff.max() <= 1, (block, key)
                else:
                    np.testing.assert_allclose(g, value, **TOL)
    assert got["pos"] == int(want["pos"])


def _assert_model_matches_reference(jcfg, tokens, extra=None):
    """forward_train (logits and MoE aux loss), prefill (logits and
    caches) and teacher-forced decode steps equal the reference's, with
    ``extra`` (numpy frontend embeddings or None) before the prompt;
    returns the port's cache."""
    want = _run_reference(jcfg, jnp.asarray(tokens),
                          None if extra is None else jnp.asarray(extra))
    cfg = _torch_cfg(jcfg)
    params = from_reference_params(want["params"], cfg, device="cpu")
    tt = torch.as_tensor(tokens)
    te = None if extra is None else torch.as_tensor(extra)
    with torch.inference_mode():
        logits, aux = tlm.forward_train(params, cfg, tt, te)
        np.testing.assert_allclose(logits.numpy(), want["train"], **TOL)
        np.testing.assert_allclose(float(aux), want["aux"], **TOL)
        assert cfg.moe is not None or float(aux) == 0.0
        cache = tlm.init_cache(cfg, BATCH, want["max_len"], device="cpu")
        logits, cache = tlm.prefill(params, cfg, tt, cache, te)
        np.testing.assert_allclose(logits.numpy(), want["prefill"], **TOL)
        _assert_cache(cache, want["cache"])
        for tok, want_logits in zip(want["tokens"], want["decode"]):
            logits, cache = tlm.decode_step(params, cfg, torch.as_tensor(tok),
                                            cache)
            np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        _assert_cache(cache, want["final_cache"])
    return cache


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_matches_reference(variant, impl):
    jcfg = VARIANTS[variant](jcfgs.get_config("olmo-1b", smoke=True)).replace(
        attn_impl=impl)
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    cache = _assert_model_matches_reference(jcfg, tokens)
    if variant == "gqa_window":
        assert cache["units"]["b0"]["k"].shape[2] == 8    # ring of 8 slots


@pytest.mark.parametrize("prompt", [12, 16])
def test_ssd_model_matches_reference(prompt):
    jcfg = jcfgs.get_config("mamba2-780m", smoke=True)
    tokens = np.random.default_rng(prompt).integers(
        0, jcfg.vocab_size, (BATCH, prompt)).astype(np.int32)
    cache = _assert_model_matches_reference(jcfg, tokens)
    assert cache["units"]["b0"]["h"].shape == (2, BATCH, 8, 16, 16)


RG_VARIANTS = {"smoke": 6, "remainder": 8}


@pytest.mark.parametrize("impl", ["reference", "chunked"])
@pytest.mark.parametrize("variant", list(RG_VARIANTS))
def test_rglru_model_matches_reference(variant, impl):
    jcfg = jcfgs.get_config("recurrentgemma-2b", smoke=True).replace(
        n_layers=RG_VARIANTS[variant], attn_impl=impl)
    tokens = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    cache = _assert_model_matches_reference(jcfg, tokens)
    assert cache["units"]["b0"]["h"].shape == (2, BATCH, 64)
    assert cache["units"]["b2"]["k"].shape == (2, BATCH, 8, 16)  # ring of 8
    assert cache["pos"] == PROMPT + N_DECODE > 8                 # wrapped
    assert ("rem" in cache) == (variant == "remainder")


def test_ssd_prefill_writes_the_caches_in_place():
    """The per-layer caches are views of the stacked tensors: a prefill
    fills them where they stand, and a prefill over 10 tokens then one
    decode step leaves the state of a prefill over all 11."""
    cfg = tcfgs.get_config("mamba2-780m", smoke=True)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(3))
    cache = tlm.init_cache(cfg, 2, 32, device="cpu")
    h, conv = cache["units"]["b0"]["h"], cache["units"]["b0"]["conv"]
    assert conv.shape == (2, 2, 3, 160) and cache["pos"] == 0
    with torch.inference_mode():
        _, new = tlm.prefill(params, cfg, tokens, cache)
        assert new["units"]["b0"]["h"] is h and h.abs().sum() > 0
        assert conv.abs().sum() > 0 and new["pos"] == 11
        other = tlm.init_cache(cfg, 2, 32, device="cpu")
        _, other = tlm.prefill(params, cfg, tokens[:, :10], other)
        _, other = tlm.decode_step(params, cfg, tokens[:, 10:], other)
    torch.testing.assert_close(other["units"]["b0"]["h"], h, **TOL)
    torch.testing.assert_close(other["units"]["b0"]["conv"], conv, **TOL)


def test_feature_variant_matches_reference():
    """rmsnorm, qk-norm, GELU, untied head, soft-capping, embedding scale,
    absolute positions, extra embeddings and a remainder layer (3 layers
    over a global + windowed unit), all through the plain attention."""
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(
        norm="rmsnorm", qk_norm=True, mlp_act="gelu", tie_embeddings=False,
        logit_softcap=30.0, embed_scale=True, abs_sinusoidal=True,
        n_layers=3, pattern=(LayerSpec(ATTN), LayerSpec(ATTN, 4)))
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    extra = rng.standard_normal((BATCH, 3, jcfg.d_model), np.float32)
    want = _run_reference(jcfg, jnp.asarray(tokens))
    cfg = _torch_cfg(jcfg)
    params = from_reference_params(want["params"], cfg, device="cpu")
    assert set(params) == {"embed", "units", "final_norm", "rem", "lm_head"}
    with torch.inference_mode():
        np.testing.assert_allclose(
            tlm.forward_train(params, cfg,
                              torch.as_tensor(tokens))[0].numpy(),
            want["train"], **TOL)
        cache = tlm.init_cache(cfg, BATCH, want["max_len"], device="cpu")
        logits, cache = tlm.prefill(params, cfg, torch.as_tensor(tokens),
                                    cache)
        np.testing.assert_allclose(logits.numpy(), want["prefill"], **TOL)
        for tok, want_logits in zip(want["tokens"], want["decode"]):
            logits, cache = tlm.decode_step(params, cfg, torch.as_tensor(tok),
                                            cache)
            np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                cache["rem"]["b0"][key].numpy(),
                want["final_cache"]["rem"]["b0"][key], **TOL)
        jparams = jax.tree.map(jnp.asarray, want["params"])
        want_x = jlm.forward_train(jparams, jcfg, jnp.asarray(tokens),
                                   jnp.asarray(extra))[0]
        got_x = tlm.forward_train(params, cfg, torch.as_tensor(tokens),
                                  torch.as_tensor(extra))[0]
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **TOL)


def _olmo_with(pattern=None, moe=True, **kw):
    """olmo-1b's smoke config with ``pattern``, mixtral's smoke MoE and
    the SSD and RG-LRU sub-configs of mamba2's and recurrentgemma's
    smoke configs (the blocks of ``pattern`` read them)."""
    jcfg = jcfgs.get_config("olmo-1b", smoke=True)
    if pattern is not None:
        kw["pattern"] = tuple(jcfgs.LayerSpec(k) for k in pattern)
        kw["ssm"] = jcfgs.get_config("mamba2-780m", smoke=True).ssm
        kw["recurrent"] = jcfgs.get_config("recurrentgemma-2b",
                                           smoke=True).recurrent
    if moe:
        kw["moe"] = jcfgs.MoEConfig(n_experts=4, top_k=2, d_ff_expert=64)
    return jcfg.replace(**kw)


# configurations the port once refused (MoE beside other block kinds,
# where the reference gives MoE to attention blocks only; the int8 cache)
MIXED = {
    "rglru_moe": lambda: _olmo_with((RGLRU,)),
    "ssd_rglru_moe": lambda: _olmo_with((SSD, RGLRU)),
    "attn_moe": lambda: _olmo_with((ATTN,)),
    "int8_cache": lambda: _olmo_with(moe=False, kv_cache_dtype="int8"),
}


@pytest.mark.parametrize("variant", list(MIXED))
def test_mixed_blocks_and_int8_cache_match_reference(variant):
    jcfg = MIXED[variant]()
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    cache = _assert_model_matches_reference(jcfg, tokens)
    blocks = cache["units"]
    if variant == "int8_cache":
        assert blocks["b0"]["k"].dtype == torch.int8
        assert set(blocks["b0"]) == {"k", "v", "k_scale", "v_scale"}
    params = tlm.init_params(_torch_cfg(jcfg), device="cpu")
    kinds = {k: set(v) for k, v in params["units"].items()}
    if variant == "attn_moe":
        assert kinds["b0"] == {"mix_norm", "mixer", "ffn_norm", "moe"}
    elif variant != "int8_cache":            # no MoE outside attention
        assert all("moe" not in v for v in kinds.values())


def test_unknown_attn_impl_raises():
    cfg = tcfgs.get_config("olmo-1b", smoke=True).replace(attn_impl="xla")
    params = tlm.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        tlm.forward_train(params, cfg, torch.zeros((1, 4), dtype=torch.long))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfgs.get_config("olmo-1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_cache(cfg, 1, 8)
