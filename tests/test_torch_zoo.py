"""The seven configs beyond olmo-1b, mamba2-780m and recurrentgemma-2b
against the JAX package, on the CPU, at smoke size.

llama3-8b, qwen3-14b (qk-norm), gemma3-12b (5 windowed : 1 global,
qk-norm, tied and scaled embeddings), mixtral-8x22b (MoE, sliding
window), arctic-480b (MoE with a dense residual MLP), pixtral-12b
(vision stub) and musicgen-large (audio stub, MHA, LayerNorm, GELU,
absolute positions, no RoPE): each smoke config (float32, d_model 64)
runs with the reference's ``init_params`` carried across
(``models/convert.py``). Held, within 2e-5 (the same float32 arithmetic
summed in another order):

* ``forward_train``'s logits and MoE aux loss, ``prefill``'s last-position
  logits and every cache tensor, and 8 teacher-forced ``decode_step``s
  (both sides fed the reference's greedy tokens) with the cache that
  ``smoke()`` keeps (the compute dtype), and on arctic's smoke model the
  int8 cache too (the reference jitted, as ``serve.py`` runs it; int8
  codes within 1 of the reference's, the one code that float32 noise can
  move across a rounding edge);
* ``loss_fn`` (cross-entropy plus the aux loss) and its gradients, each
  leaf within 2e-5 of its largest magnitude, against
  ``jax.value_and_grad``.

Pixtral and musicgen get the same frontend embeddings (numpy, seeded) on
both sides. Their caches are sized with the frontend tokens, as the
port's ``serve()`` sizes them (caveat C9: the reference's ``serve.py``
leaves them out).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro_torch.dist import stepfns as tstep
from repro_torch.models.convert import from_reference_params
from test_torch_lm import (
    BATCH,
    N_DECODE,
    PROMPT,
    _assert_model_matches_reference,
    _torch_cfg,
)
from test_torch_train_step import _assert_tree_close

ZOO = ("llama3-8b", "qwen3-14b", "gemma3-12b", "mixtral-8x22b",
       "arctic-480b", "pixtral-12b", "musicgen-large")


def _assert_zoo_matches(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    extra = None
    if jcfg.frontend:
        extra = rng.standard_normal(
            (BATCH, jcfg.n_frontend_tokens, jcfg.d_model), np.float32)
    return _torch_cfg(jcfg), _assert_model_matches_reference(jcfg, tokens,
                                                             extra)


@pytest.mark.parametrize("name", ZOO)
def test_serving_matches_reference(name):
    jcfg = jcfgs.get_config(name, smoke=True)
    cfg, cache = _assert_zoo_matches(jcfg)
    assert cache["pos"] == cfg.n_frontend_tokens + PROMPT + N_DECODE
    if name == "gemma3-12b":        # 5 windowed (ring of 8) : 1 global
        assert cache["units"]["b0"]["k"].shape[2] == 8
        assert cache["units"]["b5"]["k"].shape[2] == PROMPT + N_DECODE + 8


def test_arctic_int8_cache_matches_reference():
    jcfg = jcfgs.get_config("arctic-480b", smoke=True).replace(
        kv_cache_dtype="int8")
    _, cache = _assert_zoo_matches(jcfg, seed=1)
    b0 = cache["units"]["b0"]
    assert b0["k"].dtype == torch.int8 and b0["k_scale"].dtype == (
        torch.float32)


def _loss_batch(jcfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (BATCH, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.frontend:
        batch["extra_embeds"] = rng.standard_normal(
            (BATCH, jcfg.n_frontend_tokens, jcfg.d_model), np.float32)
    return batch


@pytest.mark.parametrize("name", ZOO)
def test_loss_and_gradients_match_reference(name):
    jcfg = jcfgs.get_config(name, smoke=True)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _loss_batch(jcfg, 2)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    cfg = _torch_cfg(jcfg)
    params = from_reference_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")
    tloss, tgrads = tstep._value_and_grad(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 2e-5
    _assert_tree_close(tgrads, jgrads, f"{name} grads")
    if cfg.moe is not None:       # the router learns through the aux loss
        g = tgrads["units"]["b0"]["moe"]["router"]
        assert float(g.abs().max()) > 0
