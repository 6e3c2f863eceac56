"""The port's serving path against the JAX package's, on the CPU.

The step functions of ``repro_torch.dist.stepfns`` on parameters carried
across from the reference must equal the reference's jitted
``repro.dist.stepfns`` steps (float32 smoke config, 2e-5: the same
arithmetic summed in another order), over a prefill and teacher-forced
decode steps, for olmo-1b (both attention paths), mamba2-780m (SSD
blocks, whose caches hold a state and no KV) and recurrentgemma-2b
(RG-LRU and windowed MQA blocks, both attention paths, with and without
a remainder unit; a 10-token prompt and 6 steps wrap the ring of 8).
``repro_torch.launch.serve.serve`` runs end to end on the CPU when
asked, and raises without a card otherwise.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.dist import stepfns as jstepfns
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.dist import stepfns
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm
from repro_torch.models.convert import from_reference_params

TOL = dict(atol=2e-5, rtol=2e-5)
ECHO = re.compile(r"^(\S+): prefill\((\d+)x(\d+)\)=[\d.]+ms decode (\d+) "
                  r"steps=[\d.]+ms \([\d.]+ tok/s batched\)$", re.M)


@pytest.mark.parametrize("impl", ["reference", "chunked"])
def test_step_functions_match_reference(impl):
    _assert_steps_match_reference(
        jcfgs.get_config("olmo-1b", smoke=True).replace(attn_impl=impl),
        get_config("olmo-1b", smoke=True).replace(attn_impl=impl))


def test_ssd_step_functions_match_reference():
    _assert_steps_match_reference(jcfgs.get_config("mamba2-780m", smoke=True),
                                  get_config("mamba2-780m", smoke=True))


@pytest.mark.parametrize("impl", ["reference", "chunked"])
@pytest.mark.parametrize("n_layers", [6, 8])
def test_rglru_step_functions_match_reference(n_layers, impl):
    _assert_steps_match_reference(
        jcfgs.get_config("recurrentgemma-2b", smoke=True).replace(
            n_layers=n_layers, attn_impl=impl),
        get_config("recurrentgemma-2b", smoke=True).replace(
            n_layers=n_layers, attn_impl=impl))


def _assert_steps_match_reference(jcfg, cfg):
    jparams = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    params = from_reference_params(jax.tree.map(np.array, jparams), cfg,
                                   device="cpu")
    B, S, n_new = 3, 10, 6
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jpre = jax.jit(jstepfns.make_prefill_step(jcfg))
    jdec = jax.jit(jstepfns.make_decode_step(jcfg))
    pre = stepfns.make_prefill_step(cfg)
    dec = stepfns.make_decode_step(cfg)
    jcache = jlm.init_cache(jcfg, B, S + n_new + 8)
    cache = lm.init_cache(cfg, B, S + n_new + 8, device="cpu")
    jlogits, jcache = jpre(jparams, jnp.asarray(tokens), jcache, None)
    with torch.inference_mode():
        logits, cache = pre(params, torch.as_tensor(tokens), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        for _ in range(n_new):
            tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
            jlogits, jcache = jdec(jparams, tok, jcache)
            logits, cache = dec(params, torch.as_tensor(np.array(tok)),
                                cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            assert cache["pos"] == int(jcache["pos"])
    for part in ("units", "rem"):              # k/v, or h/conv
        for block, tensors in jcache.get(part, {}).items():
            for key, value in tensors.items():
                np.testing.assert_allclose(cache[part][block][key].numpy(),
                                           np.asarray(value), **TOL)


def test_serve_on_cpu_returns_tokens_and_echoes(capsys):
    out = serve_mod.serve(smoke=True, batch=2, prompt_len=8,
                          max_new_tokens=5, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (2, 5)
    assert np.issubdtype(out.dtype, np.integer)
    assert ((out >= 0) & (out < 128)).all()
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("olmo-1b", "2", "8", "5")
    again = serve_mod.serve(smoke=True, batch=2, prompt_len=8,
                            max_new_tokens=5, device="cpu")
    assert np.array_equal(out, again)             # seeded generators


def test_serve_greedy_equals_the_step_functions():
    """``serve()``'s tokens are the greedy argmax of the step functions on
    the same seeded weights and prompts."""
    out = serve_mod.serve(smoke=True, batch=2, prompt_len=6,
                          max_new_tokens=4, seed=5, device="cpu")
    cfg = get_config("olmo-1b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(6))
    cache = lm.init_cache(cfg, 2, 6 + 4 + 8, device="cpu")
    with torch.inference_mode():
        logits, cache = stepfns.make_prefill_step(cfg)(params, prompts, cache)
        toks = [logits[:, -1:].argmax(-1)]
        for _ in range(3):
            logits, cache = stepfns.make_decode_step(cfg)(params, toks[-1],
                                                          cache)
            toks.append(logits[:, -1:].argmax(-1))
    assert np.array_equal(out, torch.cat(toks, dim=1).numpy())


def test_serve_samples_with_temperature():
    out = serve_mod.serve(smoke=True, batch=3, prompt_len=4,
                          max_new_tokens=6, temperature=1.0, device="cpu")
    assert out.shape == (3, 6) and ((out >= 0) & (out < 128)).all()


def test_cli_on_cpu(capsys):
    serve_mod.main(["--device", "cpu", "--batch", "1", "--prompt-len", "5",
                    "--max-new-tokens", "3"])
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("olmo-1b", "1", "5", "3")


def test_mamba2_serve_and_cli_on_cpu(capsys):
    """mamba2-780m through ``serve()`` and the CLI (a 13-token prompt over
    chunks of 8); the seeded generators give the same tokens twice."""
    out = serve_mod.serve(arch="mamba2-780m", batch=2, prompt_len=13,
                          max_new_tokens=5, device="cpu")
    assert out.shape == (2, 5) and ((out >= 0) & (out < 128)).all()
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("mamba2-780m", "2", "13", "5")
    assert np.array_equal(out, serve_mod.serve(
        arch="mamba2-780m", batch=2, prompt_len=13, max_new_tokens=5,
        device="cpu"))
    capsys.readouterr()
    serve_mod.main(["--arch", "mamba2-780m", "--device", "cpu", "--batch",
                    "1", "--prompt-len", "9", "--max-new-tokens", "3"])
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("mamba2-780m", "1", "9", "3")


def test_recurrentgemma_serve_and_cli_on_cpu(capsys):
    """recurrentgemma-2b through ``serve()`` and the CLI: a 13-token
    prompt over windowed layers of 8 slots, so decode writes a wrapped
    ring; the seeded generators give the same tokens twice. ``--full``
    asks for the full-width config, which the CLI reaches on the card."""
    out = serve_mod.serve(arch="recurrentgemma-2b", batch=2, prompt_len=13,
                          max_new_tokens=5, device="cpu")
    assert out.shape == (2, 5) and ((out >= 0) & (out < 128)).all()
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("recurrentgemma-2b", "2", "13", "5")
    assert np.array_equal(out, serve_mod.serve(
        arch="recurrentgemma-2b", batch=2, prompt_len=13, max_new_tokens=5,
        device="cpu"))
    capsys.readouterr()
    serve_mod.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "9",
                    "--max-new-tokens", "3"])
    m = ECHO.search(capsys.readouterr().out)
    assert m and m.groups() == ("recurrentgemma-2b", "1", "9", "3")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_mod.main(["--arch", "recurrentgemma-2b", "--full"])


def test_log_jsonl_is_not_ported_yet(tmp_path):
    # ported now (obs/): the run appends one "serve" event to the file
    import json

    path = tmp_path / "ev.jsonl"
    serve_mod.serve(device="cpu", log_jsonl=str(path), max_new_tokens=2,
                    prompt_len=8)
    events = [json.loads(s) for s in path.read_text().splitlines()]
    assert [e["event"] for e in events] == ["serve"]
    assert {"prefill_ms", "decode_ms", "tps"} <= set(events[0])


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve(arch="mamba2-780m")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve(arch="recurrentgemma-2b")


# ---------------------------------------------------------------------------
# caveat C9: the serving cache and the frontend tokens
# ---------------------------------------------------------------------------


def test_reference_cache_sizing_drops_the_frontend_tokens():
    """Pins the reference's behaviour (``repro/launch/serve.py``): it
    sizes the cache as ``prompt_len + max_new_tokens + 8`` and leaves out
    the frontend tokens that prefill puts before the prompt. With 24 of
    them, 8 prompt tokens and 4 new ones the cache has 20 slots for 32
    prefill tokens: prefill keeps the last 20 even with no window, and
    each decode writes the clamped last slot. The prefill logits equal
    those at a cache sized with the frontend tokens; the decode logits
    do not, from the first step on."""
    jcfg = jcfgs.get_config("musicgen-large", smoke=True).replace(
        n_frontend_tokens=24)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    prompts = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 8)), jnp.int32)
    extra = jnp.asarray(rng.standard_normal((2, 24, jcfg.d_model),
                                            np.float32))
    pre = jax.jit(jstepfns.make_prefill_step(jcfg))
    dec = jax.jit(jstepfns.make_decode_step(jcfg))
    runs = {}
    for what, max_len in (("serve.py", 8 + 4 + 8), ("sized", 24 + 8 + 4 + 8)):
        logits, cache = pre(params, prompts, jlm.init_cache(jcfg, 2, max_len),
                            extra)
        steps = [np.asarray(logits)]
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        for _ in range(3):
            logits, cache = dec(params, tok, cache)
            steps.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        runs[what] = steps
    short, sized = runs["serve.py"], runs["sized"]
    np.testing.assert_allclose(short[0], sized[0], **TOL)
    for a, b in zip(short[1:], sized[1:]):
        assert float(np.abs(a - b).max()) > 0.01


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large",
                                  "olmo-1b"])
def test_serve_sizes_the_cache_with_the_frontend_tokens(arch, monkeypatch):
    seen = []
    init_cache = lm.init_cache

    def spy(cfg, batch, max_len, device):
        seen.append(max_len)
        return init_cache(cfg, batch, max_len, device=device)

    monkeypatch.setattr(serve_mod.lm, "init_cache", spy)
    out = serve_mod.serve(arch=arch, batch=2, prompt_len=6, max_new_tokens=3,
                          device="cpu")
    cfg = get_config(arch, smoke=True)
    assert seen == [cfg.n_frontend_tokens + 6 + 3 + 8]
    assert serve_mod.cache_len(cfg, 6, 3) == seen[0]
    assert out.shape == (2, 3)
    assert (cfg.n_frontend_tokens > 0) == (arch != "olmo-1b")


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-large"])
def test_frontend_serve_equals_the_step_functions(arch):
    """The frontend embeddings come from the parameter generator after
    the parameters, in the compute dtype, before the prompt."""
    out = serve_mod.serve(arch=arch, batch=2, prompt_len=5,
                          max_new_tokens=4, seed=3, device="cpu")
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(3)
    params = lm.init_params(cfg, gen, "cpu")
    extra = serve_mod.frontend_embeds(cfg, 2, gen)
    assert extra.shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    prompts = torch.randint(0, cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(4))
    cache = lm.init_cache(cfg, 2, serve_mod.cache_len(cfg, 5, 4),
                          device="cpu")
    with torch.inference_mode():
        logits, cache = stepfns.make_prefill_step(cfg)(params, prompts, cache,
                                                       extra)
        toks = [logits[:, -1:].argmax(-1)]
        for _ in range(3):
            logits, cache = stepfns.make_decode_step(cfg)(params, toks[-1],
                                                          cache)
            toks.append(logits[:, -1:].argmax(-1))
    assert cache["pos"] == cfg.n_frontend_tokens + 5 + 3
    assert np.array_equal(out, torch.cat(toks, dim=1).numpy())
    assert serve_mod.frontend_embeds(get_config("olmo-1b", smoke=True), 2,
                                     gen) is None
