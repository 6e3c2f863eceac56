"""The port's training step against the JAX package's, on the CPU.

* ``loss_fn`` and its gradients: olmo-1b, mamba2-780m and
  recurrentgemma-2b smoke configs (float32), the reference's
  ``init_params`` carried across by ``from_reference_params``, the same
  numpy batch; the loss within ``LOSS_TOL`` of ``jax.value_and_grad``'s
  and every gradient leaf within ``GRAD_RTOL`` of that leaf's largest
  magnitude (the same float32 function summed in another order; the
  reference scans its recurrences with associative scans).
* ``make_train_step``: three AdamW steps under the reference's
  warmup-cosine schedule at ``grad_accum`` 1 and 2, from the reference's
  ``init_train_state`` carried across by ``from_reference_train_state``:
  loss, grad norm and lr of every step and the final parameters within
  the same tolerances (the lr bit for bit).
* ``remat`` ``none``, ``full`` and ``dots``: the same loss and gradients
  bit for bit (checkpointing changes memory, never values).
* The three ``autograd.Function``s (K4, K5, K6 on a card) run here with
  their kernel monkeypatched to the plain version (test only): their
  input gradients within ``GRAD_RTOL`` of ``jax.vjp`` of the reference's
  oracles; the reference's SSD oracle takes no ``h0``, so the SSD
  Function's ``h0`` and ``h_last`` gradients are held against autograd
  of the port's own token-by-token oracle.
* Under ``remat="full"`` a step of ``attn_impl="chunked"`` runs the
  lse forward twice a layer (the forward and the recompute) and the
  backward from the log-sum-exp once, counted through
  ``FlashAttentionLSE``'s dispatches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.dist import stepfns as jstep
from repro.kernels.attention import ref as jattn_ref
from repro.kernels.rglru import ref as jrglru_ref
from repro.kernels.ssd import ref as jssd_ref
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch import configs as tcfgs
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import LayerSpec
from repro_torch.dist import stepfns as tstep
from repro_torch.kernels.attention import kernel as k4
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as tattn_ref
from repro_torch.kernels.rglru import kernel as k6
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import ref as trglru_ref
from repro_torch.kernels.ssd import kernel as k5
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as tssd_ref
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.convert import (
    from_reference_params,
    from_reference_train_state,
)
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

LOSS_TOL = 2e-5     # float32 losses of order 5
GRAD_RTOL = 2e-5    # of a gradient leaf's largest magnitude
ARCHS = ("olmo-1b", "mamba2-780m", "recurrentgemma-2b")
BATCH, SEQ = 4, 16


def _torch_cfg(jcfg):
    kw = dataclasses.asdict(jcfg)
    kw["pattern"] = tuple(LayerSpec(**s) for s in kw["pattern"])
    for key, cls in (("moe", tcfgs.MoEConfig), ("ssm", tcfgs.SSMConfig),
                     ("recurrent", tcfgs.RecurrentConfig)):
        if kw[key] is not None:
            kw[key] = cls(**kw[key])
    return tcfgs.ModelConfig(**kw)


def _batch(vocab: int, seed: int = 0, n: int = BATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want, what: str, rtol=GRAD_RTOL):
    w = np.asarray(want, np.float32)
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=0,
                               atol=rtol * max(scale, 1e-30),
                               err_msg=what)


def _assert_tree_close(got, want, what):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(flat)
    for (path, w), g in zip(flat, leaves):
        _close(g, w, f"{what}{jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jcfgs.get_config(request.param, smoke=True)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, _torch_cfg(jcfg), jparams


def test_loss_and_gradients_equal_reference(model):
    jcfg, tcfg, jparams = model
    batch = _batch(jcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    params = from_reference_params(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu")
    tloss, tgrads = tstep._value_and_grad(params, tcfg, _torch_batch(batch))
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    _assert_tree_close(tgrads, jgrads, f"{tcfg.name} grads")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_equal_reference(accum):
    jcfg = jcfgs.get_config("olmo-1b", smoke=True).replace(grad_accum=accum)
    tcfg = _torch_cfg(jcfg)
    jopt_cfg = jopt.OptimizerConfig(name="adamw", lr=3e-3)
    topt_cfg = topt.OptimizerConfig(name="adamw", lr=3e-3)
    jstate = jstep.init_train_state(jax.random.PRNGKey(0), jcfg, jopt_cfg)
    tstate = from_reference_train_state(jax.tree.map(np.asarray, jstate),
                                        tcfg, device="cpu")
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jopt_cfg, jsched.warmup_cosine(3e-3, 1, 3)))
    tfn = tstep.make_train_step(tcfg, topt_cfg,
                                tsched.warmup_cosine(3e-3, 1, 3))
    for i in range(3):
        batch = _batch(jcfg.vocab_size, seed=i)
        jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tfn(tstate, _torch_batch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_RTOL)
        assert (tm["lr"].numpy().tobytes()
                == np.asarray(jm["lr"], np.float32).tobytes())
        assert int(tstate.opt.step) == i + 1
    _assert_tree_close(tstate.params, jstate.params, "params")
    _assert_tree_close(tstate.opt.mu, jstate.opt.mu, "mu")
    _assert_tree_close(tstate.opt.nu, jstate.opt.nu, "nu")


def test_from_reference_train_state_rejects_a_wrong_moment():
    jcfg = jcfgs.get_config("olmo-1b", smoke=True)
    opt_cfg = jopt.OptimizerConfig()
    state = jax.tree.map(np.asarray, jstep.init_train_state(
        jax.random.PRNGKey(0), jcfg, opt_cfg))
    mu = dict(state.opt.mu)
    mu["embed"] = np.zeros((3, 3), np.float32)
    bad = state._replace(opt=state.opt._replace(mu=mu))
    with pytest.raises(ValueError, match="mu/embed"):
        from_reference_train_state(bad, _torch_cfg(jcfg), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    cfg = tcfgs.get_config(arch, smoke=True)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = _torch_batch(_batch(cfg.vocab_size, seed=5))
    runs = {r: tstep._value_and_grad(params, cfg.replace(remat=r), batch)
            for r in ("none", "full", "dots")}
    loss0, g0 = runs["none"]
    for r in ("full", "dots"):
        loss, g = runs[r]
        assert torch.equal(loss, loss0), r
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), r


def test_unknown_remat_raises():
    cfg = tcfgs.get_config("olmo-1b", smoke=True).replace(remat="some")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="unknown remat"):
        tstep._value_and_grad(params, cfg, _torch_batch(_batch(128)))


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, the kernel swapped for its plain version
# ---------------------------------------------------------------------------


def _inputs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _leafs(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("causal,window,heads", [
    (True, None, (4, 4)), (True, 5, (4, 2)), (False, None, (6, 2))])
def test_flash_attention_function_gradients(monkeypatch, causal, window,
                                            heads):
    monkeypatch.setattr(k4, "flash_attention_cuda", tattn_ref.attention_ref)
    H, K = heads
    q, k, v, g = _inputs(0, (2, 12, H, 16), (2, 12, K, 16), (2, 12, K, 16),
                         (2, 12, H, 16))
    want = jax.vjp(lambda a, b, c: jattn_ref.attention_ref(
        a, b, c, causal, window), q, k, v)[1](g)
    tq, tk, tv = _leafs((q, k, v))
    out = attn_ops.FlashAttention.apply(tq, tk, tv, causal, window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        _close(a, b, f"d{name}")


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 4)])
def test_ssd_function_gradients(monkeypatch, S, chunk):
    monkeypatch.setattr(k5, "ssd_scan_cuda", tssd_ref.ssd_chunked_ref)
    B, H, P, N = 2, 3, 4, 5
    xh, bm, cm, dtr, a_raw, h0, gy, gh = _inputs(
        1, (B, S, H, P), (B, S, N), (B, S, N), (B, S, H), (H,),
        (B, H, P, N), (B, S, H, P), (B, H, P, N))
    dt = np.log1p(np.exp(dtr)).astype(np.float32) * 0.5
    a = -np.exp(a_raw).astype(np.float32)
    want = jax.vjp(jssd_ref.ssd_scan_ref, xh, bm, cm, dt, a)[1](gy)
    ins = _leafs((xh, bm, cm, dt, a))
    y, h_last = ssd_ops.SSDScan.apply(*ins, chunk, None)
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    for name, x, w in zip(("xh", "B", "C", "dt", "a"), got, want):
        _close(x, w, f"d{name}")

    # h0 in, h_last out: against the port's token-by-token oracle
    ins = _leafs((xh, bm, cm, dt, a, h0))
    y, h_last = ssd_ops.SSDScan.apply(*ins[:5], chunk, ins[5])
    got = torch.autograd.grad((y, h_last), ins,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    ref_ins = _leafs((xh, bm, cm, dt, a, h0))
    ry, rh = tssd_ref.ssd_scan_ref(*ref_ins)
    want = torch.autograd.grad((ry, rh), ref_ins,
                               (torch.from_numpy(gy), torch.from_numpy(gh)))
    for name, x, w in zip(("xh", "B", "C", "dt", "a", "h0"), got, want):
        _close(x, w.numpy(), f"d{name} (h0, h_last)")


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_function_gradients(monkeypatch, with_h0):
    monkeypatch.setattr(k6, "rglru_scan_cuda", trglru_ref.rglru_scan_ref)
    B, S, R = 2, 11, 6
    a_raw, b, h0, g = _inputs(2, (B, S, R), (B, S, R), (B, R), (B, S, R))
    a = (1.0 / (1.0 + np.exp(-a_raw))).astype(np.float32)
    if with_h0:
        want = jax.vjp(jrglru_ref.rglru_scan_ref, a, b, h0)[1](g)
        ins = _leafs((a, b, h0))
        out = rglru_ops.RGLRUScan.apply(*ins)
    else:
        want = jax.vjp(lambda x, y: jrglru_ref.rglru_scan_ref(x, y),
                       a, b)[1](g)
        ins = _leafs((a, b))
        out = rglru_ops.RGLRUScan.apply(*ins, None)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, x, w in zip(("a", "b", "h0"), got, want):
        _close(x, w, f"d{name}")


def test_remat_full_runs_attention_twice_a_layer(monkeypatch):
    """``attn_impl="chunked"`` trains through ``FlashAttentionLSE``: a
    step runs 2 x n_layers lse forwards under ``remat="full"`` (the
    forward and the recompute; n_layers without remat) and n_layers
    backwards from the log-sum-exp."""
    calls = {"lse": 0, "bwd": 0}
    real_lse, real_bwd = attn_ops.flash_attention_lse, \
        attn_ops.flash_attention_bwd

    def lse(*args):
        calls["lse"] += 1
        return real_lse(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return real_bwd(*args)

    monkeypatch.setattr(attn_ops, "flash_attention_lse", lse)
    monkeypatch.setattr(attn_ops, "flash_attention_bwd", bwd)
    cfg = tcfgs.get_config("olmo-1b", smoke=True).replace(
        attn_impl="chunked")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg.vocab_size))
    want = {"full": (2 * cfg.n_layers, cfg.n_layers),
            "none": (cfg.n_layers, cfg.n_layers)}
    for remat, n in want.items():
        calls.update(lse=0, bwd=0)
        tstep._value_and_grad(params, cfg.replace(remat=remat), batch)
        assert (calls["lse"], calls["bwd"]) == n, remat
