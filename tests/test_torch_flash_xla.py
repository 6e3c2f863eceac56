"""The port's memory-linear attention route (``models/flash_xla.py``)
against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both frameworks. The port's
``flash_attention_xla`` runs here through ``FlashAttentionLSE`` with the
plain versions of its two kernels (K4 writing the log-sum-exp, and the
backward from it); the reference's ``flash_attention_xla`` runs with
small ``block_q``/``block_k`` (8 and 16) so that its tiles, its padding
and its masked tile pairs really run. Held: the output, the log-sum-exp
(against the reference's ``_fwd_impl``, ``(B, K, G, S)``) and dq, dk, dv
(against ``jax.vjp``), over causal and bidirectional attention, windows
None, 1, 5 and S, groups of 1, 2, 4 and 10 query heads a kv head, head
dims 16 to 256, S not a multiple of the blocks, and T != S.

Tolerances: float32 within ``F32_RTOL`` = 2e-5 of the largest magnitude
(the same float32 function summed in another order, the repo's
``GRAD_RTOL``); bfloat16 inputs within ``BF16_RTOL`` = 2^-7 of the
largest magnitude (one bf16 rounding of a float32 result on each side).
With a window of 1, where dq and dk vanish in exact arithmetic, both
sides' dq and dk are held to 0 within the same fraction of dv's largest
magnitude.
The plain backward is held to autograd of the plain forward, the route
to the model's ``attn_impl``, the new operators to their shapes and
FLOP counts on fake ``cuda`` tensors, and the refusals to their shapes.
The kernels themselves are held to these plain versions on a card in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import flash_xla as jflash
from repro.models import lm as jlm
from repro_torch import _cuda
from repro_torch import configs as tcfgs
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import LayerSpec
from repro_torch.dist import stepfns as tstep
from repro_torch.kernels.attention import kernel, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze, live_keys
from repro_torch.models import attention as tattn
from repro_torch.models import flash_xla
from repro_torch.models.convert import from_reference_params

F32_RTOL = 2e-5
BF16_RTOL = 2.0 ** -7
BLOCKS = (8, 16)             # the reference's block_q, block_k

# (B, S, T, H, K, D, causal, window)
GRID = [
    (2, 19, 19, 4, 4, 16, True, None),       # G 1, S ragged to both blocks
    (1, 21, 21, 4, 2, 64, True, 5),          # G 2, window 5
    (2, 20, 20, 4, 2, 16, True, 1),          # window 1: each row its own key
    (1, 17, 17, 8, 2, 128, False, None),     # G 4, bidirectional
    (1, 13, 13, 10, 1, 256, True, 13),       # MQA (G 10), D 256, window S
    (1, 22, 22, 4, 4, 64, False, 5),         # bidirectional with a window
    (1, 18, 25, 4, 1, 32, True, None),       # T > S
    (1, 25, 18, 2, 2, 16, False, None),      # T < S
    (1, 23, 15, 6, 2, 16, True, None),       # T < S, causal
    (2, 33, 33, 10, 1, 32, True, 5),         # recurrentgemma's heads, window
]
BF16_GRID = [GRID[0], GRID[1], GRID[4], GRID[6]]


def _inputs(B, S, T, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, K, D), (B, T, K, D),
                      (B, S, H, D))]


def _close(got, want, rtol, what):
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape, what
    scale = float(np.abs(w).max()) if w.size else 0.0
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(scale, 1e-30),
                               err_msg=what)


def _reference(arrays, causal, window, jdt):
    q, k, v, g = (jnp.asarray(a, jdt) for a in arrays)
    bq, bk = BLOCKS
    out, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention_xla(
        a, b, c, causal, window, bq, bk), q, k, v)
    _, lse = jflash._fwd_impl(q, k, v, causal, window, bq, bk)
    return out, lse, vjp(g)


def _port(arrays, causal, window, tdt):
    q, k, v = (torch.as_tensor(a).to(tdt).requires_grad_(True)
               for a in arrays[:3])
    g = torch.as_tensor(arrays[3]).to(tdt)
    out = flash_xla.flash_attention_xla(q, k, v, causal, window)
    assert out.grad_fn.name() == "FlashAttentionLSEBackward"
    grads = torch.autograd.grad(out, (q, k, v), g)
    _, lse = ops.flash_attention_lse(q.detach(), k.detach(), v.detach(),
                                     causal, window)
    return out, lse, grads


def _hold(shape, jdt, tdt, rtol):
    B, S, T, H, K, D, causal, window = shape
    arrays = _inputs(B, S, T, H, K, D, seed=S * T + D)
    j_out, j_lse, j_grads = _reference(arrays, causal, window, jdt)
    t_out, t_lse, t_grads = _port(arrays, causal, window, tdt)
    assert t_out.dtype == tdt and t_lse.dtype == torch.float32
    _close(t_out, j_out, rtol, "out")
    # the reference's (B, K, G, S) is the port's (B, H, S): h = k G + g
    _close(t_lse, np.asarray(j_lse).reshape(B, H, S), F32_RTOL, "lse")
    for name, got, want in zip(("dq", "dk", "dv"), t_grads, j_grads):
        assert got.dtype == tdt, name
        if window == 1 and name != "dv":
            # each row sees its own key alone: its softmax is constant, so
            # dq and dk are 0 in exact arithmetic and the reference's are
            # rounding noise; both held to 0 on the scale of dv
            atol = rtol * float(np.abs(np.asarray(
                jnp.asarray(j_grads[2], jnp.float32))).max())
            for x in (got.detach().float().numpy(),
                      np.asarray(jnp.asarray(want, jnp.float32))):
                np.testing.assert_allclose(x, 0.0, rtol=0, atol=atol,
                                           err_msg=name)
            continue
        _close(got, want, rtol, name)


@pytest.mark.parametrize("shape", GRID, ids=str)
def test_float32_equals_reference(shape):
    _hold(shape, jnp.float32, torch.float32, F32_RTOL)


@pytest.mark.parametrize("shape", BF16_GRID, ids=str)
def test_bfloat16_equals_reference(shape):
    _hold(shape, jnp.bfloat16, torch.bfloat16, BF16_RTOL)


@pytest.mark.parametrize("shape", [GRID[1], GRID[3], GRID[6], GRID[9]],
                         ids=str)
def test_plain_backward_equals_autograd_of_plain_forward(shape):
    """The closed form from the log-sum-exp against autograd of
    ``attention_ref``; the lse forward's output is ``attention_ref``'s,
    bit for bit."""
    B, S, T, H, K, D, causal, window = shape
    q, k, v, g = (torch.as_tensor(a) for a in
                  _inputs(B, S, T, H, K, D, seed=1))
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal, window)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = ref.attention_ref(*leaves, causal, window)
    assert torch.equal(out, plain.detach())
    want = torch.autograd.grad(plain, leaves, g)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b.numpy(), F32_RTOL, name)


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_chunked_model_gradients_equal_reference(arch):
    """The slice as a whole: a smoke model's loss and every gradient
    leaf under ``attn_impl="chunked"`` (the reference's flash_xla, the
    port's FlashAttentionLSE) within ``F32_RTOL`` of the largest
    magnitude of the leaf; recurrentgemma-2b's attention is windowed."""
    jcfg = jcfgs.get_config(arch, smoke=True).replace(attn_impl="chunked")
    tcfg = tcfgs.get_config(arch, smoke=True).replace(attn_impl="chunked")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    params = from_reference_params(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu")
    tloss, tgrads = tstep._value_and_grad(
        params, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tloss) - float(jloss)) <= F32_RTOL
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    leaves = tree_leaves(tgrads)
    assert len(leaves) == len(flat)
    for (path, want), got in zip(flat, leaves):
        _close(got, want, F32_RTOL, jax.tree_util.keystr(path))


def _attend(impl, grad, window=None):
    """``_attend_full`` under ``attn_impl=impl`` on small inputs."""
    cfg = tcfgs.get_config("olmo-1b", smoke=True).replace(attn_impl=impl)
    q, k, v, _ = (torch.as_tensor(a) for a in
                  _inputs(1, 9, 9, 4, 4, 16, seed=2))
    if grad:
        q.requires_grad_(True)
    return tattn._attend_full(q, k, v, cfg, LayerSpec(window=window), 9)


def test_chunked_trains_through_the_lse_function(monkeypatch):
    """``"chunked"`` with a gradient reaches ``FlashAttentionLSE`` (the
    lse forward and the backward from it); without one (prefill) the
    forward as before; ``"pallas"`` always ``ops.flash_attention``, the
    route whose card path is ``FlashAttention``."""
    seen = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: seen.append("pallas") or real(*a,
                                                                       **kw))
    real_lse, real_bwd = ops.flash_attention_lse, ops.flash_attention_bwd
    monkeypatch.setattr(ops, "flash_attention_lse",
                        lambda *a: seen.append("lse") or real_lse(*a))
    monkeypatch.setattr(ops, "flash_attention_bwd",
                        lambda *a: seen.append("bwd") or real_bwd(*a))
    out = _attend("chunked", grad=True, window=4)
    assert out.grad_fn is not None
    out.sum().backward()
    assert seen == ["lse", "bwd"]
    seen.clear()
    with torch.no_grad():
        _attend("chunked", grad=True)
    assert seen == ["pallas"]
    seen.clear()
    _attend("chunked", grad=False)
    assert seen == ["pallas"]
    seen.clear()
    _attend("pallas", grad=True).sum().backward()
    assert seen == ["pallas"]


def test_no_grad_chunked_is_the_plain_forward_bit_for_bit():
    """Serving: the route without a gradient is ``attention_ref`` on the
    CPU, the same bits as the lse forward's output."""
    with torch.no_grad():
        got = _attend("chunked", grad=False, window=3)
    q, k, v, _ = (torch.as_tensor(a) for a in
                  _inputs(1, 9, 9, 4, 4, 16, seed=2))
    want = ref.attention_ref(q, k, v, True, 3).reshape(1, 9, 64)
    assert torch.equal(got, want)


def test_remat_full_and_none_give_the_same_bits_through_chunked():
    cfg = tcfgs.get_config("olmo-1b", smoke=True).replace(
        attn_impl="chunked")
    from repro_torch.models import lm as tlm

    params = tlm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss0, g0 = tstep._value_and_grad(params, cfg.replace(remat="none"),
                                      batch)
    loss, g = tstep._value_and_grad(params, cfg.replace(remat="full"), batch)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g), tree_leaves(g0)))


@pytest.mark.parametrize("window", [None, 3])
def test_operators_on_fake_cuda(window):
    """The lse forward and the backward as operators on fake ``cuda``
    tensors: their outputs' shapes and dtypes, no launch, and the dry
    run's counts (K4's 4 B H D a live key; the backward's five products,
    10 B H D a live key)."""
    from repro_torch.launch.hlo_analysis import KERNEL_FLOPS

    B, S, H, K, D = 2, 8, 4, 2, 64
    live = live_keys(S, S, True, window)
    with dryrun.fake_mode():
        q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="cuda")
        k, v = (torch.empty((B, S, K, D), dtype=torch.bfloat16,
                            device="cuda") for _ in range(2))
        before = (kernel.launches, kernel.bwd_launches)
        fwd = analyze(kernel.flash_attention_lse_cuda, q, k, v, True, window)
        out, lse = kernel.flash_attention_lse_cuda(q, k, v, True, window)
        bwd = analyze(kernel.flash_attention_bwd_cuda, q, k, v, out, lse,
                      out, True, window)
        dq, dk, dv = kernel.flash_attention_bwd_cuda(q, k, v, out, lse, out,
                                                     True, window)
    assert (kernel.launches, kernel.bwd_launches) == before
    assert out.shape == (B, S, H, D) and out.dtype == torch.bfloat16
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert [tuple(t.shape) for t in (dq, dk, dv)] == [
        (B, S, H, D), (B, S, K, D), (B, S, K, D)]
    assert fwd["kernels"] == {"flash_attention_lse": 1}
    assert fwd["flops"] == 4 * B * H * D * live
    assert bwd["kernels"] == {"flash_attention_bwd": 1}
    assert bwd["flops"] == 10 * B * H * D * live
    assert KERNEL_FLOPS["flash_attention_bwd"](
        q, k, v, out, lse, out, True, window) == 10 * B * H * D * live


@pytest.mark.parametrize("S,T,window", [(12, 8, 4), (9, 4, 5), (3, 0, None),
                                        (12, 8, 5)])
def test_rows_with_no_live_key_are_refused(S, T, window):
    """S >= T + window (or no key) leaves a query row with no live key,
    which has no log-sum-exp: the route refuses it on the CPU as on a
    card; one row more of keys and it runs."""
    q, k, v, _ = (torch.as_tensor(a) for a in
                  _inputs(1, S, T, 2, 1, 16, seed=3))
    if not (T == 0 or S >= T + window):
        ops.check_live_rows(S, T, window)
        out = flash_xla.flash_attention_xla(q.requires_grad_(True), k, v,
                                            True, window)
        out.sum().backward()
        assert torch.isfinite(q.grad).all()
        return
    with pytest.raises(ValueError, match="no live key"):
        ops.flash_attention_lse(q, k, v, True, window)
    with pytest.raises(ValueError, match="no live key"):
        flash_xla.flash_attention_xla(q.requires_grad_(True), k, v, True,
                                      window)


def test_wrappers_refuse_cpu_tensors():
    q, k, v, g = (torch.as_tensor(a) for a in
                  _inputs(1, 8, 8, 2, 1, 16, seed=4))
    out, lse = ref.flash_attention_lse_ref(q, k, v)
    before = (kernel.launches, kernel.bwd_launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_lse_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    assert (kernel.launches, kernel.bwd_launches) == before
    assert _cuda._lib is None


def test_backward_source_is_built():
    assert "flash_attn_bwd.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "flash_attn_bwd.cu").exists()
