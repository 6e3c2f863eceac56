"""The port's attention oracle against the JAX package's, on the CPU.

Inputs are drawn once with numpy and handed to both frameworks. The
port's ``attention_ref`` (the plain version of the Hopper kernel K4) is
held to the JAX ``attention_ref`` and to the Pallas kernel
``flash_attention_fwd`` run in interpret mode, over the grid of
``tests/test_kernels.py`` plus a few port-only shapes (unequal S and T,
small head dims) and recurrentgemma-2b's heads (head dim 256, MQA, a
window shorter than the sequence). Tolerances: float32 2e-5 (the same function summed in
another order); bfloat16 2e-2 (inputs rounded to bf16 identically on
both sides, outputs rounded to bf16, as ``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.kernel import flash_attention_fwd
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro_torch import _cuda
from repro_torch.configs import get_config
from repro_torch.kernels.attention import kernel, ops, ref

# (B, S, T, H, K, D, causal, window)
GRID = [
    (2, 256, 256, 4, 2, 64, True, None),     # GQA causal
    (1, 128, 128, 8, 8, 32, True, None),     # MHA
    (1, 333, 333, 4, 1, 64, True, None),     # MQA, ragged seq
    (2, 256, 256, 4, 2, 64, True, 64),       # sliding window
    (1, 192, 192, 2, 2, 128, False, None),   # bidirectional
    (1, 96, 96, 4, 4, 64, True, 8),          # tiny window < block
]
PORT_ONLY = [
    (2, 40, 40, 4, 2, 16, True, 8),          # smoke head dim, window
    (1, 50, 70, 4, 2, 32, True, None),       # more keys than queries
    (1, 70, 50, 2, 1, 16, False, 24),        # fewer keys, window only
]
D256 = [
    (1, 40, 40, 4, 1, 256, True, 16),        # MQA at D 256, window
    (2, 24, 24, 10, 1, 256, True, 8),        # recurrentgemma's 10 heads
    (1, 33, 33, 2, 1, 256, True, None),      # ragged, causal only
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, S, T, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, T, K, D), np.float32),
            rng.standard_normal((B, T, K, D), np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window",
                         GRID + PORT_ONLY + D256)
def test_ref_matches_jax_ref(B, S, T, H, K, D, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, T, H, K, D), jdt, tdt)
    want = jax_attention_ref(jq, jk, jv, causal, window)
    got = ref.attention_ref(tq, tk, tv, causal, window)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", GRID + D256[:2])
def test_ref_matches_pallas_kernel(B, S, T, H, K, D, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, S, T, H, K, D, seed=1),
                                       jdt, tdt)
    want = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                               interpret=True)
    got = ref.attention_ref(tq, tk, tv, causal, window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_ops_on_cpu_takes_the_plain_version():
    q, k, v = (torch.as_tensor(a) for a in _inputs(2, 40, 40, 4, 2, 16))
    before = kernel.launches
    got = ops.flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, ref.attention_ref(q, k, v, True, 8))
    assert kernel.launches == before
    assert _cuda._lib is None


@pytest.mark.parametrize("D", [64, 128, 256])
def test_bf16_on_cpu_takes_the_plain_version(D):
    """Inputs the card would send to the tensor-core kernel still take
    the plain version when they lie on the CPU."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _inputs(1, 20, 20, 4, 2, D))
    before = (kernel.launches, kernel.launches_tc)
    got = ops.flash_attention(q, k, v, causal=True, window=None)
    assert torch.equal(got, ref.attention_ref(q, k, v, True, None))
    assert (kernel.launches, kernel.launches_tc) == before
    assert _cuda._lib is None


@pytest.mark.parametrize("D", kernel.TC_HEAD_DIMS)
def test_route_bf16_served_head_dims_to_tensor_cores(D):
    assert kernel.route(torch.bfloat16, D) == "tensor_cores"
    assert kernel.route(torch.float32, D) == "cuda_cores"


@pytest.mark.parametrize("D", [16, 32])
def test_route_small_head_dims_to_cuda_cores(D):
    assert kernel.route(torch.bfloat16, D) == "cuda_cores"
    assert kernel.route(torch.float32, D) == "cuda_cores"


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_served_models_route_to_tensor_cores(arch):
    """Every served attention model computes in bf16 at a head dim the
    tensor-core kernel takes."""
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    assert kernel.route(torch.bfloat16, cfg.d_head) == "tensor_cores"


def test_ops_on_cpu_keeps_gradients():
    q, k, v = (torch.as_tensor(a).requires_grad_()
               for a in _inputs(1, 12, 12, 2, 1, 16))
    ops.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 8, 8, 2, 1, 16))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_cuda(q, k, v)
    assert kernel.launches == before
    assert _cuda._lib is None


def test_flash_source_is_built():
    assert 256 in kernel.HEAD_DIMS
    assert "flash_attn.cu" in _cuda.SOURCES
    assert (_cuda.CSRC / "flash_attn.cu").exists()
