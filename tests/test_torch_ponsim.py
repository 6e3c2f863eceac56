"""The port's grant primitives against ``repro``'s, bit for bit.

``waterfill_grants_ref`` (the plain version of the Hopper kernel K2)
must equal the numpy engine's ``_waterfill`` exactly in float64, on
rows with key ties, empty queues (``inf`` / int64 sentinel keys), zero
backlogs and rows on both sides of ``cap - 1``; and the JAX package's
``kernels/ponsim/ref.py::waterfill_grants_ref``. ``repro.kernels.ponsim``
does not import on this tree's jax (its ``ops.py`` needs
``jax.experimental.enable_x64``), so its ``ref.py`` is loaded by file
path and run under a scoped x64 context. Its ``jnp.cumsum`` is XLA's
parallel scan, which equals the numpy engine's left-to-right prefix
only where the sums are exact: bitwise on packet-multiple backlogs, to
1e-6 bit on fractional ones.
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.net.engine import _IKEY_INF, _waterfill
from repro.net.multi_pon import cps_waterfill as ref_cps_waterfill
from repro_torch.kernels.ponsim import ops, ref
from repro_torch.net.multi_pon import cps_waterfill

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_jax_ref():
    spec = importlib.util.spec_from_file_location(
        "repro_ponsim_ref", ROOT / "src/repro/kernels/ponsim/ref.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(seed: int, R: int, N: int, int_keys: bool,
          fractional: bool = True):
    rng = np.random.default_rng(seed)
    backlog = rng.integers(0, 40, (R, N)) * 12_000.0
    if fractional:
        backlog[:, ::3] += rng.uniform(0, 1e4, (R, (N + 2) // 3))
    backlog[rng.random((R, N)) < 0.3] = 0.0
    if int_keys:
        key = rng.integers(0, max(2, N // 4), (R, N)).astype(np.int64)
        key = np.where(backlog > 0, key, _IKEY_INF)
    else:
        key = np.round(rng.uniform(0, 1, (R, N)), 1)
        key = np.where(backlog > 0, key, np.inf)
    total = backlog.sum(axis=1)
    cap = np.where(np.arange(R) % 2 == 0,
                   total * rng.uniform(0.1, 0.95, R),
                   total + rng.uniform(1.0, 1e4, R))
    cap[-1] = total[-1] - 1.0 + 0.5      # just over cap - 1: hard
    return backlog, key, cap


CASES = [(seed, N, ik) for seed, N in enumerate((1, 2, 7, 37, 128, 300))
         for ik in (False, True)]
# rows as wide as K2 takes in shared memory and past it (one PON's ONUs)
WIDE = [(seed, N, ik) for seed, N in ((6, 4096), (7, 16_384))
        for ik in (False, True)]


@pytest.mark.parametrize("seed,N,int_keys", CASES + WIDE)
def test_waterfill_ref_equals_engine(seed, N, int_keys):
    b, k, c = _rows(seed, 6, N, int_keys)
    want = _waterfill(b, lambda: k, c)
    got = ops.waterfill_grants(b, k, c, device="cpu")
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("seed,N,int_keys", CASES)
def test_waterfill_ref_equals_jax_ref(seed, N, int_keys, fractional):
    b, k, c = _rows(seed, 6, N, int_keys, fractional)
    jref = _load_jax_ref()
    with jax.enable_x64(True):
        want = np.asarray(jref.waterfill_grants_ref(b, k, c))
    got = ref.waterfill_grants_ref(
        *(torch.as_tensor(a) for a in (b, k, c))).numpy()
    if fractional:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert np.array_equal(got, want)


def test_waterfill_lazy_rows_keep_backlog():
    b, k, c = _rows(3, 4, 50, False)
    c = b.sum(axis=1) + 2.0
    got = ops.waterfill_grants(b, k, c, device="cpu").numpy()
    assert np.array_equal(got, b)


@pytest.mark.parametrize("G,P,seed", [(5, 2, 0), (7, 3, 1), (4, 8, 2),
                                      (3, 1, 3)])
def test_cps_waterfill_equal(G, P, seed):
    rng = np.random.default_rng(seed)
    want_in = rng.uniform(0, 2e6, (G, P))
    want_in[rng.random((G, P)) < 0.2] = 0.0
    want_in[0] = want_in[0, :1]           # ties at the water level
    cap = float(want_in.sum(axis=1).mean())
    want = ref_cps_waterfill(want_in, cap)
    got = cps_waterfill(torch.as_tensor(want_in), cap)
    assert np.array_equal(got.numpy(), want)


def test_kernel_has_no_row_width_limit():
    """K2 takes rows of any width (past shared memory through a global
    scratch buffer): its module exports no width limit."""
    from repro_torch.kernels.ponsim import kernel

    assert not [n for n in vars(kernel) if "MAX" in n.upper()]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    b, k, c = _rows(0, 2, 4, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.waterfill_grants(b, k, c)
