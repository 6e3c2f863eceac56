"""The port on a CUDA card against its own plain path, bit for bit.

Every test here needs a card (``cuda`` marker) and skips without one;
the file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain versions, and whole sweeps on the
card (kernels, device-side queue state, the column-by-column prefix
sums) to the same sweeps on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.slicing import ClientProfile
from repro_torch.kernels.ponsim import kernel as k2
from repro_torch.kernels.ponsim import ops as k2_ops
from repro_torch.kernels.ponsim import ref as k2_ref
from repro_torch.kernels.traffic import kernel as k1
from repro_torch.kernels.traffic import ops as k1_ops
from repro_torch.kernels.traffic import ref as k1_ref
from repro_torch.net import (
    FLRoundWorkload,
    MultiPonTopology,
    PONConfig,
    SweepCase,
    SweepSpec,
    simulate,
)
from repro_torch.net.engine import _IKEY_INF

pytestmark = pytest.mark.cuda
PKT = 12_000.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cycle0,n_cycles,n_onus", [
    (0, 64, 8), (77, 130, 2), (63, 65, 1), (0, 1024, 128),
    (5120, 1024, 2048),
])
def test_sampler_kernel_matches_plain(cuda, cycle0, n_cycles, n_onus):
    keys = np.stack([k1_ops.make_stream_key(s, 1, 0, s % 2)
                     for s in range(4)])
    lams = np.array([0.12, 0.3, 0.0, 2.5], np.float32)
    n_draws = k1_ops._tail_bound(float(lams.max()) * k1_ref.WINDOW)
    thr = torch.as_tensor(k1_ref.poisson_thresholds(
        lams.astype(np.float64) * k1_ref.WINDOW, n_draws), device=cuda)
    kt = torch.as_tensor(keys.astype(np.int64), device=cuda)
    starts, lengths = k1_ops._table(1 / 16, cuda)
    before = k1.launches
    got = k1.sample_arrival_bits_cuda(
        kt, cycle0, thr, starts, lengths, PKT, n_cycles=n_cycles,
        n_onus=n_onus)
    want = k1_ref.sample_arrival_bits_ref(
        kt, cycle0, thr, starts, lengths, PKT, n_cycles=n_cycles,
        n_onus=n_onus)
    assert k1.launches == before + 1
    assert torch.equal(got, want)


def test_sampler_ops_equal_across_devices(cuda):
    key = k1_ops.make_stream_key(3, 1, 2, 1)
    args = (key, 128, 256, 8, 0.5, 1 / 16, PKT)
    got = k1_ops.sample_arrival_bits(*args, device=cuda)
    assert float(got.sum()) == 193_656_000.0
    assert torch.equal(got.cpu(),
                       k1_ops.sample_arrival_bits(*args, device="cpu"))


def _rows(seed, R, N, int_keys):
    rng = np.random.default_rng(seed)
    backlog = rng.integers(0, 40, (R, N)) * 12_000.0
    backlog[:, ::3] += rng.uniform(0, 1e4, (R, (N + 2) // 3))
    backlog[rng.random((R, N)) < 0.3] = 0.0
    if int_keys:
        key = rng.integers(0, max(2, N // 4), (R, N)).astype(np.int64)
        key = np.where(backlog > 0, key, _IKEY_INF)
    else:
        key = np.where(backlog > 0, np.round(rng.uniform(0, 1, (R, N)), 1),
                       np.inf)
    total = backlog.sum(axis=1)
    cap = np.where(np.arange(R) % 2 == 0, total * 0.6, total + 5.0)
    return (torch.as_tensor(a) for a in (backlog, key, cap))


@pytest.mark.parametrize("N", [1, 2, 37, 128, 1000, 2048])
@pytest.mark.parametrize("int_keys", [False, True])
def test_waterfill_kernel_matches_plain(cuda, N, int_keys):
    b, k, c = _rows(N, 8, N, int_keys)
    hard = k2_ref.hard_rows(b, c)
    before = k2.launches
    got = k2_ops.waterfill_grants(b, k, c, hard.to(cuda), device=cuda)
    assert k2.launches == before + 1
    assert torch.equal(got.cpu(), k2_ref.waterfill_grants_ref(b, k, c, hard))


def test_waterfill_rejects_too_wide_rows(cuda):
    b = torch.zeros((1, k2.MAX_QUEUES + 1), dtype=torch.float64,
                    device=cuda)
    with pytest.raises(ValueError, match="shared"):
        k2.waterfill_grants_cuda(b, b, b[:, 0].contiguous(),
                                 torch.ones(1, dtype=torch.bool,
                                            device=cuda))


def _clients(ids, seed=0, m_lo=1e5, m_hi=1e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.5)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _sweeps():
    cfg4 = PONConfig(n_onus=4, line_rate_bps=1e9)
    cfg8 = PONConfig(n_onus=8, line_rate_bps=1e9)
    wl = FLRoundWorkload(clients=_clients([0, 1, 2, 3, 6], seed=1),
                         model_bits=1.5e6)
    mixed = [SweepCase(workload=wl, load=load, policy=policy, seed=s)
             for policy in ("fcfs", "bs") for load in (0.3, 0.8)
             for s in (0, 1)]
    topo = MultiPonTopology(n_pons=2, cps_rate_bps=1.1e9)
    cps = [SweepCase(workload=FLRoundWorkload(
        clients=_clients(ids, seed=5), model_bits=1e6), load=load,
        policy=policy, seed=s, topology=topo)
        for policy, ids in (("fcfs", [0, 1, 5, 6, 7, 9, 12]),
                            ("bs", [0, 1, 5, 6, 7]))
        for load in (0.2, 0.35) for s in (0, 1)]
    rng = np.random.default_rng(7)
    dl = rng.poisson(0.5, (3000, 4)) * 12_000.0
    ul = rng.poisson(0.5, (3000, 4)) * 12_000.0
    wl3 = FLRoundWorkload(clients=_clients([0, 1, 2, 3, 5], seed=9,
                                           m_lo=1e6, m_hi=3e6),
                          model_bits=2e6)
    injected = [SweepCase(workload=wl3, load=0.5, policy="fcfs", seed=3,
                          dl_arrivals=dl, ul_arrivals=ul),
                SweepCase(workload=wl3, load=0.5, policy="fcfs", seed=4,
                          no_dl_ids=frozenset({1, 5}))]
    return {
        "mixed": SweepSpec(cases=tuple(mixed), pon=cfg8),
        "two_pon_cps": SweepSpec(cases=tuple(cps), pon=cfg4),
        "injected": SweepSpec(cases=tuple(injected), pon=cfg4),
        "deadline": SweepSpec(cases=tuple(injected), pon=cfg4,
                              ul_deadline_s=[0.4, None]),
        "outage": SweepSpec(cases=tuple(injected), pon=cfg4,
                            ul_outage_s=[(0.1, 0.2), None]),
    }


@pytest.mark.parametrize("name", list(_sweeps()))
def test_sweep_on_card_equals_cpu(cuda, name):
    spec = _sweeps()[name]
    want = simulate(spec, device="cpu")
    got = simulate(spec, device=cuda)
    for a, b in zip(want, got):
        assert a.sync_time == b.sync_time
        for field in ("dl_done", "ready", "ul_done", "ul_remaining"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.keys() == y.keys()
                assert np.array_equal(np.array(list(x.values())),
                                      np.array(list(y.values())),
                                      equal_nan=True), field
