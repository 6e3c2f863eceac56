"""The port on a CUDA card against its own plain path, bit for bit.

Every test here needs a card (``cuda`` marker) and skips without one;
the file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain versions, and whole sweeps on the
card (kernels, device-side queue state, the column-by-column prefix
sums) to the same sweeps on the CPU. K1 and K2 are held bit for bit;
The fused phase kernel is held to ``run_phase_ref`` on CPU copies of the
same inputs: ``done_t`` bit for bit, ``rem`` within 1e-9, the same exact
flag. K4 (flash attention) within 2e-5 in float32 (the same function summed in
another order; the plain version's products run in full float32, TF32
off) and 2e-2 in bfloat16 (both outputs rounded to bf16). K4 with its
log-sum-exp gives K4's output bit for bit and the plain lse within
2e-5; the backward from it (``csrc/flash_attn_bwd.cu``) gives dq, dk, dv
within 2e-5 (float32) or 2^-7 (bfloat16) of the largest magnitude of
``flash_attention_bwd_ref``'s on the same inputs, the same bits over
ten calls. K5 (the SSD
scan) computes in float32 from inputs of either type, like its plain
version: y and the final state within 1e-4 of the plain version's
largest value (the reference package's own kernel test measure), on
both of its routes (bf16 at head dim 64 on the tensor cores, with its
fp32 operands split into hi + lo bf16 pairs). K6 (the
RG-LRU scan) computes in float32 from inputs of either type, like its
plain version, in chunks of time steps combined in order (its rounding
differs where a chunk's carry enters through a product of decays): within
1e-5 of the plain version's largest value. K3 and K3' (int8 quantise and
dequantise) are held bit for bit: the same IEEE divisions, roundings and
products in both, at every block size (past the card's on-chip capacity
too), on zeros of either sign, over repeated calls and on two streams
at once.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import data as fl_data
from repro_torch import fl
from repro_torch.configs import get_config
from repro_torch.core.slicing import ClientProfile
from repro_torch.dist import stepfns
from repro_torch.kernels.attention import kernel as k4
from repro_torch.kernels.attention import ops as k4_ops
from repro_torch.kernels.attention import ref as k4_ref
from repro_torch.launch.serve import serve
from repro_torch.kernels.quant import kernel as k3
from repro_torch.kernels.quant import ops as k3_ops
from repro_torch.kernels.quant import ref as k3_ref
from repro_torch.models import cnn, lm
from repro_torch.kernels.ponsim import kernel as k2
from repro_torch.kernels.rglru import kernel as k6
from repro_torch.kernels.rglru import ops as k6_ops
from repro_torch.kernels.rglru import ref as k6_ref
from repro_torch.kernels.ssd import kernel as k5
from repro_torch.kernels.ssd import ops as k5_ops
from repro_torch.kernels.ssd import ref as k5_ref
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


def _k1_args(cuda, lams):
    keys = np.stack([k1_ops.make_stream_key(s, 1, 0, s % 2)
                     for s in range(len(lams))])
    lams = np.asarray(lams, np.float32)
    n_draws = k1_ops._tail_bound(float(lams.max()) * k1_ref.WINDOW)
    thr = torch.as_tensor(k1_ref.poisson_thresholds(
        lams.astype(np.float64) * k1_ref.WINDOW, n_draws), device=cuda)
    kt = torch.as_tensor(keys.astype(np.int64), device=cuda)
    starts, lengths = k1_ops._table(1 / 16, cuda)
    return kt, thr, starts, lengths


# K1's shapes: the engine's chunks; n_cycles under a window at 1, 129 and
# 2048 ONUs; lo > 0 across three windows; an even row cut into odd spans
# (74 ONUs at 4096 cycles)
K1_SHAPES = [
    (0, 64, 8), (77, 130, 2), (63, 65, 1), (0, 1024, 128),
    (5120, 1024, 2048), (0, 50, 1), (3, 50, 129), (7, 40, 2048),
    (100, 150, 37), (36, 150, 129), (0, 4096, 74),
]


@pytest.mark.parametrize("cycle0,n_cycles,n_onus", K1_SHAPES)
@pytest.mark.parametrize("lams", [(0.12, 0.3, 0.0, 2.5), (0.0, 5.0, 3.0)])
def test_sampler_kernel_matches_plain(cuda, cycle0, n_cycles, n_onus, lams):
    """The second batch mixes a row at rate 0 with rows whose draw
    budget runs to the hundreds (n_draws 543)."""
    kt, thr, starts, lengths = _k1_args(cuda, lams)
    before = k1.launches
    got = k1.sample_arrival_bits_cuda(
        kt, cycle0, thr, starts, lengths, PKT, n_cycles=n_cycles,
        n_onus=n_onus)
    want = k1_ref.sample_arrival_bits_ref(
        kt, cycle0, thr, starts, lengths, PKT, n_cycles=n_cycles,
        n_onus=n_onus)
    assert k1.launches == before + 1
    assert torch.equal(got, want)


def test_sampler_kernel_past_default_shared_memory(cuda):
    """A draw budget whose thresholds pass 48 KB of shared memory: the
    kernel opts in to more."""
    kt, thr, starts, lengths = _k1_args(cuda, (0.0, 180.0))
    assert 4 * thr.shape[1] > 48 * 1024
    got = k1.sample_arrival_bits_cuda(kt, 5, thr, starts, lengths, PKT,
                                      n_cycles=70, n_onus=3)
    want = k1_ref.sample_arrival_bits_ref(kt, 5, thr, starts, lengths,
                                          PKT, n_cycles=70, n_onus=3)
    assert torch.equal(got, want)


def test_sampler_kernel_is_one_device_operation(cuda):
    """A call launches the kernel and nothing else on the card: no
    memset, no cast, no multiply."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kt, thr, starts, lengths = _k1_args(cuda, (0.12, 0.3, 0.0, 2.5))
    args = (kt, 0, thr, starts, lengths, PKT)
    k1.sample_arrival_bits_cuda(*args, n_cycles=1024, n_onus=128)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k1.sample_arrival_bits_cuda(*args, n_cycles=1024, n_onus=128)
        torch.cuda.synchronize()
    ops = [(e.key, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    assert len(ops) == 1 and ops[0][1] == 3, ops
    assert "traffic_kernel" in ops[0][0]


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


@pytest.mark.parametrize("N", [2458, 4096, 11_000, 16_384, 20_000])
@pytest.mark.parametrize("int_keys", [False, True])
def test_waterfill_kernel_at_any_row_width(cuda, N, int_keys):
    """Rows past the old 2457-queue limit, up to the card's shared memory
    (16,384 queues) and past it (the wrapper's global scratch)."""
    b, k, c = _rows(N, 2, N, int_keys)
    hard = k2_ref.hard_rows(b, c)
    before = k2.launches
    got = k2_ops.waterfill_grants(b, k, c, hard.to(cuda), device=cuda)
    assert k2.launches == before + 1
    assert torch.equal(got.cpu(), k2_ref.waterfill_grants_ref(b, k, c, hard))


def test_full_width_4096_round_on_card(cuda):
    """One FCFS load-0.8 round on one PON of 4096 ONUs, every ONU a
    client, through K2 at 4096 queues a row: the numpy engine's sync
    time (``chip_smoke.SYNC_4096``, recomputed from the JAX package by
    ``tests/test_torch_engine.py``)."""
    cs = _chip_smoke()
    before = k2.launches
    res = simulate(cs.full_width_spec(4096), device=cuda)[0]
    assert k2.launches > before
    assert abs(res.sync_time - cs.SYNC_4096) <= 1e-9


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


PHASE_SWEEPS = ["fast_bs", "multi", "cps_masks", "overload"]


def _hold_phase_to_plain(cuda, args, kwargs) -> None:
    """One recorded phase through the phase kernel and through
    ``run_phase_ref`` on CPU copies of the same inputs: ``done_t`` bit for
    bit, ``rem`` within 1e-9, the same exact flag, one launch."""
    sc, tc = k2_ops.phase_inputs(*args, **kwargs, use_k2=True, device=cuda)
    sh, th = k2_ops.phase_inputs(*args, **kwargs, use_k2=True, device="cpu")
    before = k2.phase_launches
    got_t, got_r, got_x = k2.run_phase_cuda(sc, tc)
    assert k2.phase_launches == before + 1
    want_t, want_r, want_x = k2_ref.run_phase_ref(sh, th)
    assert got_x == want_x
    np.testing.assert_array_equal(got_t.cpu().numpy(), want_t.numpy())
    torch.testing.assert_close(got_r.cpu(), want_r, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("name", PHASE_SWEEPS)
def test_phase_kernel_equals_plain(cuda, name):
    """Every phase of ``chip_smoke.phase_check_sweeps()[name]`` through the
    phase kernel and through ``run_phase_ref`` on CPU copies of the same
    inputs (the scalar-S path with background, several clients an ONU, bs
    slots, 3-PON CPS with deadline and outage, an inexact overload)."""
    cs = _chip_smoke()
    calls = cs._record_phases(cs.phase_check_sweeps()[name], cuda)
    assert calls
    for args, kwargs in calls:
        _hold_phase_to_plain(cuda, args, kwargs)


def test_jit_sweep_on_card(cuda):
    """The fig2b-16 sweep through ``backend="jit"``: every sync equals the
    JAX engine's, three phase launches, no standalone K1/K2 launch, no
    re-run on the per-cycle loop; then each of its three phases (up to
    128 clients, 10 Gb/s, 1,774 to 6,312 cycles) through the kernel
    against its plain version, every client's ``done_t`` and ``rem``."""
    from repro_torch.net import engine

    cs = _chip_smoke()
    names, cases = cs.fig2b_cases()
    spec = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=cs.N_ONUS),
                     backend="jit")
    k1_before, k2_before = k1.launches, k2.launches
    phases, fallbacks = k2.phase_launches, engine.phase_fallbacks
    res = simulate(spec, device=cuda)
    assert {n: r.sync_time for n, r in zip(names, res)} == cs.SYNC_TABLE
    assert k2.phase_launches - phases == 3
    assert (k1.launches, k2.launches) == (k1_before, k2_before)
    assert engine.phase_fallbacks == fallbacks
    calls = cs._record_phases(spec, cuda)
    assert len(calls) == 3
    for args, kwargs in calls:
        _hold_phase_to_plain(cuda, args, kwargs)


def test_timeline_on_card(cuda):
    """A 16-ONU, 3-round defer timeline (``chip_smoke.op_point_spec``'s
    short one: FCFS and BS, deadline 0.35 s) through ``backend="jit"``:
    every round and client within ``ROUND_RTOL`` of the per-cycle loop on
    the card, no phase re-run on the per-cycle loop, and each round's
    phases launched once each (fcfs download, fcfs upload, bs upload)
    with no standalone K1/K2 launch."""
    import dataclasses

    from repro_torch.net import engine

    cs = _chip_smoke()
    spec = cs.op_point_spec("defer", "jit", short=True)
    k1_before, k2_before = k1.launches, k2.launches
    phases, fallbacks = k2.phase_launches, engine.phase_fallbacks
    jit = simulate(spec, device=cuda)
    assert engine.phase_fallbacks == fallbacks
    assert k2.phase_launches - phases == 3 * cs.SHORT_ROUNDS
    assert (k1.launches, k2.launches) == (k1_before, k2_before)
    loop = simulate(dataclasses.replace(spec, backend=None), device=cuda)
    assert k1.launches > k1_before and k2.launches > k2_before
    deferred = 0
    for a, b in zip(jit, loop):
        for x, y in zip(a.rounds, b.rounds):
            assert abs(x.sync_time - y.sync_time) <= 1e-9
            assert x.arrived == y.arrived and x.staleness == y.staleness
            cs._hold_round(f"round {x.round_index}", x.result, y.result)
            deferred += len(x.deferred)
    assert deferred


def test_jit_full_width_4096_round_on_card(cuda):
    """The 4096-ONU round through the phase kernel (K2's sort at 4096
    queues inside it): the numpy engine's sync."""
    import dataclasses

    cs = _chip_smoke()
    spec = dataclasses.replace(cs.full_width_spec(4096), backend="jit")
    res = simulate(spec, device=cuda)[0]
    assert abs(res.sync_time - cs.SYNC_4096) <= 1e-9


def _wide_phases(cuda, names):
    cs = _chip_smoke()
    return [(args, kwargs) for name, args, kwargs in cs.wide_phases(cuda)
            if name in names], cs


@pytest.mark.parametrize("names", [("pons33", "pons100"), ("clients33",),
                                   ("row16385",)])
def test_phase_kernel_at_any_width(cuda, names):
    """Past the widths the phase kernel once refused (F4), every phase of
    ``chip_smoke.wide_check_sweeps()`` against ``run_phase_ref`` on CPU
    copies: 33 and 100 PONs a case (CPS binding), an ONU with 33 clients,
    one row of 16,385 queues (its sort's pairs in global scratch); the
    counting pour still raises on the card."""
    import dataclasses

    calls, cs = _wide_phases(cuda, names)
    assert calls
    seen = set()
    for args, kwargs in calls:
        _hold_phase_to_plain(cuda, args, kwargs)
        sc, tc = k2_ops.phase_inputs(*args, **kwargs, use_k2=True,
                                     device=cuda)
        seen |= {c for c, hit in cs.WIDE_COVER.items() if hit(sc, tc)}
        if sc.N > 16_384:
            assert "sort" not in k2.phase_plan(sc, tc)["regions_on_chip"]
    want = {"pons33": {"33 PONs a case", "100 PONs a case"},
            "clients33": {"33 clients an ONU"},
            "row16385": {"a row of 16,385 queues"}}[names[0]]
    assert want <= seen
    with pytest.raises(NotImplementedError, match="counting pour"):
        k2.run_phase_cuda(dataclasses.replace(sc, use_k2=False), tc)


def test_phase_kernel_bs_several_slots_an_onu_under_cps(cuda):
    """A bs phase under a binding 2-PON CPS whose ONUs hold 3 slots each
    (``chip_smoke.wide_phases``' ``slots_cps``): each ONU's grants added
    in slot order, at each PON's capacity and at the CPS level, against
    ``run_phase_ref`` on CPU copies."""
    calls, cs = _wide_phases(cuda, ("slots_cps",))
    bs = [(a, kw) for a, kw in calls if a[4] == "bs"]
    assert bs
    for args, kwargs in bs:
        sc, tc = k2_ops.phase_inputs(*args, **kwargs, use_k2=True,
                                     device=cuda)
        assert sc.has_cps and cs._slots_an_onu(tc) == 3
        _hold_phase_to_plain(cuda, args, kwargs)


# (B, S, T, H, K, D, causal, window): the grid of tests/test_kernels.py,
# port-only shapes, and recurrentgemma-2b's heads (D 256, MQA, windows)
K4_GRID = [
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 128, 128, 8, 8, 32, True, None),
    (1, 333, 333, 4, 1, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, 64),
    (1, 192, 192, 2, 2, 128, False, None),
    (1, 96, 96, 4, 4, 64, True, 8),
    (2, 40, 40, 4, 2, 16, True, 8),
    (1, 50, 70, 4, 2, 32, True, None),
    (1, 70, 50, 2, 1, 16, False, 24),
    (1, 300, 300, 10, 1, 256, True, 64),
    (2, 128, 128, 4, 1, 256, True, None),
    (1, 100, 100, 2, 2, 256, False, None),
    (1, 200, 200, 10, 1, 256, True, 8),
]
K4_DTYPES = {"float32": (torch.float32, 2e-5),
             "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def cuda_fp32(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    return cuda


def _qkv(B, S, T, H, K, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)))


@pytest.mark.parametrize("dtype", list(K4_DTYPES))
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", K4_GRID)
def test_flash_kernel_matches_plain(cuda_fp32, B, S, T, H, K, D, causal,
                                    window, dtype):
    dt, tol = K4_DTYPES[dtype]
    q, k, v = _qkv(B, S, T, H, K, D, dt, cuda_fp32)
    before = (k4.launches, k4.launches_tc)
    got = k4.flash_attention_cuda(q, k, v, causal, window)
    tc = k4.route(dt, D) == "tensor_cores"
    assert (k4.launches, k4.launches_tc) == (before[0] + 1, before[1] + tc)
    want = k4_ref.attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (B, S, H, D)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# bf16 at the tensor-core kernel's tile edges (64 query rows, 64 keys):
# one row, rows either side of a tile, T != S both ways, window 1, windows
# cutting inside a tile, MQA 10:1 at D 256; every row keeps a live key
K4_TC_EDGES = [
    (1, 1, 1, 2, 1, 64, True, None),
    (2, 63, 63, 4, 2, 128, True, None),
    (1, 65, 65, 4, 4, 128, False, None),
    (1, 129, 129, 10, 1, 256, True, None),
    (1, 65, 100, 4, 2, 64, True, None),
    (1, 129, 70, 4, 2, 128, True, None),
    (2, 129, 129, 4, 2, 64, True, 1),
    (1, 63, 90, 2, 1, 64, False, 30),
    (1, 200, 200, 10, 1, 256, True, 37),
    (2, 300, 300, 10, 1, 256, True, 100),
]


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", K4_TC_EDGES)
def test_flash_tc_kernel_at_tile_edges(cuda, B, S, T, H, K, D, causal,
                                       window):
    q, k, v = _qkv(B, S, T, H, K, D, torch.bfloat16, cuda, seed=S + T)
    before = k4.launches_tc
    got = k4.flash_attention_cuda(q, k, v, causal, window)
    assert k4.launches_tc == before + 1
    want = k4_ref.attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", [
    (1, 100, 100, 2, 1, 128, True, None),
    (1, 130, 130, 10, 1, 256, True, 40),
    (2, 256, 256, 4, 2, 64, False, None),
    (4, 2048, 2048, 16, 16, 128, True, None),
    (4, 2048, 2048, 10, 1, 256, True, 2048),
])
def test_flash_tc_kernel_repeats_exactly(cuda, B, S, T, H, K, D, causal,
                                         window):
    """Ten launches on the same inputs give the same bits: the kernel's
    copies, barriers and asynchronous products leave no race (a race on
    the registers of P once gave wrong rows in some runs only)."""
    q, k, v = _qkv(B, S, T, H, K, D, torch.bfloat16, cuda)
    first = k4.flash_attention_cuda(q, k, v, causal, window)
    want = k4_ref.attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(first.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    for _ in range(9):
        again = k4.flash_attention_cuda(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert torch.equal(again, first)


def test_flash_kernel_at_olmo_prefill(cuda_fp32):
    q, k, v = _qkv(4, 2048, 2048, 16, 16, 128, torch.bfloat16, cuda_fp32)
    before = k4.launches_tc
    got = k4_ops.flash_attention(q, k, v, causal=True)
    assert k4.launches_tc == before + 1
    want = k4_ref.attention_ref(q, k, v, True, None)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("S", [2048, 4096])
def test_flash_kernel_at_recurrentgemma_prefill(cuda_fp32, S):
    """MQA, heads of 256, window 2048: at 2048 tokens the window never
    cuts, at 4096 it does."""
    q, k, v = _qkv(4, S, S, 10, 1, 256, torch.bfloat16, cuda_fp32)
    before = k4.launches_tc
    got = k4_ops.flash_attention(q, k, v, causal=True, window=2048)
    assert k4.launches_tc == before + 1
    want = k4_ref.attention_ref(q, k, v, True, 2048)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 8, 8, 2, 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        k4.flash_attention_cuda(*_qkv(1, 8, 8, 2, 1, 48, torch.float32,
                                      cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k4.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="k must be"):
        k4.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        k4.flash_attention_cuda(q.transpose(1, 2), k, v)
    # an input that needs a gradient trains through the kernel: the
    # autograd Function's backward is autograd of the plain version
    before = k4.launches
    got = _grads(k4_ops.flash_attention, (q, k, v))
    assert k4.launches == before + 1
    assert all(torch.equal(a, b) for a, b in
               zip(got, _grads(k4_ref.attention_ref, (q, k, v))))


# the backward from the log-sum-exp (csrc/flash_attn_bwd.cu) and K4's lse:
# (B, S, T, H, K, D, causal, window) at every head dim, GQA and MQA,
# windows 1, 5 and S, T != S without a window, tiles ragged both ways;
# every row keeps a live key
BWD_GRID = [
    (2, 19, 19, 4, 4, 16, True, None),
    (1, 21, 21, 4, 2, 64, True, 5),
    (2, 20, 20, 4, 2, 16, True, 1),
    (1, 130, 130, 8, 2, 128, False, None),
    (1, 70, 70, 10, 1, 256, True, 70),
    (1, 100, 100, 4, 4, 64, False, 5),
    (1, 70, 90, 4, 1, 32, True, None),
    (1, 90, 70, 2, 2, 16, False, None),
    (2, 200, 200, 10, 1, 256, True, 37),
    (1, 129, 129, 16, 16, 128, True, None),
]
# float32: the same float32 function summed in another order; bfloat16:
# the kernel and the plain version both compute in float32 from the same
# bf16 inputs, each result rounded to bf16 once (one ulp, 2^-8 of a value)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def _rel_close(got, want, tol, what):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), what
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} of {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", BWD_GRID)
def test_flash_lse_and_backward_match_plain(cuda_fp32, B, S, T, H, K, D,
                                            causal, window, dtype):
    """K4's output with lse is K4's output bit for bit, its lse within
    2e-5 of the plain version's; the backward's dq, dk, dv from it against
    ``flash_attention_bwd_ref`` on the same (q, k, v, out, lse, g)."""
    q, k, v = _qkv(B, S, T, H, K, D, dtype, cuda_fp32, seed=S + D)
    g = torch.randn((B, S, H, D), generator=torch.Generator(
        device=cuda_fp32).manual_seed(1), device=cuda_fp32).to(dtype)
    before = (k4.launches, k4.bwd_launches)
    out, lse = k4.flash_attention_lse_cuda(q, k, v, causal, window)
    assert torch.equal(out, k4.flash_attention_cuda(q, k, v, causal, window))
    _, want_lse = k4_ref.flash_attention_lse_ref(q, k, v, causal, window)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
    got = k4.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
    want = k4_ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal,
                                          window)
    torch.cuda.synchronize()
    assert (k4.launches, k4.bwd_launches) == (
        before[0] + 2, before[1] + k4.BWD_LAUNCHES_A_CALL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _rel_close(a, b, BWD_TOL[dtype], name)


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", [
    (1, 130, 130, 10, 1, 256, True, 40),
    (4, 512, 512, 16, 16, 128, True, None),
    (4, 512, 512, 10, 1, 256, True, 2048),
])
def test_flash_backward_repeats_exactly(cuda, B, S, T, H, K, D, causal,
                                        window):
    """Ten calls on the same inputs give the same bits: no atomics, each
    output element written once, every sum in a fixed order."""
    q, k, v = _qkv(B, S, T, H, K, D, torch.bfloat16, cuda)
    g = torch.randn((B, S, H, D), device=cuda).to(torch.bfloat16)
    out, lse = k4.flash_attention_lse_cuda(q, k, v, causal, window)
    first = k4.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal, window)
    for _ in range(9):
        again = k4.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal,
                                            window)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_chunked_trains_through_the_kernels_and_pallas_recomputes(cuda):
    """On a card ``attn_impl="chunked"`` with a gradient launches the lse
    forward and the backward kernel (``FlashAttentionLSE``); ``"pallas"``
    keeps ``FlashAttention`` (K4, then the plain recompute); the
    refusals hold on the card too."""
    from repro_torch.configs.base import LayerSpec
    from repro_torch.models import attention as tattn

    q, k, v = _qkv(2, 64, 64, 4, 2, 64, torch.bfloat16, cuda)
    q.requires_grad_(True)
    for impl, name, bwd in (("chunked", "FlashAttentionLSEBackward",
                             k4.BWD_LAUNCHES_A_CALL),
                            ("pallas", "FlashAttentionBackward", 0)):
        cfg = get_config("olmo-1b", smoke=True).replace(attn_impl=impl)
        before = (k4.launches, k4.bwd_launches)
        out = tattn._attend_full(q, k, v, cfg, LayerSpec(window=16), 64)
        assert out.grad_fn.next_functions[0][0].name() == name
        out.float().sum().backward()
        torch.cuda.synchronize()
        assert (k4.launches - before[0], k4.bwd_launches - before[1]) == (
            1, bwd)
    with pytest.raises(ValueError, match="no live key"):
        k4_ops.flash_attention_lse(q.detach(), k[:, :8], v[:, :8], True, 8)
    out, lse = k4.flash_attention_lse_cuda(q.detach(), k, v)
    with pytest.raises(ValueError, match="lse must be"):
        k4.flash_attention_bwd_cuda(q.detach(), k, v, out, lse.double(),
                                    out)


def _grads(fn, ins, n_out=1):
    """Input gradients of ``fn`` on leaf copies of ``ins`` against a
    fixed upstream gradient (seed 0) of each of its first ``n_out``
    outputs."""
    leaves = [t.detach().clone().requires_grad_(True) for t in ins]
    out = fn(*leaves)
    outs = out[:n_out] if isinstance(out, tuple) else (out,)
    g = torch.Generator(device=outs[0].device).manual_seed(0)
    ups = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
           for o in outs]
    return torch.autograd.grad(outs, leaves, ups)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _serve_steps(cfg, params, tokens, feed, dev):
    """Prefill logits and the decode logits of the fed tokens."""
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1] + 16,
                          device=dev)
    with torch.inference_mode():
        logits, cache = stepfns.make_prefill_step(cfg)(
            _to(params, dev), tokens.to(dev), cache)
        steps = [logits.cpu()]
        for tok in feed:
            logits, cache = stepfns.make_decode_step(cfg)(
                _to(params, dev), tok.to(dev), cache)
            steps.append(logits.cpu())
    return steps


@pytest.mark.parametrize("arch,kernels,prompt", [
    ("olmo-1b", {k4: 2}, 24), ("mamba2-780m", {k5: 2}, 29),
    ("recurrentgemma-2b", {k6: 4, k4: 2}, 21)])
def test_smoke_model_on_card_equals_cpu(cuda_fp32, arch, kernels, prompt):
    """float32 smoke model: the card (K4, K5 over chunks of 8, or K6 and
    K4 with windows of 8, in the prefill) against the CPU (the plain
    versions), teacher-forced with the CPU's greedy tokens; 1e-4 for
    cuBLAS's float32 summation order."""
    cfg = get_config(arch, smoke=True).replace(attn_impl="chunked")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt),
                           generator=torch.Generator().manual_seed(1))
    want = _serve_steps(cfg, params, tokens, [], "cpu")
    feed = []
    for _ in range(4):
        feed.append(want[-1][:, -1:].argmax(-1))
        want = _serve_steps(cfg, params, tokens, feed, "cpu")
    before = {kernel: kernel.launches for kernel in kernels}
    got = _serve_steps(cfg, params, tokens, feed, cuda_fp32)
    for kernel, n in kernels.items():                 # prefill, one a layer
        assert kernel.launches == before[kernel] + n
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,kernels", [
    ("olmo-1b", {k4: 0}), ("mamba2-780m", {k5: 2}),
    ("recurrentgemma-2b", {k6: 4, k4: 0})])
def test_serve_on_card(cuda, arch, kernels):
    """``serve()`` on the card at smoke size. ``smoke()`` selects the
    plain attention (as in the reference package), so K4 stays idle; the
    SSD and RG-LRU dispatches have no plain switch, so K5 runs in both
    smoke layers of the prefill and K6 in all four RG-LRU ones. The
    full-width runs are ``chip_smoke.py``'s."""
    before = {kernel: kernel.launches for kernel in kernels}
    out = serve(arch=arch, smoke=True, batch=2, prompt_len=16,
                max_new_tokens=4)
    assert out.shape == (2, 4)
    for kernel, n in kernels.items():
        assert kernel.launches == before[kernel] + n


# (B, S, H, P, N, chunk): the shapes of tests/test_kernels.py, ragged and
# whole lengths at mamba2 widths, the smoke widths, S below one chunk
K5_GRID = [
    (2, 120, 3, 16, 32, 128),
    (1, 256, 2, 64, 64, 64),
    (1, 33, 1, 8, 16, 8),
    (2, 2000, 2, 64, 128, 128),
    (1, 512, 3, 16, 16, 8),
    (1, 300, 2, 72, 200, 128),
]


def _ssd_args(B, S, H, P, N, dtype, dev, h0, strided, seed=0, bias=None):
    """x, B, C (as slices of one xBC tensor when ``strided``, as the
    model passes them), dt rising across heads so that some chunks sum
    dt |a| past 88.7 (or with the bias ``bias`` in every head), a, and
    h0 or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=dev)
    xbc[..., H * P:] *= 0.3
    xbc = xbc.to(dtype)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    if not strided:
        x, bm, cm = x.contiguous(), bm.contiguous(), cm.contiguous()
    shift = (torch.linspace(-4.0, 1.0, H, device=dev) if bias is None
             else torch.full((H,), bias, device=dev))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev) + shift)
    a = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.2)
    h = torch.randn((B, H, P, N), generator=g, device=dev) if h0 else None
    return x, bm, cm, dt, a, h


def _assert_rel(got, want, tol=1e-4):
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) / scale <= tol


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", K5_GRID)
def test_ssd_kernel_matches_plain(cuda_fp32, B, S, H, P, N, chunk, dtype,
                                  h0, strided):
    x, bm, cm, dt, a, h = _ssd_args(B, S, H, P, N, dtype, cuda_fp32, h0,
                                    strided)
    before = (k5.launches, k5.launches_tc)
    y, h_last = k5.ssd_scan_cuda(x, bm, cm, dt, a, chunk, h)
    tc = k5.route(dtype, P, N, chunk, k5.tma_strides(x, bm, cm)) \
        == "tensor_cores"
    assert (k5.launches, k5.launches_tc) == (before[0] + 1, before[1] + tc)
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, chunk, h)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P)
    assert h_last.shape == (B, H, P, N)
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)


# bf16 shapes at the tensor-core kernels' edges (B, S, H, P, N, chunk):
# S = 64 (one chunk of 64), S below one chunk, one position, ragged S
# (2000: 80 live rows in the last chunk), head groups of 4 with a
# remainder, chunk 64 at N 128 and chunk 128 at N 64
K5_TC_EDGES = [
    (1, 64, 2, 64, 64, 64),
    (1, 100, 3, 64, 128, 128),
    (1, 1, 2, 64, 128, 128),
    (2, 2000, 4, 64, 128, 128),
    (1, 300, 5, 64, 128, 64),
    (2, 256, 9, 64, 64, 128),
]


def _ssd_tc_shapes():
    """Every K5_GRID shape the tensor-core route takes, and the edges."""
    return [s for s in K5_GRID if s[3] in k5.TC_HEAD_DIMS
            and s[4] in k5.TC_STATES and s[5] in k5.TC_CHUNKS] + K5_TC_EDGES


@pytest.mark.parametrize("route", list(k5.ROUTES))
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", _ssd_tc_shapes())
def test_ssd_tc_shapes_on_both_routes(cuda_fp32, B, S, H, P, N, chunk, h0,
                                      strided, route):
    """bf16 where the tensor-core kernels take it, on each route: the
    tensor-core kernels and the CUDA-core kernel both within 1e-4."""
    x, bm, cm, dt, a, h = _ssd_args(B, S, H, P, N, torch.bfloat16,
                                    cuda_fp32, h0, strided, seed=S + H)
    assert k5.route(torch.bfloat16, P, N, chunk,
                    k5.tma_strides(x, bm, cm)) == "tensor_cores"
    before = (k5.launches, k5.launches_tc)
    y, h_last = k5.ssd_scan_cuda(x, bm, cm, dt, a, chunk, h, route_to=route)
    assert (k5.launches, k5.launches_tc) == (
        before[0] + 1, before[1] + (route == "tensor_cores"))
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, chunk, h)
    torch.cuda.synchronize()
    assert y.shape == (B, S, H, P) and h_last.shape == (B, H, P, N)
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)


@pytest.mark.parametrize("B,S,H,chunk,bias", [(2, 2048, 4, 128, None),
                                              (1, 2000, 3, 64, 2.0)])
def test_ssd_tc_kernel_past_the_overflow_point(cuda_fp32, B, S, H, chunk,
                                               bias):
    """Heads whose in-chunk sums of dt |a| pass 88.7 (at chunk 64 every
    head's step sizes are raised): the masked exponent keeps every value
    finite and right."""
    x, bm, cm, dt, a, h = _ssd_args(B, S, H, 64, 128, torch.bfloat16,
                                    cuda_fp32, True, True, seed=5, bias=bias)
    assert _chip_smoke()._chunk_sum(dt, a, chunk) > 88.8
    y, h_last = k5.ssd_scan_cuda(x, bm, cm, dt, a, chunk, h,
                                 route_to="tensor_cores")
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, chunk, h)
    torch.cuda.synchronize()
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)


@pytest.mark.parametrize("S", [2048, 2000])
def test_ssd_tc_kernel_heads_that_never_decay(cuda_fp32, S):
    """dt near 0 in every head: h0 and each chunk's state carry over all
    16 chunks, so the split operands' error compounds through the scan
    over chunk states. y and the final state hold within 1e-4."""
    x, bm, cm, dt, a, h = _ssd_args(2, S, 4, 64, 128, torch.bfloat16,
                                    cuda_fp32, True, True, seed=6, bias=-7.0)
    assert _chip_smoke()._chunk_sum(dt, a, 128) < 1.0
    y, h_last = k5.ssd_scan_cuda(x, bm, cm, dt, a, 128, h)
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, 128, h)
    torch.cuda.synchronize()
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)
    # the initial state is what the final state mostly holds here
    assert float((h_w - h).abs().max()) < float(h.abs().max())


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 300, 5, 128, 64),
    (2, 2000, 4, 128, 128),
    (4, 2048, 48, 128, 128),
])
def test_ssd_tc_kernel_repeats_exactly(cuda, B, S, H, N, chunk):
    """Ten launches on the same inputs give the same bits: the copies,
    barriers and asynchronous products of the three kernels leave no
    race (a race on the register A fragment once gave K4 wrong rows in
    some runs only)."""
    x, bm, cm, dt, a, h = _ssd_args(B, S, H, 64, N, torch.bfloat16, cuda,
                                    True, True)
    y, h_last = k5.ssd_scan_cuda(x, bm, cm, dt, a, chunk, h)
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, chunk, h)
    torch.cuda.synchronize()
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)
    for _ in range(9):
        y2, h2 = k5.ssd_scan_cuda(x, bm, cm, dt, a, chunk, h)
        torch.cuda.synchronize()
        assert torch.equal(y2, y) and torch.equal(h2, h_last)


def test_ssd_tc_route_refuses_what_it_does_not_take(cuda):
    """The tensor-core route asked for where it does not apply raises;
    nothing falls back."""
    x, bm, cm, dt, a, h = _ssd_args(1, 128, 2, 64, 128, torch.bfloat16, cuda,
                                    False, True)
    before = (k5.launches, k5.launches_tc)
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        k5.ssd_scan_cuda(x.float(), bm.float(), cm.float(), dt, a, 128,
                         route_to="tensor_cores")
    p16 = _ssd_args(1, 128, 2, 16, 128, torch.bfloat16, cuda, False, True)
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        k5.ssd_scan_cuda(*p16[:5], 128, route_to="tensor_cores")
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        k5.ssd_scan_cuda(x, bm, cm, dt, a, 32, route_to="tensor_cores")
    # x, B and C sliced from rows of H P + 2 N + 4 elements: 8-byte strides
    xbc = torch.zeros((1, 128, 2 * 64 + 2 * 128 + 4), device=cuda,
                      dtype=torch.bfloat16)
    xs = xbc[..., :128].reshape(1, 128, 2, 64)
    bs, cs = xbc[..., 128:256], xbc[..., 256:384]
    assert k5.route(torch.bfloat16, 64, 128, 128,
                    k5.tma_strides(xs, bs, cs)) == "cuda_cores"
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        k5.ssd_scan_cuda(xs, bs, cs, dt, a, 128, route_to="tensor_cores")
    with pytest.raises(ValueError, match="route_to"):
        k5.ssd_scan_cuda(x, bm, cm, dt, a, 128, route_to="tensor")
    assert (k5.launches, k5.launches_tc) == before
    # unaligned strides route to the CUDA cores, and are right there
    y, h_last = k5.ssd_scan_cuda(xs, bs, cs, dt, a, 128)
    assert (k5.launches, k5.launches_tc) == (before[0] + 1, before[1])


def test_ssd_launch_counts_by_route(cuda):
    """``launches`` counts scan calls on either route, ``launches_tc``
    those on the tensor cores: bf16 at mamba2-780m's widths (head dim
    64, state 128, chunk 128) goes there, float32 never does."""
    cfg = get_config("mamba2-780m")
    x, bm, cm, dt, a, h = _ssd_args(2, 200, 2, cfg.ssm.d_head,
                                    cfg.ssm.d_state, torch.bfloat16, cuda,
                                    True, True)
    before = (k5.launches, k5.launches_tc)
    k5_ops.ssd_scan(x, bm, cm, dt, a, cfg.ssm.chunk, h)
    assert (k5.launches, k5.launches_tc) == (before[0] + 1, before[1] + 1)
    k5_ops.ssd_scan(x.float(), bm.float(), cm.float(), dt, a,
                    cfg.ssm.chunk, h)
    assert (k5.launches, k5.launches_tc) == (before[0] + 2, before[1] + 1)


def test_ssd_kernel_equals_the_token_recurrence(cuda_fp32):
    """K5 against the slow exact oracle, chunk sums past 88.7."""
    x, bm, cm, dt, a, h = _ssd_args(1, 300, 3, 64, 128, torch.float32,
                                    cuda_fp32, True, True, seed=4)
    y, h_last = k5_ops.ssd_scan(x, bm, cm, dt, a, 128, h)
    y_w, h_w = k5_ref.ssd_scan_ref(x, bm, cm, dt, a, h)
    torch.cuda.synchronize()
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)


def test_ssd_kernel_at_mamba2_prefill(cuda_fp32):
    x, bm, cm, dt, a, _ = _ssd_args(4, 2048, 48, 64, 128, torch.bfloat16,
                                    cuda_fp32, False, True)
    h = torch.zeros((4, 48, 64, 128), device=cuda_fp32)
    y, h_last = k5_ops.ssd_scan(x, bm, cm, dt, a, 128, h)
    y_w, h_w = k5_ref.ssd_chunked_ref(x, bm, cm, dt, a, 128, h)
    torch.cuda.synchronize()
    _assert_rel(y, y_w)
    _assert_rel(h_last, h_w)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, bm, cm, dt, a, h = _ssd_args(1, 16, 2, 16, 16, torch.float32, cuda,
                                    True, False)
    with pytest.raises(ValueError, match="chunk"):
        k5.ssd_scan_cuda(x, bm, cm, dt, a, 0, h)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k5.ssd_scan_cuda(x.half(), bm.half(), cm.half(), dt, a, 8, h)
    with pytest.raises(ValueError, match="b_mat must be"):
        k5.ssd_scan_cuda(x, bm.bfloat16(), cm, dt, a, 8, h)
    with pytest.raises(ValueError, match="dense"):
        k5.ssd_scan_cuda(x.transpose(2, 3), bm, cm, dt, a, 8, h)
    with pytest.raises(ValueError, match="dt must be contiguous"):
        k5.ssd_scan_cuda(x, bm, cm, torch.stack([dt, dt], -1)[..., 0], a,
                         8, h)
    with pytest.raises(ValueError, match="state size"):
        big = torch.zeros((1, 16, 300), device=cuda)
        k5.ssd_scan_cuda(x, big, big, dt, a, 8)
    before = k5.launches
    got = _grads(lambda *t: k5_ops.ssd_scan(*t[:5], 8, t[5]),
                 (x, bm, cm, dt, a, h), n_out=2)
    assert k5.launches == before + 1
    want = _grads(lambda *t: k5_ref.ssd_chunked_ref(*t[:5], 8, t[5]),
                  (x, bm, cm, dt, a, h), n_out=2)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, want))


# (B, S, R, a_lo, a_hi): ragged S and R, recurrentgemma's width, slow
# decay (long memory) and fast, one step, one channel; S off K6's
# 8-step chunks and 64-step windows (1037), and off the windows at
# recurrentgemma's width (2000)
K6_GRID = [
    (1, 333, 200, 0.0, 1.0),
    (2, 300, 96, 0.2, 0.8),
    (4, 2048, 2560, 0.99, 0.9999),
    (4, 2048, 2560, 0.0, 0.05),
    (3, 17, 33, 0.0, 1.0),
    (1, 1, 5, 0.5, 0.5),
    (2, 9, 1, 0.9, 1.0),
    (1, 1037, 160, 0.99, 0.9999),
    (2, 2000, 2560, 0.99, 0.9999),
]


def _k6_args(B, S, R, lo, hi, dtype, dev, h0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = lo + (hi - lo) * torch.rand((B, S, R), generator=g, device=dev)
    b = torch.randn((B, S, R), generator=g, device=dev) * 0.1
    h = torch.randn((B, R), generator=g, device=dev) if h0 else None
    return a.to(dtype), b.to(dtype), h


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,lo,hi", K6_GRID)
def test_rglru_kernel_matches_plain(cuda_fp32, B, S, R, lo, hi, dtype, h0):
    a, b, h = _k6_args(B, S, R, lo, hi, dtype, cuda_fp32, h0)
    before = k6.launches
    got = k6.rglru_scan_cuda(a, b, h)
    assert k6.launches == before + 1
    want = k6_ref.rglru_scan_ref(a, b, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, S, R)
    _assert_rel(got, want, 1e-5)


def test_rglru_kernel_refuses_what_it_does_not_take(cuda):
    a, b, h = _k6_args(2, 16, 8, 0.0, 1.0, torch.float32, cuda, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k6.rglru_scan_cuda(a.half(), b.half(), h)
    with pytest.raises(ValueError, match="b must be"):
        k6.rglru_scan_cuda(a, b.bfloat16(), h)
    with pytest.raises(ValueError, match="contiguous"):
        k6.rglru_scan_cuda(a.transpose(0, 1).contiguous().transpose(0, 1),
                           b, h)
    with pytest.raises(ValueError, match="h0 must be"):
        k6.rglru_scan_cuda(a, b, h.bfloat16())
    with pytest.raises(ValueError, match="h0 must have shape"):
        k6.rglru_scan_cuda(a, b, h[:1])
    with pytest.raises(ValueError, match="CUDA"):
        k6.rglru_scan_cuda(a, b.cpu(), h)
    before = k6.launches
    got = _grads(k6_ops.rglru_scan, (a, b, h))
    assert k6.launches == before + 1
    assert all(torch.equal(a_, b_) for a_, b_ in
               zip(got, _grads(k6_ref.rglru_scan_ref, (a, b, h))))


# K3/K3' grid (shape, block): tests/test_kernels.py's shapes x {64, 256,
# 4096}, ragged tails, block >= n, and blocks past one CTA's 4096-element
# tile (the cooperative grid kernel): every CNN leaf at block = n, ragged many-tile
# blocks, one element
K3_GRID = ([(s, b) for s in [(100,), (1000, 37), (5, 5, 5)]
            for b in (64, 256, 4096)]
           + [((4097,), 4096), ((300,), 4096), ((1,), 4096), ((62,), 62),
              ((3136, 2048), 3136 * 2048), ((5, 5, 32, 64), 51200),
              ((2048,), 2048), ((2048, 62), 2048 * 62), ((5, 5, 1, 32), 800),
              ((3 * 8193 + 5,), 8193), ((6_603_710,), 4096),
              ((40_000,), 40_000), ((4099, 3), 4099)])


def _k3_input(shape, dtype, dev, seed=0, kind="normal"):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 1e-2
    if kind == "zeros":
        # the first half zero, every other one -0.0
        half = x.view(-1)[: x.numel() // 2]
        half.fill_(0.0)
        half[1::2] = -0.0
    elif kind == "ties":
        # powers-of-two amax per 64-block put x / scale on exact .5 ties
        flat = x.view(-1)
        flat.copy_(torch.round(flat * 4e3) / 2 + 0.5)
        flat[::64] = 127.0
    return x.to(dtype)


def _k3_check(x, block):
    before = (k3.quantize_launches, k3.dequantize_launches)
    q, s = k3.quantize_int8_cuda(x, block)
    qr, sr = k3_ref.quantize_int8_ref(x, block)
    deq = k3.dequantize_int8_cuda(q, s, block)
    deq_r = k3_ref.dequantize_int8_ref(qr, sr, block)
    torch.cuda.synchronize()
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(deq.view(torch.int32), deq_r.view(torch.int32))
    n = int(x.numel() > 0)
    assert (k3.quantize_launches, k3.dequantize_launches) == (
        before[0] + n, before[1] + n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block", K3_GRID)
def test_quant_kernels_match_plain(cuda, shape, block, dtype):
    _k3_check(_k3_input(shape, dtype, cuda), block)


@pytest.mark.parametrize("kind", ["zeros", "ties"])
@pytest.mark.parametrize("shape,block", [((1000, 37), 64), ((100_000,), 4096),
                                         ((100_000,), 100_000)])
def test_quant_kernels_zeros_and_ties(cuda, shape, block, kind):
    _k3_check(_k3_input(shape, torch.float32, cuda, kind=kind), block)


def test_quant_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(100, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.quantize_int8_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        k3.quantize_int8_cuda(x.view(10, 10).t())
    with pytest.raises(ValueError, match="at least 1"):
        k3.quantize_int8_cuda(x, 0)
    q, s = k3.quantize_int8_cuda(x, 32)
    with pytest.raises(ValueError, match="whole blocks"):
        k3.dequantize_int8_cuda(q[:-1], s, 32)
    with pytest.raises(ValueError, match="scales must have shape"):
        k3.dequantize_int8_cuda(q, s[:-1], 32)
    with pytest.raises(ValueError, match="CUDA"):
        k3.dequantize_int8_cuda(q, s.cpu(), 32)
    with pytest.raises(NotImplementedError, match="backward"):
        k3_ops.quantize_int8(x.requires_grad_())
    q, s = k3.quantize_int8_cuda(torch.zeros(0, device=cuda))
    assert q.numel() == 0 and s.numel() == 0


# K3 in one launch past the card's on-chip capacity (132 SMs x 231,424
# bytes: 7.6 M float32, 15.3 M bfloat16 elements), where each CTA reads
# the rest of its share twice; ragged n, several large blocks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", [(10_000_000, 10_000_000),
                                     (20_000_003, 20_000_003),
                                     (20_000_003, 6_000_001)])
def test_quant_kernel_past_on_chip_capacity(cuda, n, block, dtype):
    _k3_check(_k3_input((n,), dtype, cuda, seed=n % 97), block)


# x that does not start on 16 bytes: the elements before its first
# aligned one are taken apart, and q is written a byte at a time
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset,n,block", [(1, 126_976, 126_976),
                                            (3, 100_001, 100_001),
                                            (5, 3 * 8193 + 5, 8193)])
def test_quant_kernel_on_a_misaligned_input(cuda, offset, n, block, dtype):
    buf = _k3_input((n + offset,), dtype, cuda, seed=offset)
    _k3_check(buf[offset:], block)


def test_quant_kernel_repeats_exactly(cuda):
    """50 calls back to back on different inputs at fc1's shape, each bit
    for bit: the scratch slots and the grid barrier need no reset."""
    xs = [_k3_input((3136, 2048), torch.float32, cuda, seed=i,
                    kind=("normal", "zeros", "ties")[i % 3])
          for i in range(50)]
    n = xs[0].numel()
    got = [k3.quantize_int8_cuda(x, n) for x in xs]
    torch.cuda.synchronize()
    for x, (q, s) in zip(xs, got):
        qr, sr = k3_ref.quantize_int8_ref(x, n)
        assert torch.equal(q, qr) and torch.equal(s, sr)


def test_quant_kernel_on_two_streams(cuda):
    """K3 at block = n on two streams at once, each its own scratch."""
    xs = [_k3_input((3136, 2048), torch.float32, cuda, seed=10 + i)
          for i in range(2)]
    n = xs[0].numel()
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    got = [[] for _ in xs]
    for _ in range(10):
        for x, st, out in zip(xs, streams, got):
            with torch.cuda.stream(st):
                out.append(k3.quantize_int8_cuda(x, n))
    torch.cuda.synchronize()
    for x, out in zip(xs, got):
        qr, sr = k3_ref.quantize_int8_ref(x, n)
        for q, s in out:
            assert torch.equal(q, qr) and torch.equal(s, sr)


def test_fl_round_on_card_runs_k3(cuda):
    """Two int8 rounds of the CNN at full width on the card: K3 and K3'
    once per leaf of every arrived update, wire bits exact."""
    clients, _ = fl_data.build_federated_cnn_clients(
        4, 16, cnn.loss_fn, fl.LocalTrainConfig(lr=0.04, batch_size=8),
        seed=0)
    params = cnn.init_params(torch.Generator(device=cuda).manual_seed(0))
    server = fl.CPSServer(global_params=params, clients=clients,
                          compression=fl.CompressorConfig(scheme="int8"),
                          failure_prob=0.3, seed=1)
    k3.quantize_launches = k3.dequantize_launches = 0
    arrived = 0
    for _ in range(2):
        log = server.run_round()
        arrived += log.n_arrived
        assert log.update_bits == log.n_arrived * 52_829_936
    assert k3.quantize_launches == k3.dequantize_launches == 8 * arrived
    for leaf in server.global_params.values():
        for t in leaf.values():
            assert t.is_cuda and bool(torch.isfinite(t).all())


def test_train_on_the_card_under_a_gloo_group(cuda):
    """``train(device="cuda")`` under a caller's one-rank gloo group runs
    on the card (one rank takes the plain path: every leaf a CUDA
    tensor, no DTensor), and a mesh on the card under that group raises
    instead of falling back to the CPU."""
    import torch.distributed as dist

    from repro_torch import _dtensor
    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        with pytest.raises(ValueError, match="cuda mesh needs a nccl"):
            make_host_mesh(1, device="cuda")
        state, history = train(steps_per_round=1, rounds=1, n_pods=1,
                               global_batch=2, seq_len=16, device="cuda")
    finally:
        if started:
            dist.destroy_process_group()
    leaves = tree_leaves(state.params)
    assert all(t.is_cuda and not _dtensor.is_dtensor(t) for t in leaves)
    assert np.isfinite(history[0]["loss"])
