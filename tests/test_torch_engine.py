"""The port's round engine (plain path, ``device="cpu"``) against
``repro.net``'s numpy engine.

The Fig. 2b operating point must reproduce the pinned sync time within
1e-9 s; small sweeps covering both policies, a 2-PON topology with a CPS
rate, injected arrivals, deadlines, outages and skipped downloads must
agree at rtol 1e-6 (the contract between engines). Both engines are fed
the same inputs through ``repro_torch.net.convert.from_reference``.
"""
import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

import repro.net as J
import repro_torch.net as T
from repro.core.slicing import ClientProfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
M_BITS = 26.416e6
CFG4 = J.PONConfig(n_onus=4, line_rate_bps=1e9)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clients(ids, seed=0, m_lo=1e5, m_hi=1e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.5)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _both(cfg, cases, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.simulate_round_sweep(cfg, list(cases), **kw)
    spec = T.SweepSpec(cases=tuple(T.from_reference(list(cases))),
                       pon=T.from_reference(cfg), **kw)
    return want, T.simulate(spec, device="cpu")


def _assert_parity(want, got, rtol=1e-6):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.policy == b.policy
        for name in ("dl_done", "ready", "ul_done"):
            da, db = getattr(a, name), getattr(b, name)
            assert set(da) == set(db)
            for cid in da:
                if np.isnan(da[cid]):
                    assert np.isnan(db[cid])
                else:
                    assert db[cid] == pytest.approx(da[cid], rel=rtol,
                                                    abs=1e-12), (name, cid)
        assert b.sync_time == pytest.approx(a.sync_time, rel=rtol)
        assert b.compute_bound == pytest.approx(a.compute_bound, rel=rtol)
        if a.ul_remaining is None:
            assert b.ul_remaining is None
        else:
            assert set(a.ul_remaining) == set(b.ul_remaining)
            for cid, bits in a.ul_remaining.items():
                assert b.ul_remaining[cid] == pytest.approx(bits, rel=rtol)
        if a.slice_spec is None:
            assert b.slice_spec is None
        else:
            assert b.slice_spec.bandwidth_bps == pytest.approx(
                a.slice_spec.bandwidth_bps, rel=rtol)


@pytest.mark.parametrize("topology", [None, T.MultiPonTopology()])
def test_fig2b_operating_point_pin(topology):
    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, 128)
    clients = [T.from_reference(ClientProfile(
        client_id=i, t_ud=float(t_uds[i]), t_dl=0.0, m_ud_bits=M_BITS))
        for i in range(12)]
    wl = T.FLRoundWorkload(clients=clients, model_bits=M_BITS)
    case = T.SweepCase(workload=wl, load=0.8, policy="fcfs", seed=1,
                       topology=topology)
    res = T.simulate(T.SweepSpec(cases=(case,),
                                 pon=T.PONConfig(n_onus=128)),
                     device="cpu")[0]
    assert res.sync_time == pytest.approx(5.058100000000024, abs=1e-9)


def test_mixed_policy_sweep():
    wl = J.FLRoundWorkload(clients=_clients([0, 1, 2, 3, 6], seed=1),
                           model_bits=1.5e6)
    wl2 = J.FLRoundWorkload(clients=_clients([1, 3], seed=2),
                            model_bits=1e6, t_aggregate=0.01)
    cases = [J.SweepCase(workload=w, load=load, policy=policy, seed=s)
             for policy in ("fcfs", "bs") for load in (0.3, 0.8)
             for s, w in ((0, wl), (1, wl2))]
    _assert_parity(*_both(J.PONConfig(n_onus=8, line_rate_bps=1e9),
                          cases))


@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_two_pon_topology_with_cps(policy):
    topo = J.MultiPonTopology(n_pons=2, cps_rate_bps=1.1e9)
    ids = [0, 1, 5, 6, 7] if policy == "bs" else [0, 1, 5, 6, 7, 9, 12]
    wl = J.FLRoundWorkload(clients=_clients(ids, seed=5), model_bits=1e6)
    cases = [J.SweepCase(workload=wl, load=load, policy=policy, seed=s,
                         topology=topo)
             for load in (0.2, 0.35) for s in (0, 1)]
    _assert_parity(*_both(CFG4, cases))


def _injected_cases():
    rng = np.random.default_rng(7)
    dl = rng.poisson(0.5, (3000, 4)) * 12_000.0
    ul = rng.poisson(0.5, (3000, 4)) * 12_000.0
    wl = J.FLRoundWorkload(
        clients=_clients([0, 1, 2, 3, 5], seed=9, m_lo=1e6, m_hi=3e6),
        model_bits=2e6)
    return [
        J.SweepCase(workload=wl, load=0.5, policy="fcfs", seed=3,
                    dl_arrivals=dl, ul_arrivals=ul),
        J.SweepCase(workload=wl, load=0.5, policy="fcfs", seed=4,
                    no_dl_ids=frozenset({1, 5})),
    ]


@pytest.mark.parametrize("kw", [
    {},
    {"ul_deadline_s": 0.45},
    {"ul_deadline_s": [0.4, None]},
    {"ul_outage_s": [(0.1, 0.2), None]},
], ids=["plain", "scalar_deadline", "per_case_deadline", "outage"])
def test_injected_arrivals_deadlines_outages(kw):
    _assert_parity(*_both(CFG4, _injected_cases(), **kw))


def test_chip_smoke_sync_table_matches_reference():
    """chip_smoke.py holds the card's sync times to constants; they must
    be the JAX engine's values for the same cases."""
    cs = _load_chip_smoke()
    names, cases = cs.fig2b_cases()
    results = J.simulate(J.SweepSpec(
        cases=tuple(J.SweepCase(workload=J.FLRoundWorkload(
            clients=[ClientProfile(**vars(c)) for c in k.workload.clients],
            model_bits=k.workload.model_bits), load=k.load,
            policy=k.policy, seed=k.seed) for k in cases),
        pon=J.PONConfig(n_onus=cs.N_ONUS)))
    assert {n: r.sync_time for n, r in zip(names, results)} == \
        cs.SYNC_TABLE
    spec = cs.full_width_spec()
    case = spec.cases[0]
    ref_case = J.SweepCase(
        workload=J.FLRoundWorkload(
            clients=[ClientProfile(**vars(c))
                     for c in case.workload.clients],
            model_bits=case.workload.model_bits),
        load=case.load, policy=case.policy, seed=case.seed)
    res = J.simulate(J.SweepSpec(cases=(ref_case,),
                                 pon=J.PONConfig(**vars(spec.pon))))[0]
    assert res.sync_time == cs.SYNC_2048


def test_chip_smoke_sync_4096_matches_reference():
    """The 4096-ONU single-PON round that ``chip_smoke.py`` and the card
    tests hold K2's widest engine rows to: the numpy engine's sync."""
    cs = _load_chip_smoke()
    case = cs.full_width_spec(4096).cases[0]
    spec = cs.full_width_spec(4096)
    ref_case = J.SweepCase(
        workload=J.FLRoundWorkload(
            clients=[ClientProfile(**vars(c))
                     for c in case.workload.clients],
            model_bits=case.workload.model_bits),
        load=case.load, policy=case.policy, seed=case.seed)
    res = J.simulate(J.SweepSpec(cases=(ref_case,),
                                 pon=J.PONConfig(**vars(spec.pon))))[0]
    assert res.sync_time == cs.SYNC_4096


def test_not_ported_features_raise():
    wl = T.FLRoundWorkload(clients=T.from_reference(_clients([0, 1])),
                           model_bits=1e6)
    case = T.SweepCase(workload=wl, load=0.3, policy="fcfs")
    cfg = T.PONConfig(n_onus=4, line_rate_bps=1e9)
    # the collector (obs/) is ported: what stays refused, as in the
    # reference, is a collector on backend="jit" (the phase kernel
    # carries no instrumentation), on both entry forms; the same calls
    # on the per-cycle loop take it
    from repro_torch.obs import Collector

    for backend, spec_form in ((b, f) for b in ("jit", None)
                               for f in (True, False)):
        col = Collector(device="cpu")
        if spec_form:
            call = lambda: T.simulate(  # noqa: E731
                T.SweepSpec(cases=(case,), pon=cfg, backend=backend),
                collector=col, device="cpu")
        else:
            call = lambda: T.simulate_round_sweep(  # noqa: E731
                cfg, [case], collector=col, backend=backend, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            if backend == "jit":
                with pytest.raises(ValueError,
                                   match="does not support collector"):
                    call()
            else:
                call()
                assert [p.label for p in col.phases] == ["dl:fcfs",
                                                         "ul:fcfs"]
    # timelines, faults and jobs are ported: inputs of the wrong type are
    # refused as the reference refuses them
    with pytest.raises(TypeError, match="TimelineSchedule"):
        T.simulate(T.SweepSpec(cases=(case,), pon=cfg, schedule=object()),
                   device="cpu")
    with pytest.raises(TypeError, match="FaultSchedule"):
        T.TimelineSchedule(n_rounds=1, faults=object())
    # backend="jit" is ported; like the reference it takes no injected
    # arrival matrices
    injected = T.SweepCase(workload=wl, load=0.3, policy="fcfs",
                           dl_arrivals=np.zeros((64, 4)),
                           ul_arrivals=np.zeros((64, 4)))
    with pytest.raises(ValueError, match="jit"):
        T.simulate(T.SweepSpec(cases=(injected,), pon=cfg, backend="jit"),
                   device="cpu")


def test_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wl = T.FLRoundWorkload(clients=T.from_reference(_clients([0])),
                           model_bits=1e6)
    spec = T.SweepSpec(cases=(T.SweepCase(workload=wl, load=0.3,
                                          policy="bs"),),
                       pon=T.PONConfig(n_onus=4, line_rate_bps=1e9))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.simulate(spec)


def test_legacy_kwarg_form_matches_spec():
    wl = J.FLRoundWorkload(clients=_clients([0, 2, 3], seed=4),
                           model_bits=1e6)
    cases = [J.SweepCase(workload=wl, load=0.4, policy=p, seed=2)
             for p in ("fcfs", "bs")]
    port_cases = T.from_reference(cases)
    cfg = T.from_reference(CFG4)
    with pytest.warns(DeprecationWarning):
        legacy = T.simulate_round_sweep(cfg, port_cases, device="cpu")
    spec = T.simulate_round_sweep(
        cfg, T.SweepSpec(cases=tuple(port_cases)), device="cpu")
    assert [r.ul_done for r in legacy] == [r.ul_done for r in spec]


def test_from_reference_types():
    topo = J.MultiPonTopology(n_pons=2, cps_rate_bps=2e9,
                              pon_rates_bps=(1e9, 2e9))
    case = J.SweepCase(workload=J.FLRoundWorkload(
        clients=_clients([0, 3]), model_bits=5e5, t_aggregate=0.2),
        load=0.25, policy="bs", seed=9, stream_round=2,
        no_dl_ids=frozenset({3}), topology=topo)
    got = T.from_reference(case)
    assert isinstance(got, T.SweepCase)
    assert isinstance(got.topology, T.MultiPonTopology)
    assert got.topology.pon_rates_bps == (1e9, 2e9)
    assert isinstance(got.workload, T.FLRoundWorkload)
    assert [vars(c) for c in got.workload.clients] == [
        vars(c) for c in case.workload.clients]
    assert (got.load, got.seed, got.stream_round, got.no_dl_ids) == (
        0.25, 9, 2, frozenset({3}))
    with pytest.raises(TypeError):
        T.from_reference(object())
