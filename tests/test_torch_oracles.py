"""The port's cycle-level oracles against the JAX package's, on the CPU.

The same inputs (numpy seeds, carried over with ``from_reference``) run
through ``repro.net``'s oracles and the port's, ``device="cpu"``. Both
sides are the same host float arithmetic on the same counter streams,
so they are held bit for bit; each port oracle is also held to the
port's own engine at rtol 1e-6 (the engines' contract):

* ``simulate_multi_pon_round``: 3 PONs of 4 ONUs under a binding CPS
  uplink, both policies, plain and with a deadline, per-PON outage
  windows, carriers that skip the download and a later stream round;
  with a collector, its CPS counters and gauge (``multi_pon.*``) and the
  upload-delay histogram equal the JAX collector's, and the round is
  bitwise the run without one;
* ``simulate_timeline_reference``: free rounds, elastic membership, the
  three deadline policies, async rounds, quorum with faults, and a
  2-PON CPS timeline, round by round;
* ``simulate_jobs_round_reference``: both policies, the three fairness
  policies, on one PON and on 3 PONs under a CPS uplink, job stats
  included, and its refusals.
"""
import warnings

import numpy as np
import pytest

import repro.net as J
import repro_torch.net as T
import test_torch_jobs as jobs_tests
import test_torch_obs as obs_tests
from repro.core.slicing import ClientProfile
from test_torch_sim import same_result

ENGINE_RTOL = 1e-6
CFG4 = J.PONConfig(n_onus=4, line_rate_bps=1e9)
CFG8 = J.PONConfig(n_onus=8, line_rate_bps=1e9)
TOPO = J.MultiPonTopology(n_pons=3, cps_rate_bps=2.5e9)


def _clients(ids, seed=0, m_lo=1e5, m_hi=2e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.6)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _wl(policy, n_slots, seed=0):
    # fcfs puts several clients on an ONU; bs needs ids < n_onus * n_pons
    ids = (range(min(n_slots, 9)) if policy == "bs"
           else [0, 1, 5, 9, 13, 17, 19, 26])
    return J.FLRoundWorkload(clients=_clients(ids, seed), model_bits=1.5e6)


# -- multi-PON round -----------------------------------------------------------

MP_VARIANTS = {
    "plain": {},
    "deadline": {"ul_deadline_s": 0.4},
    # per-PON windows, PON 1 never dark; bs slots lost in a window
    # starve, so the deadline ends the round
    "outage": {"ul_outage_s": np.array([[0.05, 0.25], [np.inf, np.inf],
                                        [0.0, 0.1]]),
               "ul_deadline_s": 1.5},
    "no_dl": {"no_dl_ids": frozenset({1, 5})},
    "stream_round": {"stream_round": 2},
}


def _mp_both(policy, load, kw, collectors=(None, None)):
    wl = _wl(policy, TOPO.total_onus(CFG4))
    want = J.simulate_multi_pon_round(CFG4, TOPO, wl, load, policy, seed=4,
                                      collector=collectors[0], **kw)
    got = T.simulate_multi_pon_round(
        T.from_reference(CFG4), T.from_reference(TOPO),
        T.from_reference(wl), load, policy, seed=4,
        collector=collectors[1], device="cpu", **kw)
    return wl, want, got


@pytest.mark.parametrize("variant", sorted(MP_VARIANTS))
@pytest.mark.parametrize("load", [0.3, 0.8])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_multi_pon_round(policy, load, variant):
    kw = MP_VARIANTS[variant]
    wl, want, got = _mp_both(policy, load, kw)
    same_result(want, got)
    # the same oracle through simulate_round's reference backend
    same_result(got, T.simulate_round(
        T.from_reference(CFG4), T.from_reference(wl), load, policy, seed=4,
        backend="reference", topology=T.from_reference(TOPO),
        device="cpu", **kw))
    eng = T.simulate_round(T.from_reference(CFG4), T.from_reference(wl),
                           load, policy, seed=4, backend="vectorized",
                           topology=T.from_reference(TOPO), device="cpu",
                           **kw)
    same_result(got, eng, ENGINE_RTOL)
    if policy == "fcfs" and variant == "plain":
        free = T.simulate_multi_pon_round(
            T.from_reference(CFG4), T.MultiPonTopology(n_pons=3),
            T.from_reference(wl), load, policy, seed=4, device="cpu")
        assert free.dl_done != got.dl_done            # the CPS binds


@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_multi_pon_collector(policy):
    jc, tc = obs_tests._pair_collectors()
    _, want, got = _mp_both(policy, 0.8, {}, (jc, tc))
    same_result(want, got)
    same_result(got, _mp_both(policy, 0.8, {})[2])   # bitwise uninstrumented
    assert sorted(tc.counters) == sorted(jc.counters) == [
        "multi_pon.cps_eff_bits", "multi_pon.cps_want_bits"]
    for name, c in jc.counters.items():
        np.testing.assert_array_equal(tc.counters[name].value.numpy(),
                                      c.value, err_msg=name)
    jg, tg = jc.gauges["multi_pon.cps_util"], tc.gauges["multi_pon.cps_util"]
    assert list(tc.gauges) == ["multi_pon.cps_util"]
    for f in ("last", "min", "max", "sum", "count"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      getattr(jg, f), err_msg=f)
    assert int(tg.count) > 0
    if policy == "fcfs":
        assert float(tg.max) == pytest.approx(1.0)     # the CPS binds
    obs_tests._assert_collectors(jc, tc)


# -- timeline ------------------------------------------------------------------

def _membership(rounds, n, seed=17):
    m = np.random.default_rng(seed).random((rounds, n)) < 0.7
    m[0] = True
    return m


SCHEDULES = {
    "sync": lambda n: J.TimelineSchedule(n_rounds=3),
    "elastic": lambda n: J.TimelineSchedule(n_rounds=3,
                                            membership=_membership(3, n)),
    "defer": lambda n: J.TimelineSchedule(n_rounds=4, deadline_s=0.35),
    "drop": lambda n: J.TimelineSchedule(n_rounds=3, deadline_s=0.35,
                                         deadline_policy="drop"),
    "partial": lambda n: J.TimelineSchedule(n_rounds=3, deadline_s=0.35,
                                            deadline_policy="partial"),
    "async": lambda n: J.TimelineSchedule(n_rounds=3, buffer_k=3),
    "quorum_faults": lambda n: J.TimelineSchedule(
        n_rounds=4, deadline_s=0.35, quorum_frac=0.9,
        faults=J.FaultSchedule(seed=2, dropout_rate=0.2, loss_rate=0.2,
                               outage_rate=0.5, outage_duration_s=0.1,
                               outage_start_max_s=0.3)),
}
ROUND_FIELDS = ("round_index", "sync_time", "t_start", "t_end", "ul_bits",
                "arrived", "deferred", "staleness", "dropped", "partial",
                "failed", "lost", "retry_at", "gave_up", "quorum_met",
                "deadline_extensions")


def _same_timelines(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (b.policy, b.load, b.seed) == (a.policy, a.load, a.seed)
        assert len(b.rounds) == len(a.rounds)
        for x, y in zip(a.rounds, b.rounds):
            for name in ROUND_FIELDS:
                assert getattr(y, name) == getattr(x, name), (
                    x.round_index, name)
            if x.result is None:
                assert y.result is None
            else:
                same_result(x.result, y.result)


def _engine_close(ref, eng):
    """The engine's timeline within ``ENGINE_RTOL`` of the oracle's."""
    for a, b in zip(ref, eng):
        np.testing.assert_allclose(b.sync_times, a.sync_times,
                                   rtol=ENGINE_RTOL)
        for x, y in zip(a.rounds, b.rounds):
            assert y.arrived == x.arrived
            assert set(y.ul_bits) == set(x.ul_bits)
            for cid, bits in x.ul_bits.items():
                assert y.ul_bits[cid] == pytest.approx(bits, rel=ENGINE_RTOL,
                                                       abs=2.0)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_timeline_reference(policy, schedule):
    wl = _wl(policy, CFG8.n_onus)
    sched = SCHEDULES[schedule](len(wl.clients))
    cases = [J.SweepCase(workload=wl, load=load, policy=policy, seed=seed)
             for load, seed in ((0.5, 3), (0.8, 4))]
    want = J.simulate_timeline_reference(CFG8, cases, sched)
    tcfg, tcases = T.from_reference(CFG8), T.from_reference(cases)
    tsched = T.from_reference(sched)
    got = T.simulate_timeline_reference(tcfg, tcases, tsched, device="cpu")
    _same_timelines(want, got)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = T.simulate_timeline_sweep(tcfg, tcases, tsched, device="cpu")
    _engine_close(got, eng)
    if schedule in ("defer", "drop", "partial"):
        assert any(r.deferred or r.dropped or r.partial
                   for t in got for r in t.rounds)   # the deadline cuts


@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_timeline_reference_multi_pon(policy):
    cfg = CFG4
    topo = J.MultiPonTopology(n_pons=2, cps_rate_bps=1.6e9)
    wl = _wl(policy, topo.total_onus(cfg))
    sched = J.TimelineSchedule(n_rounds=3, deadline_s=0.4,
                               membership=_membership(3, len(wl.clients)))
    cases = [J.SweepCase(workload=wl, load=0.7, policy=policy, seed=6,
                         topology=topo)]
    want = J.simulate_timeline_reference(cfg, cases, sched)
    tcfg, tcases = T.from_reference(cfg), T.from_reference(cases)
    got = T.simulate_timeline_reference(tcfg, tcases,
                                        T.from_reference(sched),
                                        device="cpu")
    _same_timelines(want, got)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = T.simulate_timeline_sweep(tcfg, tcases,
                                        T.from_reference(sched),
                                        device="cpu")
    _engine_close(got, eng)


# -- jobs ----------------------------------------------------------------------

def _same_job_stats(want, got):
    assert list(got) == list(want)
    for jid, a in want.items():
        b = got[jid]
        assert (b.job_id, b.sync_time, b.n_clients) == (a.job_id,
                                                        a.sync_time,
                                                        a.n_clients)
        assert list(b.onu_done.items()) == list(a.onu_done.items())
        assert list(b.olt_done.items()) == list(a.olt_done.items())


@pytest.mark.parametrize("multi_pon", [False, True])
@pytest.mark.parametrize("fairness", ["maxmin", "weighted", "deadline"])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_jobs_reference(policy, fairness, multi_pon):
    cfg = CFG4 if multi_pon else jobs_tests.CFG
    case = jobs_tests._case(
        policy, fairness, topology=TOPO if multi_pon else None,
        **jobs_tests.POLICY_KW[fairness])
    if multi_pon and policy == "fcfs":
        case = J.SweepCase(**{**case.__dict__, "load": 0.05})
    want = J.simulate_jobs_round_reference(cfg, case)
    got = T.simulate_jobs_round_reference(
        T.from_reference(cfg), T.from_reference(case), device="cpu")
    same_result(want, got)
    _same_job_stats(want.job_stats, got.job_stats)
    jobs_tests._assert_round(got, jobs_tests._port(cfg, [case])[0],
                             ENGINE_RTOL)


def test_jobs_reference_refusals():
    case = T.from_reference(jobs_tests._case("fcfs", "maxmin"))
    cfg = T.from_reference(jobs_tests.CFG)
    bad = {
        "no_dl_ids": (frozenset({0}), "does not model no_dl_ids"),
        "ul_arrivals": (np.zeros((4, cfg.n_onus)), "injected matrices"),
        "fairness": ("roundrobin", "unknown fairness"),
        "policy": ("tdma", "unknown policy"),
    }
    for name, (value, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            T.simulate_jobs_round_reference(
                cfg, T.SweepCase(**{**case.__dict__, name: value}),
                device="cpu")
