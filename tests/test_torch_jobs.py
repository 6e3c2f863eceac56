"""The port's multi-tenant jobs against ``repro.net.jobs``, on the CPU.

The same inputs (numpy seeds, carried over with
``repro_torch.net.convert.from_reference``) run through the JAX
package's ``simulate`` (its numpy engine) and the port's
``simulate(..., device="cpu")`` on the per-cycle loop (``backend=None``)
and with ``backend="jit"`` (which, with more than one job a case, runs
the same loop, as the reference does):

* ``job_fair_split`` bit for bit under the three policies, random
  demands and caps (scalar and per row), unit weights equal to
  ``"maxmin"``;
* multi-job rounds under both DBAs and the three policies, with real
  contention (updates of 5-60 Mbit at 1 Gb/s), on one PON and on 3 PONs
  under a binding CPS uplink: every client's times and every job's
  stats within 1e-9 s of the JAX engine, and within rtol 1e-6 of its
  cycle-level oracle ``simulate_jobs_round_reference`` and of the
  port's;
* the single-job op point exactly 5.058100000000024, a cadenced jobs
  timeline, the jobs validation errors, ``from_reference`` keeping
  ``fairness``, a co-simulation with competing jobs;
* the values ``chip_smoke.py`` pins for its ``jobs`` phase
  (``JOBS_PINS``), recomputed with the JAX package.
"""
import importlib.util
import pathlib
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.net as J
import repro_torch.net as T
import test_torch_cosim as cosim_tests
from repro.core.slicing import ClientProfile
from repro_torch.net.jobs import job_fair_split as t_split

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = J.PONConfig(n_onus=16, line_rate_bps=1e9)
SYNC_ABS = 1e-9
ORACLE_RTOL = 1e-6
BACKENDS = [None, "jit"]
OP_POINT_SYNC = 5.058100000000024
ref_params = cosim_tests.ref_params


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jobs(ids, n_jobs, weights=None, deadlines=None, cadence=None):
    """Round-robin partition of ``ids`` into ``n_jobs`` jobs."""
    return tuple(J.JobSpec(
        job_id=j, clients=tuple(i for k, i in enumerate(ids)
                                if k % n_jobs == j),
        model_bits=4e5 * (j + 1),
        weight=weights[j] if weights else 1.0,
        deadline_s=deadlines[j] if deadlines else None,
        period=cadence[j][0] if cadence else 1,
        phase=cadence[j][1] if cadence else 0) for j in range(n_jobs))


def _case(policy, fairness, n_jobs=3, topology=None, n=9, seed=3, **kw):
    """Updates of 5-60 Mbit ready within 0.3 s: the jobs contend."""
    rng = np.random.default_rng(seed)
    clients = [ClientProfile(client_id=i, t_ud=float(rng.uniform(0.05, 0.3)),
                             t_dl=0.0, m_ud_bits=float(rng.uniform(5e6, 6e7)))
               for i in range(n)]
    return J.SweepCase(
        workload=J.FLRoundWorkload(clients=clients, model_bits=4e5),
        load=0.5, policy=policy, seed=seed, topology=topology,
        jobs=_jobs(list(range(n)), n_jobs, **kw), fairness=fairness)


POLICY_KW = {"maxmin": {}, "weighted": {"weights": [1.0, 3.0, 0.5]},
             "deadline": {"deadlines": [0.3, 0.1, None]}}


def _port(cfg, cases, backend=None, schedule=None):
    return T.simulate(T.SweepSpec(
        cases=tuple(T.from_reference(list(cases))),
        pon=T.from_reference(cfg), backend=backend,
        schedule=T.from_reference(schedule)), device="cpu")


def _assert_round(want, got, rtol=None):
    """Every client's times and every job's stats: within ``SYNC_ABS``
    (``rtol`` None) or within ``rtol`` (the oracle)."""
    def close(a, b):
        if rtol is None:
            return abs(a - b) <= SYNC_ABS
        return b == pytest.approx(a, rel=rtol, abs=1e-12)

    for name in ("dl_done", "ready", "ul_done"):
        a, b = getattr(want, name), getattr(got, name)
        assert set(a) == set(b), name
        for cid in a:
            assert close(a[cid], b[cid]), (name, cid, a[cid], b[cid])
    assert close(want.sync_time, got.sync_time)
    assert set(want.job_stats) == set(got.job_stats)
    for jid, wj in want.job_stats.items():
        gj = got.job_stats[jid]
        assert close(wj.sync_time, gj.sync_time), jid
        assert gj.n_clients == wj.n_clients
        for tier in ("onu_done", "olt_done"):
            a, b = getattr(wj, tier), getattr(gj, tier)
            assert set(a) == set(b), tier
            for k in a:
                assert close(a[k], b[k]), (tier, k)


# -- job_fair_split -----------------------------------------------------------

@pytest.mark.parametrize("fairness", ["maxmin", "weighted", "deadline"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_job_fair_split_bit_for_bit(fairness, seed):
    rng = np.random.default_rng(seed)
    for trial in range(40):
        G, n = int(rng.integers(1, 24)), int(rng.integers(1, 10))
        d = rng.uniform(0.0, 10.0, (G, n)) * (rng.uniform(0, 1, (G, n)) > 0.2)
        cap = (rng.uniform(0.0, 30.0, G) if trial % 2
               else float(rng.uniform(0.0, 30.0)))
        w = (rng.uniform(0.5, 2.0, n) if trial % 3
             else rng.uniform(0.5, 2.0, (G, n)))
        sl = rng.uniform(-2.0, 5.0, (G, n))
        sl[:, ::2] = np.inf
        want = J.job_fair_split(d, cap, fairness, weights=w, slack=sl)
        got = t_split(torch.from_numpy(d),
                      torch.as_tensor(cap, dtype=torch.float64), fairness,
                      weights=torch.from_numpy(np.asarray(w)),
                      slack=torch.from_numpy(sl))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
        # a vector is one row
        np.testing.assert_array_equal(
            t_split(d[0], float(np.atleast_1d(cap)[0]), fairness,
                    weights=np.broadcast_to(w, d.shape)[0].copy(),
                    slack=sl[0]).numpy(),
            J.job_fair_split(d[0], float(np.atleast_1d(cap)[0]), fairness,
                             weights=np.broadcast_to(w, d.shape)[0],
                             slack=sl[0]))


def test_job_fair_split_unit_weights_and_passthrough():
    rng = np.random.default_rng(3)
    d = rng.uniform(0.0, 10.0, (16, 3))
    cap = rng.uniform(2.0, 20.0, 16)
    np.testing.assert_array_equal(
        t_split(d, cap, "weighted", weights=np.ones(3)).numpy(),
        t_split(d, cap, "maxmin").numpy())
    np.testing.assert_array_equal(
        t_split(d, cap, "maxmin").numpy(), J.job_fair_split(d, cap))
    fits = np.array([[1.0, 2.0, 3.0], [0.5, 0.0, 1.0]])
    for fairness in J.FAIRNESS_POLICIES:
        np.testing.assert_array_equal(
            t_split(fits, 100.0, fairness, weights=[1.0, 2.0, 3.0],
                    slack=[3.0, 2.0, 1.0]).numpy(), fits)
    with pytest.raises(ValueError, match="unknown fairness"):
        t_split([1.0], 1.0, "roundrobin")


# -- rounds -------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fairness", ["maxmin", "weighted", "deadline"])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_jobs_round_matches_reference(policy, fairness, backend):
    case = _case(policy, fairness, **POLICY_KW[fairness])
    want = J.simulate(J.SweepSpec(cases=(case,), pon=CFG))[0]
    got = _port(CFG, [case], backend)[0]
    _assert_round(want, got)
    _assert_round(J.simulate_jobs_round_reference(CFG, case), got,
                  ORACLE_RTOL)
    _assert_round(T.simulate_jobs_round_reference(
        T.from_reference(CFG), T.from_reference(case), device="cpu"), got,
        ORACLE_RTOL)
    # the jobs contend: the policy moves the jobs' syncs
    other = "maxmin" if fairness != "maxmin" else "deadline"
    moved = J.simulate(J.SweepSpec(cases=(replace(
        case, fairness=other, jobs=_jobs(list(range(9)), 3,
                                         **POLICY_KW[other])),),
        pon=CFG))[0]
    assert ({j: s.sync_time for j, s in moved.job_stats.items()}
            != {j: s.sync_time for j, s in want.job_stats.items()})


@pytest.mark.parametrize("fairness", ["maxmin", "weighted", "deadline"])
@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_jobs_multi_pon_cps(policy, fairness):
    """3 PONs of 4 ONUs, 3 jobs, under a 1.5 Gb/s CPS uplink."""
    topo = J.MultiPonTopology(n_pons=3, cps_rate_bps=1.5e9)
    cfg = J.PONConfig(n_onus=4, line_rate_bps=1e9)
    case = _case(policy, fairness, topology=topo, **POLICY_KW[fairness])
    if policy == "fcfs":
        # light background: the CPS binds on the uploads, not on a
        # background that would starve them
        case = replace(case, load=0.05)
    want = J.simulate(J.SweepSpec(cases=(case,), pon=cfg))[0]
    got = _port(cfg, [case])[0]
    _assert_round(want, got)
    _assert_round(J.simulate_jobs_round_reference(cfg, case), got,
                  ORACLE_RTOL)
    _assert_round(T.simulate_jobs_round_reference(
        T.from_reference(cfg), T.from_reference(case), device="cpu"), got,
        ORACLE_RTOL)
    free = J.simulate(J.SweepSpec(cases=(replace(
        case, topology=J.MultiPonTopology(n_pons=3)),), pon=cfg))[0]
    assert free.sync_time != want.sync_time      # the CPS binds


def test_batched_cases_with_phantom_jobs():
    """Cases with 2 and 3 jobs in one sweep (the 2-job case padded with
    a phantom job) match their solo runs and the reference."""
    cases = [_case("fcfs", "maxmin", 2, seed=4),
             _case("fcfs", "maxmin", 3, seed=5)]
    want = J.simulate(J.SweepSpec(cases=tuple(cases), pon=CFG))
    got = _port(CFG, cases)
    for w, g, case in zip(want, got, cases):
        _assert_round(w, g)
        solo = _port(CFG, [case])[0]
        assert solo.ul_done == g.ul_done


def _op_case(module, profile, jobs=None):
    rng = np.random.default_rng(42)
    t_uds = rng.uniform(1.0, 5.0, 128)
    clients = [profile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                       m_ud_bits=26.416e6) for i in range(12)]
    wl = module.FLRoundWorkload(clients=clients, model_bits=26.416e6)
    return module.SweepCase(workload=wl, load=0.8, policy="fcfs", seed=1,
                            jobs=jobs)


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_job_op_point_pin(backend):
    """An all-single-job sweep runs the plain path bit for bit, on both
    backends (the plain sweep's pin is ``tests/test_torch_timeline.py``'s
    and ``tests/test_torch_engine.py``'s)."""
    from repro_torch.core.slicing import ClientProfile as TProfile

    cfg = T.PONConfig(n_onus=128)
    jobs = (T.JobSpec(job_id=0, clients=tuple(range(12)),
                      model_bits=26.416e6),)
    tenant = T.simulate(T.SweepSpec(cases=(_op_case(T, TProfile, jobs),),
                                    pon=cfg, backend=backend),
                        device="cpu")[0]
    assert tenant.sync_time == OP_POINT_SYNC      # exact
    assert tenant.job_stats[0].sync_time == OP_POINT_SYNC
    assert tenant.job_stats[0].n_clients == 12
    if backend is None:
        plain = T.simulate(T.SweepSpec(cases=(_op_case(T, TProfile),),
                                       pon=cfg), device="cpu")[0]
        assert tenant.ul_done == plain.ul_done
        # single-job sweeps keep the single-tenant knobs
        cut = T.simulate(T.SweepSpec(cases=(_op_case(T, TProfile, jobs),),
                                     pon=cfg, ul_deadline_s=4.0),
                         device="cpu")[0]
        assert cut.sync_time <= OP_POINT_SYNC


# -- timelines ----------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fcfs", "bs"])
def test_cadenced_jobs_timeline(policy):
    case = _case(policy, "weighted", cadence=[(1, 0), (2, 0), (2, 1)],
                 **POLICY_KW["weighted"])
    sched = J.TimelineSchedule(n_rounds=4)
    want = J.simulate(J.SweepSpec(cases=(case,), pon=CFG,
                                  schedule=sched))[0]
    got = _port(CFG, [case], schedule=sched)[0]
    assert len(got.rounds) == 4
    for r, (a, b) in enumerate(zip(want.rounds, got.rounds)):
        assert set(b.job_sync) == ({0, 1} if r % 2 == 0 else {0, 2})
        assert set(b.job_sync) == set(a.job_sync)
        for jid, s in a.job_sync.items():
            assert abs(b.job_sync[jid] - s) <= SYNC_ABS
        assert abs(b.sync_time - a.sync_time) <= SYNC_ABS
        _assert_round(a.result, b.result)
    per_round = T.simulate_timeline_per_round(
        T.from_reference(CFG), T.from_reference([case]),
        T.from_reference(sched), device="cpu")[0]
    assert [r.job_sync for r in per_round.rounds] == [
        r.job_sync for r in got.rounds]


# -- validation ---------------------------------------------------------------

def _errors(mod, profile, **sim_kw):
    """(name, call, exception, message) that both packages must raise;
    ``sim_kw`` goes to ``simulate``."""
    clients = [profile(client_id=i, t_ud=0.1, t_dl=0.0, m_ud_bits=1e5)
               for i in range(4)]
    wl = mod.FLRoundWorkload(clients=clients, model_bits=4e5)
    cfg = mod.PONConfig(n_onus=8, line_rate_bps=1e9)
    two = (mod.JobSpec(job_id=0, clients=(0, 1), model_bits=1e5),
           mod.JobSpec(job_id=1, clients=(2, 3), model_bits=1e5))
    tenant = mod.SweepCase(workload=wl, load=0.5, policy="fcfs", jobs=two)
    sched = mod.TimelineSchedule(n_rounds=2)

    def run(*cases, **kw):
        return lambda: mod.simulate(mod.SweepSpec(cases=cases, pon=cfg,
                                                  **kw), **sim_kw)

    return [
        ("overlap", run(replace(tenant, jobs=(
            mod.JobSpec(job_id=0, clients=(0, 1), model_bits=1e5),
            mod.JobSpec(job_id=1, clients=(1, 2, 3), model_bits=1e5)))),
         ValueError, "belongs to jobs"),
        ("hole", run(replace(tenant, jobs=(mod.JobSpec(
            job_id=0, clients=(0, 1, 2), model_bits=1e5),))),
         ValueError, "partition"),
        ("duplicate-id", run(replace(tenant, jobs=(
            mod.JobSpec(job_id=0, clients=(0, 1), model_bits=1e5),
            mod.JobSpec(job_id=0, clients=(2, 3), model_bits=1e5)))),
         ValueError, "duplicate job_id"),
        ("deadline-knob", run(tenant, ul_deadline_s=1.0), ValueError,
         "per-job deadlines"),
        ("unknown-fairness", run(replace(tenant, fairness="fifo")),
         ValueError, "unknown fairness"),
        ("mixed-fairness", run(tenant, replace(tenant, fairness="deadline")),
         ValueError, "one fairness policy"),
        ("jobless-case", run(tenant, replace(tenant, jobs=None)),
         ValueError, "has no jobs"),
        ("no-dl-ids", run(replace(tenant, no_dl_ids=frozenset({0}))),
         ValueError, "no_dl_ids"),
        ("injected", run(replace(tenant, dl_arrivals=np.zeros((4, 8)),
                                 ul_arrivals=np.zeros((4, 8)))),
         ValueError, "single-tenant parity hook"),
        ("plain-schedule", run(tenant, schedule=mod.TimelineSchedule(
            n_rounds=2, membership=np.ones((2, 4), bool))),
         ValueError, "plain schedule"),
        ("mixed-timeline", run(tenant, replace(tenant, jobs=None),
                               schedule=sched), ValueError, "mix"),
        ("sequential", run(tenant, schedule=sched, mode="sequential"),
         ValueError, "always fold"),
        ("no-clients", lambda: mod.JobSpec(job_id=0, clients=(),
                                           model_bits=1.0),
         ValueError, "has no clients"),
        ("model-bits", lambda: mod.JobSpec(job_id=0, clients=(0,),
                                           model_bits=0.0),
         ValueError, "model_bits"),
        ("weight", lambda: mod.JobSpec(job_id=0, clients=(0,),
                                       model_bits=1.0, weight=0.0),
         ValueError, "weight"),
        ("period", lambda: mod.JobSpec(job_id=0, clients=(0,),
                                       model_bits=1.0, period=0),
         ValueError, "period"),
        ("phase", lambda: mod.JobSpec(job_id=0, clients=(0,),
                                      model_bits=1.0, phase=-1),
         ValueError, "phase"),
    ]


ERRORS = [e[0] for e in _errors(J, ClientProfile)]


@pytest.mark.parametrize("idx", range(len(ERRORS)), ids=ERRORS)
def test_jobs_value_errors(idx):
    from repro_torch.core.slicing import ClientProfile as TProfile

    for mod, profile, kw in ((J, ClientProfile, {}),
                             (T, TProfile, {"device": "cpu"})):
        _, call, exc, frag = _errors(mod, profile, **kw)[idx]
        with pytest.raises(exc, match=frag):
            call()


def test_helpers_match_reference():
    job = T.JobSpec(job_id=1, clients=(0,), model_bits=1e5, period=3,
                    phase=2)
    assert [job.active_in(r) for r in range(7)] == [
        False, False, True, False, False, True, False]
    want = J.make_competing_jobs([0, 1, 2], 1e6, n_jobs=2, clients_each=2)
    got = T.make_competing_jobs([0, 1, 2], 1e6, n_jobs=2, clients_each=2)
    assert T.from_reference(list(want[0])) == list(got[0])
    assert T.from_reference(list(want[1])) == list(got[1])
    rng = np.random.default_rng(0)
    clients = _case("bs", "maxmin").workload.clients
    rates = [J.pon_bg_rates(clients, 4e5, 0.6, CFG,
                            J.MultiPonTopology(n_pons=2),
                            model_bits_by_client={c.client_id: float(
                                rng.uniform(1e5, 1e6)) for c in clients}),
             J.pon_bg_rates(clients, 4e5, 0.6, CFG,
                            J.MultiPonTopology(n_pons=2))]
    rng = np.random.default_rng(0)
    got = [T.pon_bg_rates(T.from_reference(clients), 4e5, 0.6,
                          T.from_reference(CFG), T.MultiPonTopology(n_pons=2),
                          model_bits_by_client={c.client_id: float(
                              rng.uniform(1e5, 1e6)) for c in clients}),
           T.pon_bg_rates(T.from_reference(clients), 4e5, 0.6,
                          T.from_reference(CFG), T.MultiPonTopology(n_pons=2))]
    for a, b in zip(rates, got):
        np.testing.assert_array_equal(a, b)


def test_from_reference_keeps_jobs_and_fairness():
    case = _case("bs", "deadline", **POLICY_KW["deadline"])
    port = T.from_reference(case)
    assert port.fairness == "deadline"
    assert isinstance(port.jobs[0], T.JobSpec)
    assert [j.deadline_s for j in port.jobs] == [0.3, 0.1, None]
    assert T.from_reference(list(case.jobs)) == list(port.jobs)


def test_spec_with_jobs():
    case = _case("bs", "maxmin")
    spec = T.SweepSpec(cases=(T.from_reference(replace(case, jobs=None)),),
                       pon=T.from_reference(CFG)).with_jobs(
        T.from_reference(case.jobs), fairness="weighted")
    assert spec.cases[0].fairness == "weighted"
    got = T.simulate(spec, device="cpu")[0]
    want = J.simulate(J.SweepSpec(cases=(replace(
        case, jobs=None), ), pon=CFG).with_jobs(case.jobs, "weighted"))[0]
    _assert_round(want, got)


# -- the values chip_smoke.py pins --------------------------------------------

def reference_pins() -> dict:
    """``chip_smoke.py``'s jobs phase (``jobs_specs``) on the JAX
    package: every case's and every job's sync."""
    cs = _load_chip_smoke()
    return {name: cs.job_outcomes(J.simulate(spec)[0])
            for name, spec in cs.jobs_specs(
                types=(J, ClientProfile)).items()}


def test_chip_smoke_jobs_pins_equal_the_reference():
    assert _load_chip_smoke().JOBS_PINS == reference_pins()


# -- co-simulation ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["timeline", "per_round"])
def test_cosim_with_competing_jobs(ref_params, backend):
    """The FL task (job 0, the co-sim's 4 clients) against two tenants
    of 2 clients each under weighted fairness: each round's sync is job
    0's, as in the reference."""
    jobs, profiles = J.make_competing_jobs(
        range(cosim_tests.N_CLIENTS), 2e6, n_jobs=2, clients_each=2,
        t_ud=0.5, weight=2.0)
    ref, port, jtest, ttest = cosim_tests._pair(
        ref_params, timing_seeds=2, jobs=jobs, job_clients=profiles,
        fairness="weighted")
    want = ref.run(2, eval_fn=lambda p: cosim_tests.jcnn.accuracy(p, jtest),
                   backend=backend)
    got = port.run(2, eval_fn=lambda p: cosim_tests.tcnn.accuracy(p, ttest),
                   backend=backend)
    cosim_tests._assert_same(want, got, len(jtest["labels"]))
    with pytest.raises(ValueError, match="per-job deadlines"):
        port.run(1, deadline_s=1.0)
