"""The port's multi-round timeline against ``repro.net``'s, on the CPU.

The same inputs (made with numpy from a seed, carried over with
``repro_torch.net.convert.from_reference``) run through the JAX
package's ``simulate`` with a ``TimelineSchedule`` (its default numpy
engine) and through the port's ``simulate(..., device="cpu")`` on the
per-cycle loop (backend ``None``) and on ``backend="jit"`` (on the CPU,
``run_phase_ref``, the phase kernel's plain version). Cases mirror
``tests/test_timeline.py`` and ``tests/test_async_timeline.py``: elastic
membership, defer/drop/partial deadlines folded and sequential, async
buffers, quorum extensions, a 3-PON topology, per-round upload sizes and
an empty round. Per round, ``sync_time``, ``t_start`` and ``t_end`` must
agree within 1e-9 s; ``ul_bits``, ``deferred``, ``dropped`` and
``partial`` within rtol 1e-6 (the engines' contract); ``arrived``,
``staleness``, ``quorum_met`` and ``deadline_extensions`` exactly.

It also recomputes, with the JAX package, the reference values that
``chip_smoke.py`` pins for its ``timeline`` and ``cosim`` phases and
checks they equal the pinned constants.
"""
import importlib.util
import pathlib
import sys
import warnings

import numpy as np
import pytest

import repro.net as J
import repro_torch.net as T
from repro.core.slicing import ClientProfile
from repro_torch.core.slicing import ClientProfile as TProfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = J.PONConfig(n_onus=8, line_rate_bps=1e9)
SYNC_ABS = 1e-9
BITS_RTOL = 1e-6
BACKENDS = [None, "jit"]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clients(ids, seed=0, m_lo=1e5, m_hi=2e6):
    rng = np.random.default_rng(seed)
    return [ClientProfile(client_id=int(i),
                          t_ud=float(rng.uniform(0.05, 0.6)), t_dl=0.0,
                          m_ud_bits=float(rng.uniform(m_lo, m_hi)))
            for i in ids]


def _wl(policy, seed=0, t_aggregate=0.0):
    # fcfs puts several clients on an ONU; bs needs ids < n_onus * n_pons
    ids = range(6) if policy == "bs" else [0, 1, 5, 9, 17, 19]
    return J.FLRoundWorkload(clients=_clients(ids, seed), model_bits=1.5e6,
                             t_aggregate=t_aggregate)


def _cases(policy, loads=(0.6,), seeds=(5,), topology=None):
    return [J.SweepCase(workload=_wl(policy), load=load, policy=policy,
                        seed=seed, topology=topology)
            for load, seed in zip(loads, seeds)]


def _ref(cfg, cases, sched, mode="auto"):
    return J.simulate(J.SweepSpec(cases=tuple(cases), pon=cfg,
                                  schedule=sched, mode=mode))


def _port(cfg, cases, sched, backend, mode="auto"):
    return T.simulate(T.SweepSpec(
        cases=tuple(T.from_reference(list(cases))),
        pon=T.from_reference(cfg), schedule=T.from_reference(sched),
        mode=mode, backend=backend), device="cpu")


def _assert_parity(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a.policy, a.load, a.seed) == (b.policy, b.load, b.seed)
        assert len(a.rounds) == len(b.rounds)
        for x, y in zip(a.rounds, b.rounds):
            what = f"round {x.round_index}"
            assert y.round_index == x.round_index
            for name in ("sync_time", "t_start", "t_end"):
                assert abs(getattr(y, name) - getattr(x, name)) <= \
                    SYNC_ABS, (what, name)
            for name in ("ul_bits", "deferred", "dropped", "partial"):
                xd, yd = getattr(x, name), getattr(y, name)
                assert set(xd) == set(yd), (what, name)
                for cid, v in xd.items():
                    assert yd[cid] == pytest.approx(v, rel=BITS_RTOL), (
                        what, name, cid)
            assert y.arrived == x.arrived, what
            assert y.staleness == x.staleness, what
            assert y.quorum_met == x.quorum_met, what
            assert y.deadline_extensions == x.deadline_extensions, what
            assert (y.result is None) == (x.result is None), what


def _membership(seed, shape, frac):
    memb = np.random.default_rng(seed).random(shape) < frac
    memb[0] = True
    return memb


TOPO3 = J.MultiPonTopology(n_pons=3, cps_rate_bps=2.4e9)


def _scenarios():
    """name -> (cases, schedule, mode, what must have happened)."""
    out = {}
    for pol in ("fcfs", "bs"):
        out[f"elastic-{pol}"] = (
            _cases(pol, (0.5, 0.8), (3, 4)),
            J.TimelineSchedule(n_rounds=3,
                               membership=_membership(17, (3, 6), 0.7)),
            "folded", None)
        out[f"defer-{pol}"] = (
            _cases(pol), J.TimelineSchedule(n_rounds=3, deadline_s=0.35),
            "sequential", "deferred")
        for dpol in ("drop", "partial"):
            for mode in ("folded", "sequential"):
                out[f"{dpol}-{mode}-{pol}"] = (
                    _cases(pol),
                    J.TimelineSchedule(n_rounds=3, deadline_s=0.35,
                                       deadline_policy=dpol),
                    mode, "dropped" if dpol == "drop" else "partial")
        for k in (1, 3):
            out[f"async-k{k}-{pol}"] = (
                _cases(pol), J.TimelineSchedule(n_rounds=3, buffer_k=k),
                "auto", "deferred")
        out[f"quorum-{pol}"] = (
            _cases(pol),
            J.TimelineSchedule(n_rounds=3, deadline_s=0.15, quorum_frac=0.8,
                               quorum_max_extends=2),
            "auto", "extended")
        for name, sched in (
                ("async", J.TimelineSchedule(n_rounds=2, buffer_k=3)),
                ("partial", J.TimelineSchedule(
                    n_rounds=2, deadline_s=0.35, deadline_policy="partial")),
                ("drop", J.TimelineSchedule(n_rounds=2, deadline_s=0.35,
                                            deadline_policy="drop")),
                ("defer", J.TimelineSchedule(n_rounds=2, deadline_s=0.35))):
            out[f"pons3-{name}-{pol}"] = (
                _cases(pol, (0.4,), (5,), TOPO3), sched, "auto", None)
    out["m_ud-scalar"] = (
        _cases("fcfs", (0.4,), (0,)),
        J.TimelineSchedule(n_rounds=2, m_ud_bits=np.array([4e5, 8e5])),
        "auto", None)
    out["m_ud-per-client"] = (
        _cases("bs", (0.4,), (0,)),
        J.TimelineSchedule(n_rounds=2, m_ud_bits=np.random.default_rng(
            9).uniform(1e5, 1e6, (2, 6)), deadline_s=0.3,
            deadline_policy="partial"),
        "auto", None)
    empty = np.ones((3, 6), bool)
    empty[1] = False
    out["empty-round"] = (
        [J.SweepCase(workload=_wl("fcfs", t_aggregate=0.25), load=0.4,
                     policy="fcfs", seed=0)],
        J.TimelineSchedule(n_rounds=3, membership=empty),
        "auto", "empty")
    return out


SCENARIOS = _scenarios()


def _happened(res, what):
    rounds = [r for tl in res for r in tl.rounds]
    if what == "extended":
        return any(r.deadline_extensions for r in rounds)
    if what == "empty":
        return any(r.result is None for r in rounds)
    return any(getattr(r, what) for r in rounds)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_timeline_matches_reference(name, backend):
    cases, sched, mode, what = SCENARIOS[name]
    want = _ref(CFG, cases, sched, mode)
    got = _port(CFG, cases, sched, backend, mode)
    _assert_parity(want, got)
    if what is not None:
        assert _happened(want, what), f"{name}: no {what} round"


@pytest.mark.parametrize("backend", BACKENDS)
def test_folded_equals_sequential_exactly(backend):
    for sched in (
            J.TimelineSchedule(n_rounds=3,
                               membership=_membership(2, (3, 6), 0.6)),
            J.TimelineSchedule(n_rounds=2, deadline_s=0.35,
                               deadline_policy="drop"),
            J.TimelineSchedule(n_rounds=2, deadline_s=0.35,
                               deadline_policy="partial")):
        for pol in ("fcfs", "bs"):
            cases = _cases(pol, (0.7,), (1,))
            fold = _port(CFG, cases, sched, backend, "folded")
            seq = _port(CFG, cases, sched, backend, "sequential")
            for a, b in zip(fold, seq):
                assert a.sync_times.tolist() == b.sync_times.tolist()
                for x, y in zip(a.rounds, b.rounds):
                    assert (x.ul_bits, x.arrived, x.dropped, x.partial) == (
                        y.ul_bits, y.arrived, y.dropped, y.partial)


def _op_point_case(module, policy="fcfs"):
    rng = np.random.default_rng(42)
    t_uds = rng.uniform(1.0, 5.0, 128)
    profile = ClientProfile if module is J else TProfile
    clients = [profile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                       m_ud_bits=26.416e6) for i in range(12)]
    wl = module.FLRoundWorkload(clients=clients, model_bits=26.416e6)
    return module.SweepCase(workload=wl, load=0.8, policy=policy, seed=1)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw", [{}, dict(deadline_s=30.0),
                                dict(deadline_s=30.0,
                                     deadline_policy="drop")],
                         ids=["none", "defer", "drop"])
def test_operating_point_pin(kw, backend):
    """The Fig. 2b 0.8-load cell through three one-round schedules gives
    the pinned sync time."""
    res = T.simulate(T.SweepSpec(
        cases=(_op_point_case(T),), pon=T.PONConfig(n_onus=128),
        schedule=T.TimelineSchedule(n_rounds=1, **kw), backend=backend),
        device="cpu")[0]
    assert abs(res.rounds[0].sync_time - 5.058100000000024) <= SYNC_ABS


def test_legacy_forms_and_per_round_loop():
    cases = _cases("fcfs", (0.5,), (3,))
    sched = J.TimelineSchedule(n_rounds=2, buffer_k=2)
    pc, ps, pcfg = (T.from_reference(cases), T.from_reference(sched),
                    T.from_reference(CFG))
    spec = T.SweepSpec(cases=tuple(pc), pon=pcfg, schedule=ps)
    want = T.simulate(spec, device="cpu")
    with pytest.warns(DeprecationWarning):
        legacy = T.simulate_timeline_sweep(pcfg, pc, ps, device="cpu")
    per_round = T.simulate_timeline_per_round(pcfg, pc, ps, device="cpu")
    by_spec = T.simulate_timeline_sweep(spec, device="cpu")
    for other in (legacy, per_round, by_spec):
        for a, b in zip(want, other):
            assert a.sync_times.tolist() == b.sync_times.tolist()
    built = T.SweepSpec.single_job(pc[0].workload.clients, 1.5e6, load=0.5,
                                   policy="fcfs", seed=3, pon=pcfg)
    got = T.simulate(built.with_schedule(ps), device="cpu")
    assert got[0].sync_times.tolist() == want[0].sync_times.tolist()


def test_schedule_arrays_are_copied():
    memb = np.ones((2, 6), bool)
    m_ud = np.full(2, 5e5)
    ref = J.TimelineSchedule(n_rounds=2, membership=memb, m_ud_bits=m_ud,
                             deadline_s=[0.3, 0.4],
                             deadline_policy="partial")
    got = T.from_reference(ref)
    assert isinstance(got, T.TimelineSchedule)
    memb[:] = False
    m_ud[:] = 1.0
    ref.membership[:] = False
    assert got.membership.all() and got.m_ud_bits.tolist() == [5e5, 5e5]
    assert got.deadline(1) == 0.4 and got.round_m_ud(0, 3, 0.0) == 5e5
    assert got.deadline_policy == "partial"


# every ValueError the reference raises for a schedule or a timeline spec:
# (what, keyword arguments or a call, the message fragment)
SCHEDULE_ERRORS = [
    (dict(n_rounds=0), "n_rounds"),
    (dict(n_rounds=1, deadline_s=1.0, deadline_policy="teleport"),
     "deadline_policy"),
    (dict(n_rounds=1, deadline_policy="drop"), "needs"),
    (dict(n_rounds=3, membership=np.ones((2, 4), bool)), "membership"),
    (dict(n_rounds=2, deadline_s=[1.0, 2.0, 3.0]), "deadline_s"),
    (dict(n_rounds=2, m_ud_bits=[1e5]), "m_ud_bits"),
    (dict(n_rounds=1, buffer_k=0), "buffer_k"),
    (dict(n_rounds=1, deadline_s=1.0, buffer_k=2), "buffer_k"),
    (dict(n_rounds=1, deadline_s=1.0, quorum_frac=1.5), "quorum_frac"),
    (dict(n_rounds=1, buffer_k=2, quorum_frac=0.5), "quorum_frac"),
    (dict(n_rounds=1, quorum_frac=0.5), "deadline_s"),
    (dict(n_rounds=1, deadline_s=1.0, quorum_frac=0.5,
          quorum_max_extends=-1), "quorum_max_extends"),
]


@pytest.mark.parametrize("kw,frag", SCHEDULE_ERRORS,
                         ids=[f"schedule{i}" for i in
                              range(len(SCHEDULE_ERRORS))])
def test_schedule_value_errors(kw, frag):
    for mod in (J, T):
        with pytest.raises(ValueError, match=frag):
            mod.TimelineSchedule(**kw)


def _sweep_errors(mod):
    case = mod.SweepCase(workload=_wl("fcfs") if mod is J else
                         T.from_reference(_wl("fcfs")), load=0.5,
                         policy="fcfs", seed=0)
    cfg = CFG if mod is J else T.from_reference(CFG)
    ts = mod.TimelineSchedule

    def run(sched, mode="auto", cases=(case,), **kw):
        spec = mod.SweepSpec(cases=tuple(cases), pon=cfg, schedule=sched,
                             mode=mode, **kw)
        extra = {} if mod is J else {"device": "cpu"}
        return lambda: mod.simulate(spec, **extra)

    injected = mod.SweepCase(workload=case.workload, load=0.5,
                             policy="fcfs", seed=0,
                             dl_arrivals=np.zeros((10, 8)))
    extra = {} if mod is J else {"device": "cpu"}
    return [
        ("defer-folded", run(ts(n_rounds=2, deadline_s=0.5), "folded"),
         "folded"),
        ("async-folded", run(ts(n_rounds=2, buffer_k=2), "folded"),
         "folded"),
        ("quorum-folded", run(ts(n_rounds=2, deadline_s=0.5,
                                 quorum_frac=0.5), "folded"), "folded"),
        ("membership-width", run(ts(n_rounds=2,
                                    membership=np.ones((2, 3), bool))),
         "membership"),
        ("injected", run(ts(n_rounds=1), cases=(injected,)),
         "counter streams"),
        ("unknown-mode", run(ts(n_rounds=1), "magic"), "unknown mode"),
        ("deadline-knob", run(ts(n_rounds=1), ul_deadline_s=1.0),
         "single-round"),
        ("mode-without-schedule", run(None, "folded"), "timeline knob"),
        ("no-schedule", lambda: mod.simulate_timeline_sweep(
            mod.SweepSpec(cases=(case,), pon=cfg), **extra), "schedule"),
        ("round-sweep-schedule", lambda: mod.simulate_round_sweep(
            mod.SweepSpec(cases=(case,), pon=cfg,
                          schedule=ts(n_rounds=1)), **extra),
         "carries a schedule"),
    ]


SWEEP_ERRORS = [name for name, _, _ in _sweep_errors(J)]


@pytest.mark.parametrize("idx", range(len(SWEEP_ERRORS)), ids=SWEEP_ERRORS)
def test_sweep_value_errors(idx):
    for mod in (J, T):
        _, call, frag = _sweep_errors(mod)[idx]
        with pytest.raises(ValueError, match=frag):
            call()


def test_not_ported_parts_raise():
    pc = T.from_reference(_cases("fcfs"))
    pcfg = T.from_reference(CFG)
    spec = T.SweepSpec(cases=tuple(pc), pon=pcfg,
                       schedule=T.TimelineSchedule(n_rounds=1))
    # faults, jobs and the collector (obs/) are ported: what stays
    # refused, as in the reference, is a collector on backend="jit", on
    # every timeline entry point, fault and tenant specs included; the
    # same calls on the per-cycle loop take it and record each round
    from dataclasses import replace

    from repro_torch.obs import Collector

    faulty = spec.with_faults(T.FaultSchedule(dropout_rate=0.5))
    tenant = spec.with_jobs((T.JobSpec(
        job_id=0, clients=[c.client_id for c in pc[0].workload.clients],
        model_bits=1e6),))
    for backend in ("jit", None):
        def calls(col):
            on = [replace(s, backend=backend)
                  for s in (spec, faulty, tenant)]
            return [
                lambda: T.simulate(on[0], collector=col, device="cpu"),
                lambda: T.simulate_timeline_sweep(on[0], collector=col,
                                                  device="cpu"),
                lambda: T.simulate_timeline_per_round(
                    pcfg, pc, spec.schedule, collector=col,
                    backend=backend, device="cpu"),
                lambda: T.simulate(on[1], collector=col, device="cpu"),
                lambda: T.simulate(on[2], collector=col, device="cpu"),
            ]
        for i in range(5):
            col = Collector(device="cpu")
            call = calls(col)[i]
            if backend == "jit":
                with pytest.raises(ValueError,
                                   match="does not support collector"):
                    call()
            else:
                call()
                assert len(col.rounds) == 1 and col.phases


# ---------------------------------------------------------------------------
# the values chip_smoke.py pins, recomputed with the JAX package
# ---------------------------------------------------------------------------


def reference_pins() -> dict:
    """The reference's values for chip_smoke.py's timeline and cosim
    phases: ``benchmarks/timeline.py``'s folded Fig. 3 grid (R = 24,
    elastic membership), ``benchmarks/training_time_saving.py``'s
    8-round timeline and analytic BS time, the op point of
    ``benchmarks/async_timeline.py`` under defer/drop/partial at 4 s and
    async with a buffer of 6, and the co-simulation's network timing of
    its ``accuracy_part`` (4 rounds), the faulty modes' arrivals, failed
    and lost clients a round included."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.timeline import _clients as bench_clients
    from benchmarks.timeline import elastic_schedule, fig3_cases
    from repro.core.round_model import bs_round_time

    cs = _load_chip_smoke()
    cfg = J.PONConfig(n_onus=cs.N_ONUS)
    fig3 = J.simulate(J.SweepSpec(
        cases=tuple(fig3_cases()), pon=cfg,
        schedule=elastic_schedule(cs.FIG3_ROUNDS), mode="folded"))
    pins = {"FIG3_SYNC": {
        f"{c.policy}_load{c.load}": tuple(float(s) for s in r.sync_times)
        for c, r in zip(fig3_cases(), fig3)}}

    clients = bench_clients(cs.N_ONUS)
    wl = J.FLRoundWorkload(clients=clients, model_bits=cs.M_BITS)
    cases = [J.SweepCase(workload=wl, load=0.8, policy=p, seed=s)
             for p in ("fcfs", "bs") for s in range(cs.SAVING_SEEDS)]
    tl = J.simulate(J.SweepSpec(
        cases=tuple(cases), pon=cfg,
        schedule=J.TimelineSchedule(n_rounds=cs.SAVING_ROUNDS)))
    pins["SAVING_SYNC"] = {
        f"{c.policy}_seed{c.seed}": tuple(float(s) for s in r.sync_times)
        for c, r in zip(cases, tl)}
    n = cs.SAVING_SEEDS
    fcfs = float(np.mean([r.total_time_s for r in tl[:n]]))
    bs = float(np.mean([r.total_time_s for r in tl[n:]]))
    pins["SAVING_TOTALS"] = {
        "fcfs_total_s": fcfs, "bs_total_s": bs,
        "saving_pct": 100.0 * (1 - bs / fcfs),
        "bs_analytic_s": float(bs_round_time(
            clients, cfg.line_rate_bps * cfg.efficiency).sync_time)}

    op = {}
    for pol in ("fcfs", "bs"):
        case = _op_point_case(J, pol)
        for mode, kw in cs.OP_MODES.items():
            res = J.simulate(J.SweepSpec(
                cases=(case,), pon=cfg,
                schedule=J.TimelineSchedule(n_rounds=cs.OP_ROUNDS, **kw)))
            op[f"{pol}_{mode}"] = tuple(float(s) for s in res[0].sync_times)
    pins["OP_SYNC"] = op

    # the co-simulation's timing: its clients' compute times, every client
    # in every round (selection "all", no failures), the upload size fixed
    rng = np.random.default_rng(cs.COSIM_DATA_SEED + 1)
    t_uds = rng.uniform(1.0, 5.0, size=cs.COSIM_CLIENTS)
    profiles = [ClientProfile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                              m_ud_bits=cs.COSIM_UPLOAD_BITS)
                for i in range(cs.COSIM_CLIENTS)]
    wl = J.FLRoundWorkload(clients=profiles, model_bits=cs.COSIM_MODEL_BITS)
    case = J.SweepCase(workload=wl, load=cs.COSIM_LOAD, policy="bs", seed=0)
    ccfg = J.PONConfig(n_onus=cs.COSIM_ONUS, line_rate_bps=cs.COSIM_RATE)
    R = cs.COSIM_ROUNDS
    scheds = {"sync": J.TimelineSchedule(
        n_rounds=R, membership=np.ones((R, cs.COSIM_CLIENTS), bool),
        m_ud_bits=np.full(R, cs.COSIM_UPLOAD_BITS))}
    for mode, kw in cs.COSIM_MODES.items():
        if mode == "async":
            scheds[mode] = J.TimelineSchedule(n_rounds=R,
                                              buffer_k=kw["async_buffer"])
        elif mode in cs.COSIM_FAULTY:
            # the faulty modes: accuracy_part's fault schedule, and its
            # quorum for faulty_quorum
            scheds[mode] = J.TimelineSchedule(
                n_rounds=R, faults=J.FaultSchedule(**cs.COSIM_FAULTS),
                quorum_frac=cs.COSIM_FAULTY[mode], **kw)
        elif mode != "sync":
            scheds[mode] = J.TimelineSchedule(n_rounds=R, **kw)
    runs = {mode: J.simulate(J.SweepSpec(cases=(case,), pon=ccfg,
                                         schedule=s))[0]
            for mode, s in scheds.items()}
    pins["COSIM_SYNC"] = {mode: tuple(float(s) for s in tl.sync_times)
                          for mode, tl in runs.items()}
    pins["COSIM_FAULT_COUNTS"] = {
        mode: tuple((len(r.arrived), len(r.failed), len(r.lost))
                    for r in runs[mode].rounds)
        for mode in cs.COSIM_FAULTY}
    return pins


def test_chip_smoke_pins_equal_the_reference():
    cs = _load_chip_smoke()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pins = reference_pins()
    for name, want in pins.items():
        assert getattr(cs, name) == want, name
