"""The port's fused device phase (``backend="jit"``) against the JAX
package's, on the CPU.

``repro.kernels.ponsim`` needs ``jax.experimental.enable_x64``, which
jax 0.9.0 no longer has; a module-scoped fixture sets a shim for it
(``jax.enable_x64(True)`` as a context) before importing the JAX phase
program, and nothing else. Then:

* every phase that the JAX engine's ``backend="jit"`` runs in each
  scenario of ``tests/test_ponsim_jit.py`` (fcfs at three loads with
  several clients an ONU, bs at two, deadline and outage for both
  policies, 3-PON CPS with and without masks, a mixed batch) is run
  again on the same inputs by the port's ``run_phase_device`` with the
  counting pour (the JAX program's CPU pour): ``done_t`` and ``rem`` at
  rtol 1e-6 and the same exact outcome;
* ``simulate(..., backend="jit")`` equals the JAX numpy engine on the
  same scenarios at rtol 1e-6, and pins the Fig. 2b operating point;
* ``sample_window_ref`` is bit-identical to the JAX function, to the
  port's ``sample_arrival_bits`` and to the pinned stream fingerprint;
* K2's pour (``use_k2=True``, the card's) agrees with the counting pour
  where both are exact;
* a phase that loses exactness returns ``None`` (the JAX program's own
  upload phases with an outage, :data:`INEXACT`), and the engine re-runs
  it on the per-cycle loop and counts the re-run.
"""
import hashlib
import pathlib
import re
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.net as J
from repro.core.slicing import ClientProfile
from repro.kernels.traffic.ops import make_stream_key as j_stream_key
from repro.net.engine import PACKET_BITS
from repro.net.traffic import burst_lambda
import repro_torch.net as T
from repro_torch.kernels.ponsim import kernel as phase_kernel
from repro_torch.kernels.ponsim import ops as phase_ops
from repro_torch.kernels.ponsim import ref as phase_ref
from repro_torch.kernels.traffic import ops as traffic_ops
from repro_torch.kernels.traffic.ref import poisson_thresholds
from repro_torch.net import engine as t_engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = J.PONConfig(n_onus=4, line_rate_bps=1e9)
RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_phase():
    """The JAX package's phase module, imported behind the x64 shim (set
    for this module's tests only)."""
    added = not hasattr(jax.experimental, "enable_x64")
    if added:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        from repro.kernels.ponsim import ops

        yield ops
    finally:
        if added:
            del jax.experimental.enable_x64


def _workload(ids, seed=1):
    rng = np.random.default_rng(seed)
    clients = [ClientProfile(client_id=int(i),
                             t_ud=float(rng.uniform(0.05, 0.5)), t_dl=0.0,
                             m_ud_bits=float(rng.uniform(1e5, 2e6)))
               for i in ids]
    return J.FLRoundWorkload(clients=clients, model_bits=1.5e6)


WL = _workload([0, 1, 2, 3])
WL_MULTI = _workload([0, 1, 2, 3, 5, 9])     # several clients an ONU
CPS_TOPO = J.MultiPonTopology(n_pons=3, cps_rate_bps=1.5e9)
CPS_OUTAGE = np.array([[0.1, 0.4], [0.0, 0.0], [0.2, 0.5]])


def _scenario(name):
    """``(cases, kwargs)`` of one scenario of tests/test_ponsim_jit.py."""
    if name.startswith(("fcfs_", "bs_")):
        policy, load = name.split("_")
        return [J.SweepCase(workload=WL_MULTI if policy == "fcfs" else WL,
                            load=float(load), policy=policy, seed=7)], {}
    if name.startswith("deadline_outage_"):
        policy = name.rsplit("_", 1)[1]
        return ([J.SweepCase(workload=WL_MULTI if policy == "fcfs" else WL,
                             load=0.8, policy=policy, seed=3)],
                dict(ul_deadline_s=[1.5], ul_outage_s=[(0.2, 0.6)]))
    if name.startswith("cps_"):
        policy = name.split("_")[1]
        ids = [0, 3, 5, 8, 11] if policy == "fcfs" else [0, 2, 5, 7, 10]
        cases = [J.SweepCase(workload=_workload(ids, seed=2), load=0.3,
                             policy=policy, seed=5, topology=CPS_TOPO)]
        kw = ({"ul_deadline_s": [1.2], "ul_outage_s": [CPS_OUTAGE]}
              if name.endswith("masks") else {})
        return cases, kw
    assert name == "mixed"
    cases = [J.SweepCase(workload=WL_MULTI, load=load, policy="fcfs",
                         seed=s) for load in (0.3, 0.7) for s in (1, 2)]
    cases.append(J.SweepCase(workload=WL, load=0.5, policy="bs", seed=4))
    return cases, {}


def _wide_scenario(name):
    """``(cfg, cases, kwargs)`` of a narrow multi-PON sweep with a CPS
    that binds and short phases, one fcfs case and one bs case: 33 PONs
    of 4 ONUs, or 100 PONs of 8 ONUs (past the 32 PONs a case the phase
    kernel once took)."""
    if name == "pons33":
        cfg, topo = CFG, J.MultiPonTopology(n_pons=33, cps_rate_bps=10.5e9)
        ids = [0, 5, 9, 30, 61, 77, 100, 131]
    else:
        assert name == "pons100"
        cfg = J.PONConfig(n_onus=8, line_rate_bps=1e9)
        topo = J.MultiPonTopology(n_pons=100, cps_rate_bps=31e9)
        ids = [0, 9, 130, 257, 400, 555, 642, 799]
    cases = [J.SweepCase(workload=_workload(ids, seed=4), load=0.3,
                         policy=policy, seed=6, topology=topo)
             for policy in ("fcfs", "bs")]
    return cfg, cases, {}


def _any_scenario(name):
    if name in WIDE:
        return _wide_scenario(name)
    return (CFG, *_scenario(name))


WIDE = ["pons33", "pons100"]
SCENARIOS = ["fcfs_0.2", "fcfs_0.6", "fcfs_0.9", "bs_0.2", "bs_0.9",
             "deadline_outage_fcfs", "deadline_outage_bs", "cps_fcfs",
             "cps_bs", "cps_fcfs_masks", "cps_bs_masks", "mixed"]


_RECORDED = {}


def _jax_phases(jax_phase, name):
    """Every ``run_phase_device`` call of the JAX engine's jit sweep of
    scenario ``name``: ``(args, kwargs, result)`` (recorded once)."""
    if name in _RECORDED:
        return _RECORDED[name]
    cfg, cases, kw = _any_scenario(name)
    calls = _RECORDED[name] = []
    run = jax_phase.run_phase_device

    def record(*args, **kwargs):
        out = run(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    jax_phase.run_phase_device = record
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            J.simulate_round_sweep(cfg, cases, backend="jit", **kw)
    finally:
        jax_phase.run_phase_device = run
    assert calls
    return calls


def _port_kwargs(kwargs):
    kw = dict(kwargs)
    kw.pop("use_pallas", None)
    return kw


def _assert_phase_close(want, got):
    assert (want is None) == (got is None)
    if want is not None:
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, a, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("name", SCENARIOS)
def test_phase_matches_jax_program(jax_phase, name):
    for args, kwargs, want in _jax_phases(jax_phase, name):
        got = phase_ops.run_phase_device(*args, **_port_kwargs(kwargs),
                                         use_k2=False, device="cpu")
        _assert_phase_close(want, got)


def _assert_round_parity(a, b):
    assert b.sync_time == pytest.approx(a.sync_time, rel=RTOL)
    for attr in ("dl_done", "ready", "ul_done"):
        da, db = getattr(a, attr), getattr(b, attr)
        assert set(da) == set(db)
        for cid, v in da.items():
            assert np.isclose(db[cid], v, rtol=RTOL, equal_nan=True), attr
    ra, rb = a.ul_remaining or {}, b.ul_remaining or {}
    assert set(ra) == set(rb)
    for cid, bits in ra.items():
        assert rb[cid] == pytest.approx(bits, rel=RTOL)


def _port_jit(cases, cfg=CFG, **kw):
    spec = T.SweepSpec(cases=tuple(T.from_reference(cases)),
                       pon=T.from_reference(cfg), backend="jit", **kw)
    return T.simulate(spec, device="cpu")


# the upload phases whose ring walk loses exactness (an outage backs the
# background up past the ring), in the JAX program as in the port
INEXACT = {"deadline_outage_fcfs": 1, "cps_fcfs_masks": 1}


@pytest.mark.parametrize("name", SCENARIOS)
def test_jit_sweep_matches_numpy_engine(name):
    """Inexact phases come back ``None`` and are re-run, counted, on the
    per-cycle loop; the sweep equals the numpy engine either way."""
    cases, kw = _scenario(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.simulate_round_sweep(CFG, cases, **kw)
    before = t_engine.phase_fallbacks
    got = _port_jit(cases, **kw)
    assert t_engine.phase_fallbacks - before == INEXACT.get(name, 0)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _assert_round_parity(a, b)


@pytest.mark.parametrize("name", sorted(INEXACT))
def test_inexact_phase_returns_none(jax_phase, name):
    outcomes = [out is None for _, _, out in _jax_phases(jax_phase, name)]
    assert outcomes == [False, True]


def test_fig2b_operating_point_pin_jit():
    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, 128)
    clients = [T.from_reference(ClientProfile(
        client_id=i, t_ud=float(t_uds[i]), t_dl=0.0, m_ud_bits=26.416e6))
        for i in range(12)]
    case = T.SweepCase(workload=T.FLRoundWorkload(clients=clients,
                                                  model_bits=26.416e6),
                       load=0.8, policy="fcfs", seed=1)
    spec = T.SweepSpec(cases=(case,), pon=T.PONConfig(n_onus=128),
                       backend="jit")
    res = T.simulate(spec, device="cpu")[0]
    assert res.sync_time == pytest.approx(5.058100000000024, abs=1e-9)


def _stream_params():
    keys = np.stack([j_stream_key(7, 1, r, p)
                     for r in (0, 1) for p in (0, 2)])
    lam = burst_lambda(0.3 * 1e9 / 16, 1e-3, PACKET_BITS, 16.0)
    return keys, np.full((keys.shape[0],), lam, np.float32)


def _port_windows(keys, lams, n_onus, n_win):
    n_draws = traffic_ops._tail_bound(float(lams.max()) * 64)
    thr = torch.as_tensor(poisson_thresholds(
        np.asarray(lams, np.float64) * 64, n_draws))
    kt = torch.as_tensor(keys.astype(np.int64))
    return [phase_ref.sample_window_ref(
        kt, thr, w, n_onus=n_onus, n_draws=n_draws, inv_burst=1.0 / 16.0,
        packet_bits=PACKET_BITS) for w in range(n_win)], n_draws


def test_sample_window_matches_jax_and_the_sampler(jax_phase):
    from repro.kernels.ponsim import ref as jax_ref
    from repro.kernels.traffic.ops import _poisson_thresholds

    keys, lams = _stream_params()
    wins, n_draws = _port_windows(keys, lams, 16, 4)
    thr = _poisson_thresholds(np.asarray(lams, np.float64) * 64, n_draws)
    for w, got in enumerate(wins):
        assert got.dtype == torch.float32 and got.shape == (4, 64, 16)
        want = np.asarray(jax_ref.sample_window_ref(
            keys, thr, w, n_onus=16, n_draws=n_draws,
            inv_burst=np.float32(1.0 / 16.0),
            packet_bits=np.float32(PACKET_BITS)))
        assert np.array_equal(got.numpy(), want)
    stream = traffic_ops.sample_arrival_bits(
        keys, 0, 4 * 64, 16, lams, 1.0 / 16.0, PACKET_BITS, device="cpu")
    assert torch.equal(torch.cat(wins, dim=1).to(torch.float64), stream)


def test_sample_window_pinned_fingerprint():
    keys, lams = _stream_params()
    wins, _ = _port_windows(keys, lams, 16, 4)
    bits = torch.cat(wins, dim=1).to(torch.float64).numpy()
    digest = hashlib.sha256(np.ascontiguousarray(bits).tobytes()).hexdigest()
    assert digest == ("7df0b5fe7c7a5a214089bec8540252e0"
                      "8add05f7bce9f2c0ba49c770a693f3fe")
    assert bits.sum() == 327768000.0


@pytest.mark.parametrize("name", ["fcfs_0.9", "cps_fcfs", "mixed"])
def test_k2_pour_matches_counting_pour(jax_phase, name):
    for args, kwargs, _ in _jax_phases(jax_phase, name):
        kwargs = _port_kwargs(kwargs)
        counting = phase_ops.run_phase_device(*args, **kwargs, use_k2=False,
                                              device="cpu")
        k2 = phase_ops.run_phase_device(*args, **kwargs, use_k2=True,
                                        device="cpu")
        assert counting is not None and k2 is not None
        _assert_phase_close(counting, k2)


@pytest.mark.parametrize("G,P,seed", [(5, 2, 0), (7, 3, 1), (4, 8, 2),
                                      (3, 1, 3), (6, 32, 4)])
def test_cps_split_matches_jax_ref(jax_phase, G, P, seed):
    """The CPS split at ``(G, P)``: the port's ``cps_waterfill_ref`` and
    the phase's sequential-total ``_cps_split`` against the JAX
    ``cps_waterfill_ref`` (float64)."""
    from repro.kernels.ponsim import ref as jax_ref

    rng = np.random.default_rng(seed)
    want_in = rng.uniform(0, 2e6, (G, P))
    want_in[rng.random((G, P)) < 0.2] = 0.0
    want_in[0] = want_in[0, :1]           # ties at the water level
    cap = float(want_in.sum(axis=1).mean())
    with jax.enable_x64(True):
        want = np.asarray(jax_ref.cps_waterfill_ref(
            jax.numpy.asarray(want_in), cap))
    x = torch.as_tensor(want_in)
    for got in (phase_ref.cps_waterfill_ref(x, cap),
                phase_ref._cps_split(x, cap)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_row_sum_order():
    """Chunks of ceil(n / 32) added left to right, then the partials."""
    rng = np.random.default_rng(3)
    for n in (1, 5, 32, 33, 128, 1000):
        x = rng.uniform(0, 1e7, (3, n)) * rng.uniform(0, 1, (3, n)) ** 9
        c = -(-n // 32)
        want = []
        for row in x:
            total = 0.0
            for lane in range(32):
                acc = 0.0
                for v in row[lane * c:(lane + 1) * c]:
                    acc += v
                total += acc
            want.append(total)
        got = phase_ref.row_sum(torch.as_tensor(x))
        assert got.tolist() == want


def test_region_names_match_the_enum():
    """The library names each state region (``repro_phase_region_name``,
    which ``kernel.phase_plan`` decodes the plan's mask by) in the order
    of its ``enum Region``, and the wrapper keeps no list of its own."""
    src = (ROOT / "src/repro_torch/csrc/ponsim_phase.cu").read_text()
    enum = re.search(r"enum Region \{(.*?)\};", src, re.S).group(1)
    regions = [r.strip() for r in enum.split(",")]
    assert regions[-1] == "kRegions"
    names = re.search(r"kRegionName\[\] = \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r'"([^"]+)"', names)
    assert len(names) == len(regions) - 1 == len(set(names))
    assert names[:3] == ["rows", "background", "sort"]
    assert not hasattr(phase_kernel, "_REGIONS")


def test_kernel_arguments_match_the_source():
    """The wrapper's ctypes struct lists ``PhaseArgs``'s fields in order:
    sizes and flags, the scalars, the inputs, the outputs (one block,
    copied back at once) and the global scratch; the library defines no
    limit on PONs a case or clients an ONU."""
    src = (ROOT / "src/repro_torch/csrc/ponsim_phase.cu").read_text()
    for gone in ("kMaxP", "kMaxClients", "repro_phase_max_pons",
                 "repro_phase_max_clients"):
        assert gone not in src
    assert not hasattr(phase_kernel, "phase_limits")
    fields = [f[0] for f in phase_kernel._PhaseArgs._fields_]
    assert fields[-1] == "scratch"
    assert fields[-7:-1] == [n for n, _, _ in phase_kernel._OUTPUTS]
    body = re.search(r"struct PhaseArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        if decl.startswith(("long long", "double ")):
            names += [n.strip() for n in decl.split(None, 2 if decl.startswith(
                "long long") else 1)[-1].split(",")]
        else:
            names.append(decl.split()[-1].lstrip("*"))
    assert names == [f[0] for f in phase_kernel._PhaseArgs._fields_]


def test_card_pours_with_k2_only():
    """The card refuses the counting pour, and only that: a case of 100
    PONs with 40 clients an ONU is refused for its pour alone."""
    spec = phase_ref.PhaseSpec(
        mode="fcfs", R=100, U=40, N=1, S=1, P=100, k_max=1, n_draws=8,
        max_slots=40, has_bg=True, has_cps=False, has_deadline=False,
        has_outage=False, fill_unfinished=True, fast=False, single=False,
        identity=False, use_k2=False, cyc=1e-3, prop=1e-4, tmax=1.0,
        cps_cap=0.0, packet_bits=12000.0, inv_burst=1 / 16)
    with pytest.raises(NotImplementedError, match="counting pour"):
        phase_kernel.run_phase_cuda(spec, {})


def test_spec_backends():
    wl = T.FLRoundWorkload(clients=T.from_reference(WL.clients),
                           model_bits=1e6)
    case = T.SweepCase(workload=wl, load=0.3, policy="fcfs")
    T.SweepSpec(cases=(case,), backend="jit").validate()
    with pytest.raises(ValueError, match="backend"):
        T.SweepSpec(cases=(case,), backend="pallas").validate()


@pytest.mark.parametrize("name", WIDE)
def test_wide_phase_matches_jax_program(jax_phase, name):
    """Every phase of a 33-PON and a 100-PON sweep (CPS binding, fcfs
    and bs): ``run_phase_ref`` (the counting pour) against the JAX
    program on the same inputs."""
    calls = _jax_phases(jax_phase, name)
    assert {args[0].n_onus for args, _, _ in calls} == {
        _wide_scenario(name)[0].n_onus}
    assert {kw["n_pons"] for _, kw, _ in calls} == {int(name[4:])}
    for args, kwargs, want in calls:
        got = phase_ops.run_phase_device(*args, **_port_kwargs(kwargs),
                                         use_k2=False, device="cpu")
        _assert_phase_close(want, got)


def test_wide_jit_sweep_matches_numpy_engine():
    """The 100-PON sweep through ``backend="jit"`` equals the JAX numpy
    engine: every sync within 1e-9 s, the rest at rtol 1e-6."""
    cfg, cases, kw = _wide_scenario("pons100")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = J.simulate_round_sweep(cfg, cases, **kw)
    got = _port_jit(cases, cfg, **kw)
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert abs(b.sync_time - a.sync_time) <= 1e-9
        _assert_round_parity(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_table_adds_like_scatter_add(seed):
    """Adding each ONU's slot grants in the order of the slots-by-ONU
    table (``ops._slot_tables``, the phase kernel's order) equals
    ``scatter_add_`` into zeros bit for bit, on grants of spread
    magnitudes with ONUs repeated many times a row; the table leaves out
    the invalid slots, whose grants are zeros of either sign."""
    rng = np.random.default_rng(seed)
    R, S, N = 5, 64, 9
    sonu = rng.integers(0, N, (R, S))
    sonu[0] = 3                                   # one ONU takes every slot
    valid = rng.random((R, S)) < 0.8
    valid[1, 40:] = False                         # a row's padding
    sonu[1, 40:] = 0
    g = rng.uniform(0, 1, (R, S)) * 10.0 ** rng.integers(-3, 17, (R, S))
    g[rng.random((R, S)) < 0.2] = 0.0
    g[~valid] = rng.choice([0.0, -0.0], size=int((~valid).sum()))
    want = torch.zeros((R, N), dtype=torch.float64).scatter_add_(
        1, torch.as_tensor(sonu), torch.as_tensor(g))
    tab = phase_ops._slot_tables(sonu, valid, N)
    sorder, ostart = tab["sorder"], tab["ostart"]
    assert sorder.dtype == ostart.dtype == np.int32
    got = np.zeros((R, N))
    for r in range(R):
        for n in range(N):
            grp = sorder[r, ostart[r, n]:ostart[r, n + 1]]
            assert (sonu[r, grp] == n).all() and valid[r, grp].all()
            assert (np.diff(grp) > 0).all()
            acc = 0.0
            for s in grp:
                acc += float(g[r, s])
            got[r, n] = acc
        assert ostart[r, -1] == valid[r].sum()
        assert sorted(sorder[r]) == list(range(S))
    assert np.array_equal(got.view(np.uint64),
                          want.numpy().view(np.uint64))


def _record_port_phases(cases, **kw):
    """Every ``run_phase_device`` call of the port's jit sweep on the
    CPU: ``(args, kwargs, result)``."""
    calls = []
    run = t_engine.run_phase_device

    def record(*args, **kwargs):
        out = run(*args, **kwargs)
        calls.append((args, {k: v for k, v in kwargs.items()
                             if k != "device"}, out))
        return out

    t_engine.run_phase_device = record
    try:
        _port_jit(cases, **kw)
    finally:
        t_engine.run_phase_device = run
    return calls


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_packed_inputs_equal_the_tensors_one_by_one():
    """``phase_inputs``'s tensors are views of one buffer (one copy to a
    card); each equals, bit for bit and in dtype and shape, the tensor
    built from its host table on its own (as ``phase_inputs`` built them
    before), on phases of every kind ``chip_smoke.PHASE_COVER`` names."""
    from repro_torch.kernels.traffic.ops import _table

    cover = _chip_smoke().PHASE_COVER
    fast = [J.SweepCase(workload=WL, load=0.6, policy="fcfs", seed=7)]
    covered = set()
    for cases, kw in (_scenario("deadline_outage_fcfs"),
                      _scenario("cps_bs_masks"), (fast, {})):
        for args, kwargs, out in _record_port_phases(cases, **kw):
            spec, arrays = phase_ops.phase_tables(*args, **kwargs)
            packed = phase_ops.phase_inputs(*args, **kwargs,
                                            device="cpu")[1]
            assert set(packed) == set(arrays)
            base = packed["rem0"].untyped_storage().data_ptr()
            for name, val in arrays.items():
                one = torch.as_tensor(np.ascontiguousarray(val))
                view = packed[name]
                assert view.untyped_storage().data_ptr() == base
                assert view.dtype == one.dtype and view.shape == one.shape
                assert np.array_equal(view.numpy().view(np.uint8),
                                      one.numpy().view(np.uint8)), name
            if spec.has_bg:
                for view, old in zip((packed["bp_start"], packed["bp_len"]),
                                     _table(spec.inv_burst, "cpu")):
                    assert view.dtype == old.dtype and torch.equal(view, old)
            covered |= {c for c, hit in cover.items()
                        if hit(spec, out is not None)}
    assert covered == set(cover)


def test_fast_tables_cut_clock_equals_the_whole_clock():
    """The scalar-S tables built on the clock only as far as the latest
    finite ready time equal those built on all ``k_max`` cycles, with
    ready times past the phase's end, infinite and on a cycle's edge."""
    from types import SimpleNamespace

    rng = np.random.default_rng(5)
    R, U, cyc, k_max = 4, 6, 1e-3, 900
    ready = rng.uniform(0.0, 0.5, (R, U))
    ready[0, 0] = np.inf
    ready[1, 1] = 2.0                      # past k_max cycles
    ready[2, 2] = 0.25                     # k_max-free of the clock's edges
    t_seq = np.zeros(k_max)
    np.cumsum(np.full(k_max - 1, cyc), out=t_seq[1:])
    ready[3] = t_seq[[3, 10, 11, 400, 401, 402]] + cyc
    lay = SimpleNamespace(part=rng.random((R, U)) < 0.9,
                          onu=np.arange(U, dtype=np.int64))
    rem = rng.uniform(0, 1e6, (R, U))
    got = phase_ops._fast_tables(cyc, k_max, lay, rem, ready)
    # the whole clock, as the JAX package builds it
    tc = t_seq + cyc
    kp = np.searchsorted(tc, ready.ravel()).reshape(R, U)
    pushes = lay.part & (rem > 0.0) & (kp < k_max)
    pt = np.where(pushes, np.maximum(ready, t_seq[np.minimum(kp, k_max - 1)]),
                  np.inf)
    rk = np.lexsort((np.broadcast_to(lay.onu, (R, U)), pt), axis=1)
    assert np.array_equal(got["rank_col"], rk)
    assert np.array_equal(got["pushes"], pushes)
    rows = np.arange(R)[:, None]
    kp_rank = np.where(pushes[rows, rk], kp[rows, rk], k_max)
    assert np.array_equal(got["kp_rank"], kp_rank)
