"""The port's FL × PON co-simulation against ``repro.fl.simulation``.

``FLNetworkCoSim`` of both packages at ``tests/test_timeline.py``'s
co-sim size (4 clients × 16 samples, batch 8, one local epoch; BS at
load 0.5; 8 ONUs at 1 Gb/s), the port's network on ``device="cpu"``.
Data come from ``build_federated_cnn_clients`` (byte-identical in both
packages, ``tests/test_torch_fl.py``); the CNN's weights are the
reference's init carried over with ``cnn_params_from_reference``.

The learning rate is 5e-4, not the reference test's 0.05: at 0.05 (and
down to 0.01) the first client's local SGD on this data diverges (mean
losses past 10 from ln 62 ≈ 4.1), and the 1e-7 differences of float32
convolutions summed in another order grow to 1e-4 of the loss within a
round, past the FL tests' gate; at 5e-4 training contracts and the gate
holds over every round.

Per round: sync times within 1e-9 s, arrivals and staleness exactly,
the mean loss within 1e-5 of itself and the accuracy within 1.5 test
images (the tolerances ``tests/test_torch_fl.py`` uses for a round).
Modes: the timeline and per_round timing backends, defer/drop/partial at
a deadline that cuts an upload mid-transfer, async, quorum and upload
sizes measured from int8 compression.

``test_coupled_learning_matches_reference`` trains where the weights do
move: ``benchmarks/async_timeline.py::accuracy_part``'s local training
(64 samples a client, lr 0.04, batch 16), uncompressed, through partial
rounds (served fractions) and async rounds (stale updates). The global
parameters after 3 rounds agree leaf by leaf within 1e-5 of each leaf's
largest value (``tests/test_torch_fl.py``'s ``CNN_TOL``; the test
prints the largest error, 6e-7 and 4.9e-7 here). A staleness discount
of (1+τ)^-1 in place of (1+τ)^-0.5 fails the async case, served
fractions taken as 1 the partial one, both already at a round's
accuracy. Under int8 compression the two packages part by one
quantisation step wherever a 1e-7 difference crosses a rounding
boundary, which grows past any useful bound within 3 rounds, so these
runs send uncompressed updates.
"""
import jax
import numpy as np
import pytest

from repro import data as jdata
from repro import fl as jfl
from repro.configs import get_config as jconfig
from repro.fl import simulation as jsim
from repro.models import cnn as jcnn
from repro.net import PONConfig as JPON
from repro.net import SweepCase as JCase
from repro.net import SweepSpec as JSpec
from repro_torch import data as tdata
from repro_torch import fl as tfl
from repro_torch import net as tnet
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as tconfig
from repro_torch.models import cnn as tcnn
from repro_torch.models.convert import cnn_params_from_reference
from repro_torch.net import engine as tengine

N_CLIENTS, SAMPLES, ROUNDS = 4, 16, 3
TRAIN = dict(lr=5e-4, batch_size=8, local_epochs=1)
COSIM = dict(policy="bs", total_load=0.5, model_bits=2e6, upload_bits=3e8,
             timing_seeds=1)
DEADLINE = 3.2
SYNC_ABS = 1e-9
LOSS_RTOL = 1e-5
# accuracy_part's local training, for the runs whose weights move
MOVING = dict(lr=0.04, batch_size=16, local_epochs=1)
MOVING_SAMPLES = 64
PARAM_TOL = 1e-5      # of each leaf's largest value (CNN_TOL)


@pytest.fixture(scope="module")
def ref_params():
    jp = jcnn.init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp), jp


def _pair(ref_params, scheme="none", train=TRAIN, samples=SAMPLES,
          **cfg):
    """(reference co-sim, port co-sim, reference test set, port's); the
    config's reference types (faults, jobs) reach the port converted."""
    npp, jp = ref_params
    kw = dict(COSIM, **cfg)
    jcl, jtest = jdata.build_federated_cnn_clients(
        N_CLIENTS, samples, jcnn.loss_fn, jfl.LocalTrainConfig(**train),
        seed=0)
    tcl, ttest = tdata.build_federated_cnn_clients(
        N_CLIENTS, samples, tcnn.loss_fn, tfl.LocalTrainConfig(**train),
        seed=0)
    js = jfl.CPSServer(global_params=jp, clients=jcl,
                       selection=jfl.SelectionConfig(strategy="all"),
                       compression=jfl.CompressorConfig(scheme=scheme),
                       seed=0)
    ts = tfl.CPSServer(
        global_params=cnn_params_from_reference(npp, device="cpu"),
        clients=tcl, selection=tfl.SelectionConfig(strategy="all"),
        compression=tfl.CompressorConfig(scheme=scheme), seed=0)
    pon = JPON(n_onus=8, line_rate_bps=1e9)
    ref = jsim.FLNetworkCoSim(js, jsim.CoSimConfig(pon=pon, **kw))
    port = tfl.FLNetworkCoSim(
        ts, tfl.CoSimConfig(pon=tnet.from_reference(pon),
                            **{k: tnet.from_reference(v)
                               for k, v in kw.items()}),
        device="cpu")
    return ref, port, jtest, ttest


def _assert_same(want, got, n_test):
    assert len(want.rounds) == len(got.rounds)
    for a, b in zip(want.rounds, got.rounds):
        assert abs(b["sync_time_s"] - a["sync_time_s"]) <= SYNC_ABS
        for key in ("round", "n_arrived", "staleness", "quorum_met"):
            assert b.get(key) == a.get(key), key
        if np.isnan(a["mean_loss"]):
            assert np.isnan(b["mean_loss"])
        else:
            assert abs(b["mean_loss"] - a["mean_loss"]) <= \
                LOSS_RTOL * abs(a["mean_loss"])
        assert abs(b["eval_metric"] - a["eval_metric"]) <= 1.5 / n_test
    assert abs(got.total_time_s - want.total_time_s) <= \
        SYNC_ABS * len(want.rounds)
    assert abs(got.sync_time_s - want.sync_time_s) <= SYNC_ABS


RUNS = {
    "timeline": (dict(timing_seeds=2), dict()),
    "per_round": (dict(timing_seeds=2), dict(backend="per_round")),
    "defer": ({}, dict(deadline_s=DEADLINE, deadline_policy="defer")),
    "drop": ({}, dict(deadline_s=DEADLINE, deadline_policy="drop")),
    "partial": ({}, dict(deadline_s=DEADLINE, deadline_policy="partial")),
    "async": ({}, dict(mode="async", async_buffer=2)),
    # 1 s, doubled twice, leaves two of four uploads short of 3 needed
    "quorum": (dict(quorum_frac=0.75),
               dict(deadline_s=1.0, deadline_policy="drop")),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_cosim_matches_reference(ref_params, name):
    cfg, run = RUNS[name]
    ref, port, jtest, ttest = _pair(ref_params, **cfg)
    want = ref.run(ROUNDS, eval_fn=lambda p: jcnn.accuracy(p, jtest), **run)
    got = port.run(ROUNDS, eval_fn=lambda p: tcnn.accuracy(p, ttest), **run)
    _assert_same(want, got, len(jtest["labels"]))
    if name == "partial":
        # the deadline cuts an upload mid-transfer
        net = tnet.simulate(tnet.SweepSpec(
            cases=(tnet.SweepCase(workload=tnet.FLRoundWorkload(
                clients=port._client_profiles()[0], model_bits=2e6),
                load=0.5, policy="bs"),),
            pon=port.cfg.pon, schedule=tnet.TimelineSchedule(
                n_rounds=1, deadline_s=DEADLINE,
                deadline_policy="partial")), device="cpu")[0]
        fracs = list(net.rounds[0].partial.values())
        assert any(0.0 < f < 1.0 for f in fracs), fracs
    if name == "quorum":
        assert any(r["quorum_met"] is False for r in got.rounds)


@pytest.mark.parametrize("name", ["partial", "async"])
def test_coupled_learning_matches_reference(ref_params, name):
    """The coupled path's FedBuff merge (staleness discount, served
    fraction) against the reference's where training moves the weights:
    every round as above, then the global parameters leaf by leaf."""
    ref, port, jtest, ttest = _pair(ref_params, train=MOVING,
                                    samples=MOVING_SAMPLES)
    run = RUNS[name][1]
    want = ref.run(ROUNDS, eval_fn=lambda p: jcnn.accuracy(p, jtest), **run)
    got = port.run(ROUNDS, eval_fn=lambda p: tcnn.accuracy(p, ttest), **run)
    _assert_same(want, got, len(jtest["labels"]))
    if name == "async":
        assert any(s for r in got.rounds for s in r["staleness"].values())
    else:
        assert got.rounds[0]["n_arrived"] < N_CLIENTS
    wants = jax.tree.leaves(ref.server.global_params)
    gots = tree_leaves(port.server.global_params)
    assert len(gots) == len(wants)
    worst = max(float(np.abs(g.numpy() - np.asarray(w)).max()
                      / np.abs(np.asarray(w)).max())
                for g, w in zip(gots, wants))
    print(f"{name}: largest parameter error {worst:.2g} of its leaf's "
          f"largest value")
    assert worst <= PARAM_TOL, worst


def test_spec_backend_reaches_the_engine(ref_params, monkeypatch):
    """A ``spec`` naming ``backend="jit"`` runs every network simulation
    of the co-sim through the fused phase (its plain version on the CPU),
    with the reference's timings (a tenth of the uploads, to keep the
    plain phase short)."""
    calls = []
    run_phase = tengine.run_phase_device

    def counted(*args, **kwargs):
        calls.append(str(kwargs["device"]))
        return run_phase(*args, **kwargs)

    monkeypatch.setattr(tengine, "run_phase_device", counted)
    ref, port, _, _ = _pair(ref_params, upload_bits=3e7)
    pon = JPON(n_onus=8, line_rate_bps=1e9)
    jspec = JSpec(cases=(JCase(workload=None, load=0.5, policy="bs"),),
                  pon=pon)
    tspec = tnet.SweepSpec(cases=(tnet.SweepCase(
        workload=None, load=0.5, policy="bs"),),
        pon=tnet.from_reference(pon), backend="jit")
    for run in (dict(), dict(deadline_s=0.5, deadline_policy="partial")):
        want = ref.run(2, spec=jspec, **run)
        n = len(calls)
        got = port.run(2, spec=tspec, **run)
        assert len(calls) > n and set(calls) == {"cpu"}
        for a, b in zip(want.rounds, got.rounds):
            assert abs(b["sync_time_s"] - a["sync_time_s"]) <= SYNC_ABS
            assert b["n_arrived"] == a["n_arrived"]


def test_compression_sized_uploads_and_spec(ref_params):
    """Upload sizes measured from int8 compression (the timeline takes
    them as per-round ``m_ud_bits``), and a template ``spec``
    re-pointing the network side."""
    ref, port, jtest, ttest = _pair(ref_params, scheme="int8")
    pon = JPON(n_onus=8, line_rate_bps=2e9)
    jspec = JSpec(cases=(JCase(workload=None, load=0.3, policy="fcfs"),),
                  pon=pon)
    tspec = tnet.SweepSpec(cases=(tnet.SweepCase(
        workload=None, load=0.3, policy="fcfs"),),
        pon=tnet.from_reference(pon))
    want = ref.run(2, update_bits_from_compression=True, spec=jspec)
    got = port.run(2, update_bits_from_compression=True, spec=tspec)
    for a, b in zip(want.rounds, got.rounds):
        assert abs(b["sync_time_s"] - a["sync_time_s"]) <= SYNC_ABS
        assert b["n_arrived"] == a["n_arrived"]
    assert port.cfg.policy == "fcfs" and port.cfg.pon.line_rate_bps == 2e9
    assert [h.update_bits for h in port.server.history] == [
        h.update_bits for h in ref.server.history]


def test_time_to_metric():
    rounds = [{"sync_time_s": 2.0, "eval_metric": 0.3},
              {"sync_time_s": 3.0, "eval_metric": None},
              {"sync_time_s": 1.5, "eval_metric": 0.7}]
    got = tfl.CoSimResult(rounds=rounds, total_time_s=6.5, sync_time_s=1.5,
                          policy="bs", load=0.5)
    want = jsim.CoSimResult(rounds=rounds, total_time_s=6.5,
                            sync_time_s=1.5, policy="bs", load=0.5)
    for target in (0.2, 0.5, 0.7, 0.9):
        assert got.time_to_metric(target) == want.time_to_metric(target)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_from_fed_model(arch, compress):
    for smoke in (True, False):
        want = jsim.CoSimConfig.from_fed_model(jconfig(arch, smoke=smoke),
                                               compress)
        got = tfl.CoSimConfig.from_fed_model(tconfig(arch, smoke=smoke),
                                             compress)
        assert (got.model_bits, got.upload_bits) == (want.model_bits,
                                                     want.upload_bits)
    with pytest.raises(ValueError, match="compression scheme"):
        tfl.CoSimConfig.from_fed_model(tconfig(arch, smoke=True), "zip")


def _value_errors(sim, spec_cls, case_cls, pon):
    two = spec_cls(cases=(case_cls(workload=None, load=0.3, policy="bs"),
                          case_cls(workload=None, load=0.5, policy="bs")),
                   pon=pon)
    return [
        ("unknown backend", lambda: sim.run(1, backend="magic")),
        ("unknown mode", lambda: sim.run(1, mode="eventually")),
        ("timing_seeds", lambda: sim.run(1, mode="async", async_buffer=1)),
        ("decoupled", lambda: sim.run(1, deadline_s=1.0,
                                      update_bits_from_compression=True)),
        ("exactly one", lambda: sim.run(1, spec=two)),
    ]


@pytest.mark.parametrize("idx", range(5))
def test_run_value_errors(ref_params, idx):
    ref, port, _, _ = _pair(ref_params, timing_seeds=3)
    for sim, spec_cls, case_cls, pon in (
            (ref, JSpec, JCase, ref.cfg.pon),
            (port, tnet.SweepSpec, tnet.SweepCase, port.cfg.pon)):
        frag, call = _value_errors(sim, spec_cls, case_cls, pon)[idx]
        with pytest.raises(ValueError, match=frag):
            call()


def test_quorum_needs_the_coupled_path(ref_params):
    ref, port, _, _ = _pair(ref_params, quorum_frac=0.5)
    for sim in (ref, port):
        with pytest.raises(ValueError, match="coupled"):
            sim.run(1)


def test_not_ported_parts_raise(ref_params):
    # faults, retries, quorum, tenant jobs and the collector (obs/) are
    # ported: the config takes them. What stays refused, as in the
    # reference, is a collector on a spec's backend="jit"; the same run
    # on the per-cycle loop takes it
    from repro_torch.obs import Collector

    tfl.CoSimConfig(faults=tnet.FaultSchedule(dropout_rate=0.1),
                    retry=tnet.RetryPolicy(), jobs=(), job_clients=(),
                    fairness="weighted", collector=Collector(device="cpu"))
    _, port, _, _ = _pair(ref_params)
    case = tnet.SweepCase(workload=tnet.FLRoundWorkload(clients=[],
                                                        model_bits=1.0),
                          load=0.5, policy="bs")
    for backend in ("jit", None):
        col = Collector(device="cpu")
        spec = tnet.SweepSpec(cases=(case,), pon=port.cfg.pon,
                              backend=backend)
        if backend == "jit":
            with pytest.raises(ValueError,
                               match="does not support collector"):
                port.run(1, collector=col, spec=spec)
        else:
            port.run(1, collector=col, spec=spec)
            assert [e["kind"] for e in col.events] == ["fl_round"]
            assert col.phases
