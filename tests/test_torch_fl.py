"""The port's FL half (Fig. 2a) against the JAX package's, on the CPU.

Data, deltas and noise are made with numpy from a seed and handed to
both packages; the CNN's parameters are the reference's own init, carried
over with ``cnn_params_from_reference``.

* Data: ``femnist_like``, ``lm_tokens``, ``partition_tokens`` and
  ``build_federated_cnn_clients`` byte for byte.
* Selection and the deadline baseline: the same clients, exactly, and
  the numpy generator left in the same state.
* The LEAF CNN at full width (6,603,710 parameters): logits, loss and
  every gradient within 1e-5 of the reference's largest value (float32
  convolutions and products summed in another order: measured ~2e-6).
* ``Client.train``: the same permutations, parameters within 1e-5
  (absolute, over 8 SGD steps) and the mean loss within 1e-5 of itself
  (relative; the same for every mean loss below).
* Compression: ``compress_delta`` bit for bit for every scheme with and
  without error feedback, over two calls that carry the residual, and
  the wire bits exactly; ``compressed_update_bits`` exactly.
* Aggregation: FedAvg, FedAdam, FedBuff, the quorum gate and the buffer
  within 1e-6.
* The CPS server, two rounds: without compression, the parameters within
  2e-6 and the counts, losses and bits exact or close as stated; with
  int8 compression and half the clients failing, the counts and bits
  exact and each parameter within one quantisation step of its leaf (the
  largest scale any client's update of that leaf had). The two packages'
  deltas differ by float32 rounding, which can move a value across a
  rounding boundary of the quantiser; the step is what one such move
  costs after averaging.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import fl as jfl
from repro.core import deadline as jdeadline
from repro.core.slicing import ClientProfile as JProfile
from repro.fl import aggregation as jagg
from repro.fl import compression as jcomp
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro_torch import _cuda
from repro_torch import data as tdata
from repro_torch import fl as tfl
from repro_torch.core import deadline as tdeadline
from repro_torch.core.slicing import ClientProfile as TProfile
from repro_torch.fl import aggregation as tagg
from repro_torch.fl import compression as tcomp
from repro_torch.kernels.quant import kernel as k3
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import cnn_params_from_reference

CNN_TOL = 1e-5          # relative to the reference's largest value
AGG_TOL = dict(atol=1e-6, rtol=1e-6)
N_PARAMS = 6_603_710


@pytest.fixture(scope="module")
def ref_params():
    """The reference CNN's init (key 0) as numpy and as JAX arrays."""
    jp = jcnn.init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp), jp


def _np_tree(tree):
    """A port tree (dict of tensors) as a dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _max_rel(got, want):
    """Largest |got - want| over the largest |want|, leaf by leaf."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               / (float(np.abs(np.asarray(w)).max()) + 1e-30)
               for g, w in zip(gl, wl))


def _assert_trees_close(got, want, atol, rtol=0.0):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=rtol)


def _bitwise_trees(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()


# ------------------------------- data ------------------------------------


@pytest.mark.parametrize("n_writers,samples,seed", [(4, 16, 0), (16, 64, 0),
                                                    (3, 10, 5)])
def test_femnist_like_byte_identical(n_writers, samples, seed):
    tw, tt = tdata.femnist_like(n_writers, samples, seed=seed)
    jw, jt = jdata.femnist_like(n_writers, samples, seed=seed)
    _bitwise_trees(tw, jw)
    _bitwise_trees(tt, jt)


def test_tokens_and_partitions_byte_identical():
    t = tdata.lm_tokens(5000, 97, seed=3)
    j = jdata.lm_tokens(5000, 97, seed=3)
    assert t.tobytes() == j.tobytes()
    _bitwise_trees(tdata.partition_tokens(t, 3, 16),
                   jdata.partition_tokens(j, 3, 16))


def test_federated_clients_identical():
    tcl, tt = tdata.build_federated_cnn_clients(
        5, 12, tcnn.loss_fn, tfl.LocalTrainConfig(), seed=2)
    jcl, jt = jdata.build_federated_cnn_clients(
        5, 12, jcnn.loss_fn, jfl.LocalTrainConfig(), seed=2)
    _bitwise_trees(tt, jt)
    for a, b in zip(tcl, jcl):
        assert (a.client_id, a.t_ud_s, a.distance_m, a.n_samples) == (
            b.client_id, b.t_ud_s, b.distance_m, b.n_samples)
        _bitwise_trees(a.data, b.data)


# ------------------------- selection, deadline ---------------------------


def _profiles(n, seed=0):
    rng = np.random.default_rng(seed)
    t_ud = rng.uniform(1.0, 5.0, n)
    m = rng.uniform(1e6, 3e7, n)
    dist = rng.uniform(1e3, 4e4, n)
    mk = [dict(client_id=i, t_ud=float(t_ud[i]), t_dl=0.1 * (i % 3),
               m_ud_bits=float(m[i]), distance_m=float(dist[i]))
          for i in range(n)]
    return [TProfile(**k) for k in mk], [JProfile(**k) for k in mk]


@pytest.mark.parametrize("cfg", [
    dict(strategy="fraction", fraction=0.25),
    dict(strategy="fraction", fraction=0.5),
    dict(strategy="fraction", fraction=1.0),
    dict(strategy="fraction", fraction=0.01),
    dict(strategy="all"),
    dict(strategy="deadline", deadline_s=4.0, uplink_bps=1e8),
])
def test_select_clients_same_ids(cfg):
    tp, jp = _profiles(16)
    trng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        t = tfl.select_clients(tp, tfl.SelectionConfig(**cfg), trng)
        j = jfl.select_clients(jp, jfl.SelectionConfig(**cfg), jrng)
        assert [c.client_id for c in t] == [c.client_id for c in j]
    assert trng.bit_generator.state == jrng.bit_generator.state
    with pytest.raises(ValueError, match="unknown"):
        tfl.select_clients(tp, tfl.SelectionConfig(strategy="x"), trng)


@pytest.mark.parametrize("deadline_s,uplink_bps", [(3.0, 1e8), (5.0, 1e9),
                                                   (2.0, 1e7)])
def test_deadline_baseline_same_ids(deadline_s, uplink_bps):
    tp, jp = _profiles(20, seed=1)
    ts, td = tdeadline.select_by_deadline(tp, deadline_s, uplink_bps)
    js, jd = jdeadline.select_by_deadline(jp, deadline_s, uplink_bps)
    assert [c.client_id for c in ts] == [c.client_id for c in js]
    assert [c.client_id for c in td] == [c.client_id for c in jd]
    assert ([c.client_id for c in
             tdeadline.greedy_max_clients(tp, deadline_s, uplink_bps)]
            == [c.client_id for c in
                jdeadline.greedy_max_clients(jp, deadline_s, uplink_bps)])
    assert ([tdeadline.estimated_completion(c, uplink_bps) for c in tp]
            == [jdeadline.estimated_completion(c, uplink_bps) for c in jp])


# -------------------------------- CNN ------------------------------------


def test_cnn_init_matches_the_reference_layout(ref_params):
    npp, _ = ref_params
    g = torch.Generator().manual_seed(0)
    tp = tcnn.init_params(g, device="cpu")
    assert jax.tree.structure(npp) == jax.tree.structure(_np_tree(tp))
    for a, b in zip(jax.tree.leaves(npp), jax.tree.leaves(_np_tree(tp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert sum(a.size for a in jax.tree.leaves(npp)) == N_PARAMS
    assert tcnn.param_bytes(tp) == jcnn.param_bytes(npp) == 4 * N_PARAMS
    assert tcnn.param_bits(tp) == jcnn.param_bits(npp)
    # the reference's scales: conv1 w ~ N(0, 1/25), biases zero
    assert abs(float(tp["conv1"]["w"].std()) - 0.2) < 0.02
    assert float(tp["fc1"]["b"].abs().max()) == 0.0
    wide = tcnn.init_params(g, n_classes=10, width=2, device="cpu")
    assert tuple(wide["fc1"]["w"].shape) == (7 * 7 * 128, 4096)
    assert tuple(wide["fc2"]["b"].shape) == (10,)


def test_cnn_params_from_reference_checks(ref_params):
    npp, _ = ref_params
    tp = cnn_params_from_reference(npp, device="cpu")
    _bitwise_trees(_np_tree(tp), npp)
    bad = jax.tree.map(lambda a: a, npp)
    bad["fc1"] = {"w": npp["fc1"]["w"][:-1], "b": npp["fc1"]["b"]}
    with pytest.raises(ValueError, match="fc1/w"):
        cnn_params_from_reference(bad, device="cpu")
    bad["fc1"] = {"w": npp["fc1"]["w"].astype(np.float64),
                  "b": npp["fc1"]["b"]}
    with pytest.raises(ValueError, match="fc1/w"):
        cnn_params_from_reference(bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        cnn_params_from_reference({"conv1": npp["conv1"]}, device="cpu")


@pytest.mark.parametrize("batch_size,seed", [(16, 0), (5, 1)])
def test_cnn_forward_loss_and_grads(ref_params, batch_size, seed):
    npp, jp = ref_params
    tp = cnn_params_from_reference(npp, device="cpu")
    _, test = jdata.femnist_like(8, 16, seed=seed)
    batch = {k: v[:batch_size] for k, v in test.items()}
    logits = tcnn.forward(tp, batch["images"])
    assert logits.shape == (batch_size, 62) and logits.dtype == torch.float32
    assert _max_rel(logits.numpy(),
                    jcnn.forward(jp, batch["images"])) <= CNN_TOL
    lj, gj = jax.value_and_grad(jcnn.loss_fn)(jp, batch)
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    lt = tcnn.loss_fn(live, batch)
    lt.backward()
    assert abs(lt.item() - float(lj)) <= CNN_TOL * abs(float(lj))
    grads = jax.tree.map(lambda t: t.grad.numpy(), live)
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(gj)):
        assert _max_rel(g, w) <= CNN_TOL
    acc_t = float(tcnn.accuracy(tp, batch))
    assert acc_t == float(jcnn.accuracy(jp, batch))


@pytest.mark.parametrize("weights,z_loss", [(False, 0.0), (True, 0.0),
                                            (True, 1e-3), (False, 1e-2)])
def test_softmax_cross_entropy(weights, z_loss):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    w = (rng.random((3, 7)) < 0.6).astype(np.float32) if weights else None
    got = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w), z_loss=z_loss)
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), z_loss=z_loss)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------- local training -----------------------------


# (momentum, lr). Without momentum at lr 0.04 this writer's SGD runs away
# (its mean loss climbs to 5.7, above ln 62 = 4.1) and ReLU switches blow
# float32 rounding up to 1e-3 in 8 steps; the cases stay on trajectories
# that converge, where the two packages agree to ~1e-7
@pytest.mark.parametrize("momentum,lr", [(0.0, 0.02), (0.5, 0.04),
                                         (0.9, 0.01)])
def test_client_train(ref_params, momentum, lr):
    npp, jp = ref_params
    writers, _ = jdata.femnist_like(2, 32, seed=3)
    cfg = dict(lr=lr, batch_size=8, local_epochs=2, momentum=momentum)
    tc = tfl.Client(0, writers[1], tcnn.loss_fn, tfl.LocalTrainConfig(**cfg))
    jc = jfl.Client(0, writers[1], jcnn.loss_fn, jfl.LocalTrainConfig(**cfg))
    trng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    tparams, tloss = tc.train(cnn_params_from_reference(npp, device="cpu"),
                              trng)
    jparams, jloss = jc.train(jp, jrng)
    assert trng.bit_generator.state == jrng.bit_generator.state
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    _assert_trees_close(_np_tree(tparams), jparams, atol=1e-5)
    assert all(not t.requires_grad for t in jax.tree.leaves(tparams))


# ------------------------------ compression ------------------------------

SCHEMES = ["none", "int8", "topk", "int8+topk"]
SMALL_TREE = {"conv": {"w": (5, 5, 1, 8), "b": (8,)},
              "dense": {"w": (200, 37), "b": (37,)}, "out": (62,)}


def _deltas(shapes, seed, scale=1e-2):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        x = rng.standard_normal(s).astype(np.float32) * scale
        x.reshape(-1)[::7] = 0.0                  # zeros and ties in top-k
        x.reshape(-1)[1::11] = scale
        return x

    return make(shapes)


def _cnn_shapes(npp):
    return jax.tree.map(lambda a: a.shape, npp,
                        is_leaf=lambda a: isinstance(a, np.ndarray))


@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_compress_delta_bit_for_bit(scheme, error_feedback):
    cfg = dict(scheme=scheme, topk_frac=0.05, error_feedback=error_feedback)
    terr = jerr = None
    for call in range(2):
        d = _deltas(SMALL_TREE, seed=call)
        td, terr, tbits = tcomp.compress_delta(
            jax.tree.map(torch.from_numpy, d), tcomp.CompressorConfig(**cfg),
            terr)
        jd, jerr, jbits = jcomp.compress_delta(
            jax.tree.map(jnp.asarray, d), jcomp.CompressorConfig(**cfg), jerr)
        assert tbits == jbits and isinstance(tbits, int)
        _bitwise_trees(_np_tree(td), jd)
        assert (terr is None) == (jerr is None)
        if terr is not None:
            _bitwise_trees(_np_tree(terr), jerr)


@pytest.mark.parametrize("scheme", ["none", "int8"])
def test_compress_delta_cnn_update_bit_for_bit(ref_params, scheme):
    """The whole CNN update, as the round compresses it."""
    npp, _ = ref_params
    d = _deltas(_cnn_shapes(npp), seed=5, scale=1e-3)
    cfg = dict(scheme=scheme)
    td, terr, tbits = tcomp.compress_delta(
        jax.tree.map(torch.from_numpy, d), tcomp.CompressorConfig(**cfg))
    jd, jerr, jbits = jcomp.compress_delta(
        jax.tree.map(jnp.asarray, d), jcomp.CompressorConfig(**cfg))
    assert tbits == jbits == {"none": 211_318_720, "int8": 52_829_936}[scheme]
    _bitwise_trees(_np_tree(td), jd)
    if terr is not None:
        _bitwise_trees(_np_tree(terr), jerr)
    assert k3.quantize_launches == 0 and _cuda._lib is None


@pytest.mark.parametrize("frac", [0.05, 0.5, 1e-9])
def test_topk_sparsify_bit_for_bit(frac):
    x = _deltas({"x": (300, 7)}, seed=6)["x"]
    got = tcomp.topk_sparsify(torch.from_numpy(x), frac)
    want = jcomp.topk_sparsify(jnp.asarray(x), frac)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("topk_frac", [0.05, 0.2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_update_bits(ref_params, scheme, topk_frac):
    npp, _ = ref_params
    tp = cnn_params_from_reference(npp, device="cpu")
    t = tcomp.compressed_update_bits(
        tp, tcomp.CompressorConfig(scheme=scheme, topk_frac=topk_frac))
    j = jcomp.compressed_update_bits(
        npp, jcomp.CompressorConfig(scheme=scheme, topk_frac=topk_frac))
    assert t == j


def test_init_error_state():
    d = jax.tree.map(torch.from_numpy, _deltas(SMALL_TREE, seed=1))
    e = tcomp.init_error_state(d)
    _bitwise_trees(_np_tree(e), jcomp.init_error_state(
        jax.tree.map(jnp.asarray, _np_tree(d))))


# ------------------------------ aggregation ------------------------------


def _client_trees(n, seed=0):
    trees = [_deltas(SMALL_TREE, seed=seed + i, scale=1.0) for i in range(n)]
    return ([jax.tree.map(torch.from_numpy, t) for t in trees],
            [jax.tree.map(jnp.asarray, t) for t in trees])


@pytest.mark.parametrize("weights", [[64, 16, 32], [1.0, 1.0, 1.0],
                                     [0.3, 1e-3, 7.5]])
def test_fedavg_and_delta(weights):
    tt, jt = _client_trees(3)
    tg, jg = (x[0] for x in _client_trees(1, seed=10))
    _assert_trees_close(_np_tree(tagg.fedavg(tt, weights)),
                        jagg.fedavg(jt, weights), **AGG_TOL)
    _assert_trees_close(_np_tree(tagg.fedavg_delta(tg, tt, weights)),
                        jagg.fedavg_delta(jg, jt, weights), **AGG_TOL)
    with pytest.raises(ValueError, match="at least one"):
        tagg.fedavg([], [])


def test_fedadam_steps():
    tg, jg = (x[0] for x in _client_trees(1, seed=20))
    ts, js = tagg.fedadam_init(tg), jagg.fedadam_init(jg)
    for step in range(3):
        tt, jt = _client_trees(2, seed=30 + 2 * step)
        tg, ts = tagg.fedadam_step(tg, ts, tt, [3, 5], lr=0.05)
        jg, js = jagg.fedadam_step(jg, js, jt, [3, 5], lr=0.05)
        assert ts.count == js.count == step + 1
        _assert_trees_close(_np_tree(tg), jg, **AGG_TOL)
        _assert_trees_close(_np_tree(ts.mu), js.mu, **AGG_TOL)
        _assert_trees_close(_np_tree(ts.nu), js.nu, **AGG_TOL)


@pytest.mark.parametrize("staleness,fracs,server_lr", [
    (None, None, 1.0), ([0, 2, 5], None, 1.0), ([1, 0, 3], [1.0, 0.5, 0.25],
                                                0.7)])
def test_fedbuff_merge(staleness, fracs, server_lr):
    tg, jg = (x[0] for x in _client_trees(1, seed=40))
    tt, jt = _client_trees(3, seed=41)
    got = tagg.fedbuff_merge(tg, tt, [10, 20, 30], staleness, server_lr,
                             fracs=fracs)
    want = jagg.fedbuff_merge(jg, jt, [10, 20, 30], staleness, server_lr,
                              fracs=fracs)
    _assert_trees_close(_np_tree(got), want, **AGG_TOL)
    assert tagg.fedbuff_merge(tg, [], []) is tg
    assert tagg.fedbuff_merge(tg, tt, [0, 0, 0]) is tg
    assert tagg.staleness_scale(3, 0.7) == jagg.staleness_scale(3, 0.7)


@pytest.mark.parametrize("n_expected,frac", [(10, 0.5), (3, 1.0), (7, 0.3),
                                             (0, 0.5), (5, 0.81)])
def test_quorum(n_expected, frac):
    assert (tagg.quorum_threshold(n_expected, frac)
            == jagg.quorum_threshold(n_expected, frac))
    tg, jg = (x[0] for x in _client_trees(1, seed=50))
    tt, jt = _client_trees(3, seed=51)
    got, tmet = tagg.quorum_commit(tg, tt, [1, 2, 3], n_expected=n_expected,
                                   quorum_frac=frac, staleness=[0, 1, 2])
    want, jmet = jagg.quorum_commit(jg, jt, [1, 2, 3], n_expected=n_expected,
                                    quorum_frac=frac, staleness=[0, 1, 2])
    assert tmet == jmet
    _assert_trees_close(_np_tree(got), want, **AGG_TOL)
    for bad in ((-1, 0.5), (3, 0.0), (3, 1.5)):
        with pytest.raises(ValueError):
            tagg.quorum_threshold(*bad)


def test_fedbuff_aggregator():
    tg, jg = (x[0] for x in _client_trees(1, seed=60))
    tt, jt = _client_trees(5, seed=61)
    ta = tagg.FedBuffAggregator(buffer_size=3, server_lr=0.5)
    ja = jagg.FedBuffAggregator(buffer_size=3, server_lr=0.5)
    assert ta.flush(tg) is tg
    for i, (t, j) in enumerate(zip(tt, jt)):
        assert ta.add(t, 10 + i, staleness=i % 3) == ja.add(
            j, 10 + i, staleness=i % 3)
        assert ta.pending == ja.pending
        if ta.pending >= 3 or i == len(tt) - 1:
            tg, jg = ta.flush(tg), ja.flush(jg)
            _assert_trees_close(_np_tree(tg), jg, **AGG_TOL)
    assert ta.pending == 0


# ------------------------------ CPS server -------------------------------


def _servers(ref_params, scheme, failure_prob, fraction, n_clients=6):
    npp, jp = ref_params
    cfg = dict(lr=0.04, batch_size=8, local_epochs=2, momentum=0.5)
    tcl, _ = tdata.build_federated_cnn_clients(
        n_clients, 16, tcnn.loss_fn, tfl.LocalTrainConfig(**cfg), seed=0)
    jcl, _ = jdata.build_federated_cnn_clients(
        n_clients, 16, jcnn.loss_fn, jfl.LocalTrainConfig(**cfg), seed=0)
    common = dict(failure_prob=failure_prob, seed=1)
    ts = tfl.CPSServer(
        global_params=cnn_params_from_reference(npp, device="cpu"),
        clients=tcl, selection=tfl.SelectionConfig(fraction=fraction),
        compression=tfl.CompressorConfig(scheme=scheme), **common)
    js = jfl.CPSServer(
        global_params=jp, clients=jcl,
        selection=jfl.SelectionConfig(fraction=fraction),
        compression=jfl.CompressorConfig(scheme=scheme), **common)
    return ts, js


def _same_log(tlog, jlog):
    assert (tlog.round_index, tlog.n_selected, tlog.n_arrived,
            tlog.update_bits, tlog.quorum_met) == (
        jlog.round_index, jlog.n_selected, jlog.n_arrived,
        jlog.update_bits, jlog.quorum_met)
    assert abs(tlog.mean_loss - jlog.mean_loss) <= 1e-5 * abs(jlog.mean_loss)


def test_server_rounds_uncompressed(ref_params):
    ts, js = _servers(ref_params, "none", 0.0, 0.5)
    _, test = jdata.femnist_like(6, 16, seed=0)
    for _ in range(2):
        tlog = ts.run_round(eval_fn=lambda p: tcnn.accuracy(p, test))
        jlog = js.run_round(eval_fn=lambda p: jcnn.accuracy(p, test))
        _same_log(tlog, jlog)
        assert tlog.update_bits == tlog.n_arrived * 211_318_720
        assert abs(tlog.eval_metric - jlog.eval_metric) <= 1.5 / len(
            test["labels"])
        assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    _assert_trees_close(_np_tree(ts.global_params), js.global_params,
                        atol=2e-6)


def test_server_rounds_int8_with_failures(ref_params, monkeypatch):
    ts, js = _servers(ref_params, "int8", 0.5, 1.0)
    steps = {}                  # leaf shape -> largest scale of any update
    quantize = tcomp.quantize_int8

    def recording(x):
        q, s = quantize(x)
        steps[tuple(x.shape)] = max(steps.get(tuple(x.shape), 0.0), float(s))
        return q, s

    monkeypatch.setattr(tcomp, "quantize_int8", recording)
    for _ in range(2):
        tlog, jlog = ts.run_round(), js.run_round()
        _same_log(tlog, jlog)
        assert 0 < tlog.n_arrived < tlog.n_selected
        assert tlog.update_bits == tlog.n_arrived * 52_829_936
        assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    assert sorted(ts._error_states) == sorted(js._error_states)
    assert len(steps) == 8
    got, want = _np_tree(ts.global_params), js.global_params
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        step = steps[g.shape]
        assert np.abs(g - np.asarray(w)).max() <= step + 1e-6
    assert k3.quantize_launches == 0          # the CPU path: plain only


def test_server_deferred_updates(ref_params):
    """train_client_update, then apply_updates with staleness, fractions
    and a quorum, as the co-simulation drives them."""
    ts, js = _servers(ref_params, "int8", 0.0, 1.0, n_clients=3)
    tbase = ts.global_params
    jbase = js.global_params
    tu = [ts.train_client_update(c, tbase) for c in ts.clients]
    ju = [js.train_client_update(c, jbase) for c in js.clients]
    for a, b in zip(tu, ju):
        assert (a.client_id, a.weight, a.bits) == (b.client_id, b.weight,
                                                   b.bits)
        assert abs(a.loss - b.loss) <= 1e-5 * abs(b.loss)
    items_t = [(tu[0], 0, 1.0), (tu[1], 2, 0.5)]
    items_j = [(ju[0], 0, 1.0), (ju[1], 2, 0.5)]
    tlog = ts.apply_updates(items_t, n_expected=3, quorum_frac=0.5)
    jlog = js.apply_updates(items_j, n_expected=3, quorum_frac=0.5)
    _same_log(tlog, jlog)
    assert tlog.quorum_met is True
    tlog = ts.apply_updates([(tu[2], 1, 1.0)], n_expected=3,
                            quorum_frac=1.0)
    jlog = js.apply_updates([(ju[2], 1, 1.0)], n_expected=3, quorum_frac=1.0)
    _same_log(tlog, jlog)
    assert tlog.quorum_met is False
    with pytest.raises(ValueError, match="n_expected"):
        ts.apply_updates([], quorum_frac=0.5)
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    # a decoded leaf's largest value is 127 steps; a flipped rounding moves
    # one value by a step, in each of the two merged updates at most
    steps = jax.tree.map(
        lambda *ds: max(float(np.abs(np.asarray(d)).max()) for d in ds) / 127,
        *[u.delta for u in ju])
    got, want = _np_tree(ts.global_params), js.global_params
    for g, w, step in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                          jax.tree.leaves(steps)):
        assert np.abs(g - np.asarray(w)).max() <= 2 * step + 1e-6


@pytest.mark.parametrize("before", [True, False])
def test_full_float32_turns_tf32_off_and_restores(before):
    from repro_torch._device import full_float32

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = before
        torch.backends.cuda.matmul.allow_tf32 = before
        with pytest.raises(RuntimeError, match="inside"):
            with full_float32():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
                raise RuntimeError("inside")
        assert torch.backends.cudnn.allow_tf32 is before
        assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
