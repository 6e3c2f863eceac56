"""The port's op counter (``repro_torch.launch.hlo_analysis``) against the
reference package's HLO analysis and against hand counts.

The same small functions go through ``repro.launch.hlo_analysis.analyze``
of their compiled HLO and through the port's counter: their dot FLOPs
are equal (and the dot count, where the function has no loop). The rest
is held to hand counts: matrix products, K4's operator on fake ``cuda``
tensors by its causal and window formula, views at zero bytes, and
collective bytes by kind on a fake 8-rank mesh, a DTensor matmul at one
eighth of the whole product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as ref_hlo
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpCounter, analyze, live_keys


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _reference(f, *arrays):
    text = jax.jit(f).lower(*arrays).compile().as_text()
    return ref_hlo.analyze(text)


def _mlp_jax(x, w1, w2):
    return jax.nn.relu(x @ w1) @ w2


def _mlp_torch(x, w1, w2):
    return torch.relu(x @ w1) @ w2


def _scan_jax(x, ws):
    def body(h, w):
        return jnp.tanh(h @ w), None

    return jax.lax.scan(body, x, ws)[0]


def _scan_torch(x, ws):
    for i in range(ws.shape[0]):           # unrolled, as the port runs
        x = torch.tanh(x @ ws[i])
    return x


def _attention_jax(q, k, v):
    s = jnp.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    return jnp.einsum("bhst,bthd->bshd", jax.nn.softmax(s, axis=-1), v)


def _attention_torch(q, k, v):
    s = torch.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), v)


CASES = {
    "mlp": (_mlp_jax, _mlp_torch, ((8, 32), (32, 64), (64, 16)), True),
    "scan3": (_scan_jax, _scan_torch, ((8, 32), (3, 32, 32)), False),
    "attention": (_attention_jax, _attention_torch,
                  ((2, 16, 4, 8), (2, 16, 4, 8), (2, 16, 4, 8)), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dot_flops_equal_the_reference(name):
    f_jax, f_torch, shapes, loop_free = CASES[name]
    arrays = _inputs(*shapes)
    want = _reference(f_jax, *arrays)
    got = analyze(f_torch, *(torch.as_tensor(a) for a in arrays))
    assert want["flops"] > 0
    assert got["flops"] == want["flops"]
    if loop_free:
        assert got["dot_count"] == want["dot_count"]


def test_scan_counts_every_layer():
    # the reference multiplies its loop body by the trip count; the port
    # sees the three products themselves
    x, ws = (torch.as_tensor(a) for a in _inputs((8, 32), (3, 32, 32)))
    got = analyze(_scan_torch, x, ws)
    assert got["dot_count"] == 3
    assert got["flops"] == 3 * 2 * 8 * 32 * 32


def test_matrix_products_by_hand():
    a, b, c = (torch.as_tensor(x) for x in _inputs((5, 7), (7, 3), (5, 3)))
    ba, bb = (torch.as_tensor(x) for x in _inputs((4, 5, 7), (4, 7, 3)))

    def f():
        torch.mm(a, b)
        torch.addmm(c, a, b)
        torch.bmm(ba, bb)

    got = analyze(f)
    assert got["dot_count"] == 3
    assert got["flops"] == 2 * (2 * 5 * 3 * 7) + 2 * 4 * 5 * 3 * 7
    fl = 4                                   # float32 bytes
    mm = (5 * 7 + 7 * 3 + 5 * 3) * fl
    addmm = mm + 5 * 3 * fl
    bmm = (4 * 5 * 7 + 4 * 7 * 3 + 4 * 5 * 3) * fl
    assert got["hbm_bytes"] == mm + addmm + bmm
    assert got["collectives"]["total_bytes"] == 0


def test_views_move_no_bytes():
    x = torch.as_tensor(_inputs((6, 4))[0])

    def f():
        x.view(4, 6)
        x.t()
        x.transpose(0, 1)
        x[None].expand(3, 6, 4)
        x[1:4]
        x[2]
        x.detach()
        x.reshape(24)

    got = analyze(f)
    assert got["hbm_bytes"] == 0 and got["flops"] == 0
    assert sum(got["ops"].values()) >= 8


def test_elementwise_reads_and_writes_once():
    x, y = (torch.as_tensor(a) for a in _inputs((6, 4), (6, 4)))
    got = analyze(lambda: x + y)
    assert got["hbm_bytes"] == 3 * 6 * 4 * 4
    got = analyze(lambda: x * x)             # one tensor read once
    assert got["hbm_bytes"] == 2 * 6 * 4 * 4


@pytest.mark.parametrize("window", [None, 3])
def test_flash_attention_operator_on_fake_cuda(window):
    from repro_torch.kernels.attention import kernel

    B, S, H, K, D = 2, 8, 4, 2, 64
    live = live_keys(S, S, True, window)
    # by hand: causal, query i sees min(i + 1, window) keys
    assert live == sum(min(i + 1, window or S) for i in range(S))
    with dryrun.fake_mode():
        q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="cuda")
        k, v = (torch.empty((B, S, K, D), dtype=torch.bfloat16,
                            device="cuda") for _ in range(2))
        before = kernel.launches
        got = analyze(kernel.flash_attention_cuda, q, k, v, True, window)
    assert kernel.launches == before            # no launch: a fake tensor
    assert got["kernels"] == {"flash_attention": 1}
    assert got["flops"] == 4 * B * H * D * live
    assert got["dot_count"] == 0
    # q, k and v read, the output written, two bytes an element
    assert got["hbm_bytes"] == 2 * (2 * B * S * H * D + 2 * B * S * K * D)


def _mesh_counts(fn):
    """``fn(mesh)``'s counts on a fake 8-rank CPU mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    with dryrun.fake_process_group(8):
        mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("data",))
        return fn(mesh)


def test_collective_bytes_by_kind():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def run(mesh):
        shard = DTensor.from_local(torch.ones((2, 4)), mesh, [Shard(0)],
                                   run_check=False)           # (16, 4)
        small = DTensor.from_local(torch.ones((2, 4)), mesh, [Partial()],
                                   run_check=False)           # (2, 4)
        big = DTensor.from_local(torch.ones((16, 4)), mesh, [Partial()],
                                 run_check=False)             # (16, 4)
        return {name: analyze(lambda: x.redistribute(mesh, [to]).to_local())
                for name, x, to in (("gather", shard, Replicate()),
                                    ("reduce", small, Replicate()),
                                    ("scatter", big, Shard(0)))}

    got = _mesh_counts(run)
    fl = 4
    # the bytes each rank receives: the whole, its reduced part, its share
    assert got["gather"]["collectives"]["per_kind"] == {
        "all-gather": 16 * 4 * fl}
    assert got["reduce"]["collectives"]["per_kind"] == {
        "all-reduce": 2 * 4 * fl}
    assert got["scatter"]["collectives"]["per_kind"] == {
        "reduce-scatter": 2 * 4 * fl}
    for counts in got.values():
        assert counts["collectives"]["static_op_count"] == 1


def test_dtensor_matmul_is_counted_per_device():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    M, Kd, N = 64, 32, 16

    def run(mesh):
        x = DTensor.from_local(torch.ones((M // 8, Kd)), mesh, [Shard(0)],
                               run_check=False)
        w = DTensor.from_local(torch.ones((Kd, N)), mesh, [Replicate()],
                               run_check=False)
        counter = OpCounter()
        with counter:
            y = x @ w
        return counter.summary(), y.placements

    got, placements = _mesh_counts(run)
    assert placements == (Shard(0),)
    assert got["dot_count"] == 1
    assert got["flops"] == 2 * M * Kd * N / 8    # 1/(mesh size) of it
    assert got["collectives"]["total_bytes"] == 0
