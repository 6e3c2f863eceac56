"""Step functions of the port: training on one pod and on a pod axis,
the federated FedAvg and FedBuff rounds, serving, and a pod update's
wire size.

The counterparts of the reference package's ``dist/stepfns.py``. There
they are jitted and lowered onto meshes; here they run eagerly, and a
step's gradients come from autograd (through the kernels'
``autograd.Function``s on a card). Every step takes plain tensors on one
device, or DTensors on a ``torch.distributed`` ``DeviceMesh`` placed by
``dist/sharding.py``'s rules (``launch/specs.py``): the same code then
runs on every rank, DTensor's sharding propagation deciding the
collectives, and the kernels run on each rank's local part.

Federated layout: every leaf of a federated ``TrainState`` carries a
leading ``n_pods`` axis (one pod per EC-node site). The reference vmaps
the single-pod step over that axis and shards it over the mesh's
``pod`` axis; ``make_fed_train_step`` here runs the pods' steps in turn
over the stacked leaves, which computes what the vmap computes
(``torch.func.vmap`` cannot take ``torch.autograd.grad`` or the kernels'
Functions). On a mesh whose ``pod`` axis (``spmd_axis_name``) shards the
pod-stacked state, each rank runs the pods it holds, each pod's step on
the mesh's other axes. ``grad_shardings`` brings the gradients to the
parameters' placements before they are summed and before AdamW, as the
reference's ``with_sharding_constraint`` does. ``make_fed_round_step``
is the weighted FedAvg whose upload (``M_i^UD``) the paper's BS slice is
sized for, and ``make_async_round_step`` the buffered
staleness-weighted FedBuff merge driven by the network timeline's
arrivals.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import _dtensor
from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import fedops
from repro_torch.models import lm
from repro_torch.optim.optimizers import (
    OptimizerConfig,
    OptState,
    apply_updates,
    init_opt_state,
)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Random parameters (``lm.init_params``: ``generator``, seed 0 if
    None) and a fresh optimizer state on ``device`` (the card if None)."""
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    params = lm.init_params(cfg, generator, dev)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def init_fed_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, n_pods: int,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> TrainState:
    """One :func:`init_train_state` repeated over a leading ``n_pods``
    axis on every leaf, each pod's copy in storage of its own: all pods
    start from the same global model (the CPS broadcast) and diverge
    through local steps."""
    base = init_train_state(cfg, opt_cfg, generator, device)
    return tree_map(lambda l: fedops._pod_broadcast(l, n_pods), base)


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, gradients) of ``lm.loss_fn`` at ``params``: autograd over
    leaves detached from ``params``; nothing is written in place."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm.loss_fn(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _constrain(grads, grad_shardings):
    """DTensor gradients redistributed to ``grad_shardings`` (a tree of
    placements matching the parameters'); plain ones pass through."""
    if grad_shardings is None:
        return grads
    return tree_map(lambda g, pl: g.redistribute(g.device_mesh, pl)
                    if _dtensor.is_dtensor(g) else g, grads, grad_shardings)


def _placed_as(new, old):
    """``new`` in ``old``'s placements where both are DTensors."""
    if (_dtensor.is_dtensor(new) and _dtensor.is_dtensor(old)
            and tuple(new.placements) != tuple(old.placements)):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    schedule: Optional[Callable] = None,
                    grad_shardings: Optional[Any] = None) -> Callable:
    """Single-pod step with microbatch gradient accumulation.

    ``step(state, batch) -> (state, metrics)`` where batch leaves are
    ``(B, ...)`` tensors on the state's device. With ``cfg.grad_accum >
    1`` the batch is split into ``grad_accum`` microbatches run in turn,
    their gradients summed in float32, divided by ``grad_accum`` and
    cast to the parameters' dtype, as the reference's scan body does.
    Metrics: ``loss``, ``grad_norm`` and ``lr`` (0-d tensors).

    On DTensors, ``grad_shardings`` (a tree of DTensor placements
    matching the parameters', ``sharding.spec_tree_placements``) pins
    each microbatch's gradients, their float32 sum and the gradients
    handed to AdamW to the parameters' layout. The new state comes out
    in the state's placements (AdamW's update of a ZeRO-sharded moment
    is sharded; the parameters are brought back to theirs), the metrics
    replicated.
    """
    accum = max(int(cfg.grad_accum), 1)

    def constrain(grads):
        return _constrain(grads, grad_shardings)

    def step(state: TrainState, batch):
        with _dtensor.mesh_context(state.opt.step):
            new, metrics = _step(state, batch)
        return (tree_map(_placed_as, new, state),
                {k: _replicated(v) for k, v in metrics.items()})

    def _step(state: TrainState, batch):
        if accum > 1:
            micro = [{k: _microbatch(v, accum, i) for k, v in batch.items()}
                     for i in range(accum)]
            g_sum = constrain(tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params))
            l_sum = torch.zeros_like(state.opt.step, dtype=torch.float32)
            for mb in micro:
                loss, g = _value_and_grad(state.params, cfg, mb)
                g_sum = constrain(tree_map(lambda a, b: a + b.to(a.dtype),
                                           g_sum, constrain(g)))
                l_sum = l_sum + loss
            grads = tree_map(lambda g, p: (g / accum).to(p.dtype),
                             g_sum, state.params)
            loss = l_sum / accum
        else:
            loss, grads = _value_and_grad(state.params, cfg, batch)
        grads = constrain(grads)

        lr = (schedule(state.opt.step) if schedule is not None
              else torch.tensor(opt_cfg.lr, dtype=torch.float32,
                                device=state.opt.step.device))
        params, opt, gnorm = apply_updates(state.params, grads, state.opt,
                                           opt_cfg, lr=lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=params, opt=opt), metrics

    return step


def _microbatch(v, accum: int, i: int):
    """Microbatch ``i`` of ``accum`` of the batch leaf ``v``: its rows
    ``i * B / accum`` up to ``(i + 1) * B / accum``, as the reference's
    reshape to ``(accum, B / accum, ...)`` takes them. A DTensor whose
    batch dim is split is made whole along it first (a microbatch's rows
    lie on other ranks: the reference's reshape fails to lower there,
    ROADMAP C3), and the microbatch is split as ``v`` was."""
    def take(x):
        return x.reshape((accum, x.shape[0] // accum)
                         + tuple(x.shape[1:]))[i]

    if not _dtensor.is_dtensor(v):
        return take(v)
    whole = _dtensor.whole_dim(v, 0)
    if whole is v:
        return take(v)
    return take(whole).redistribute(v.device_mesh, v.placements)


def _replicated(x):
    """A DTensor metric made replicated (a sum left partial is reduced);
    a plain one as it is."""
    if not _dtensor.is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _pod_split(leaf, ax: int, sub, i: int):
    """Local pod ``i`` of a pod-stacked DTensor (its pod axis ``Shard(0)``
    on mesh dim ``ax``) as a DTensor on the sub-mesh ``sub`` of the other
    mesh dims."""
    from torch.distributed.tensor import DTensor, Shard

    pl = list(leaf.placements)
    if pl[ax] != Shard(0):
        raise ValueError(f"the pod axis is not split over mesh dim {ax}: "
                         f"{pl}")
    rest = []
    for j, p in enumerate(pl):
        if j == ax:
            continue
        if isinstance(p, Shard):
            if p.dim % leaf.dim() == 0:
                raise ValueError(f"the pod axis is split twice: {pl}")
            p = Shard(p.dim % leaf.dim() - 1)
        rest.append(p)
    shape = tuple(leaf.shape[1:])
    return DTensor.from_local(leaf.to_local()[i], sub, rest, run_check=False,
                              shape=torch.Size(shape),
                              stride=_dtensor.contiguous_strides(shape))


def make_fed_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                        schedule: Optional[Callable] = None,
                        grad_shardings: Optional[Any] = None,
                        spmd_axis_name: Optional[str] = None) -> Callable:
    """Per-pod local step over the federated (pod-stacked) state.

    ``step(state, batch) -> (state, metrics)`` with batch leaves
    ``(n_pods, per_pod_B, ...)``: each pod takes :func:`make_train_step`
    on its own slice of the state and its own batch, with no cross-pod
    traffic (the paper's local-epoch phase). The pods run in turn, each
    result copied into freshly allocated stacked leaves; the metrics
    (``loss``, ``grad_norm``, ``lr``) are ``(n_pods,)`` tensors.

    On DTensors (the batch's placed as ``launch.specs.train_batch_specs``
    gives), ``spmd_axis_name`` (``"pod"``) names the mesh dim that splits
    the pod axis of the state and the batch (``Shard(0)``): each rank
    runs the pods it holds, each pod's state and batch a DTensor on
    the mesh's other dims, with the per-pod ``grad_shardings`` (pod axis
    stripped), and the results are stacked back over the pod dim.
    """
    base = make_train_step(cfg, opt_cfg, schedule,
                           grad_shardings=grad_shardings)

    def step(state: TrainState, batch):
        if _dtensor.is_dtensor(state.opt.step):
            return mesh_step(state, batch)
        n_pods = state.opt.step.shape[0]
        out, metrics = None, []
        for i in range(n_pods):
            new, m = base(tree_map(lambda l: l[i], state),
                          {k: v[i] for k, v in batch.items()})
            if out is None:
                out = tree_map(lambda l: l.new_empty(
                    (n_pods,) + tuple(l.shape)), new)
            tree_map(lambda dst, src: dst[i].copy_(src), out, new)
            metrics.append(m)
            del new
        return out, {k: torch.stack([m[k] for m in metrics])
                     for k in metrics[0]}

    def mesh_step(state: TrainState, batch):
        if spmd_axis_name is None:
            raise ValueError("a pod-stacked DTensor state needs "
                             "spmd_axis_name, the mesh dim of its pod axis")
        mesh = state.opt.step.device_mesh
        names = mesh.mesh_dim_names
        ax = names.index(spmd_axis_name)
        sub = mesh[tuple(n for n in names if n != spmd_axis_name)]
        n_pods = state.opt.step.shape[0]
        n_local = state.opt.step.to_local().shape[0]
        out, metrics = None, []
        for i in range(n_local):
            pod = {k: _pod_split(v, ax, sub, i) for k, v in batch.items()}
            new, m = base(tree_map(lambda l: _pod_split(l, ax, sub, i),
                                     state), pod)
            new = tree_map(_dtensor.local, new)
            if out is None:
                out = tree_map(lambda l: l.new_empty(
                    (n_local,) + tuple(l.shape)), new)
            tree_map(lambda dst, src: dst[i].copy_(src), out, new)
            metrics.append({k: _dtensor.local(v) for k, v in m.items()})
            del new
        out = tree_map(lambda o, l: _restack(o, l, mesh, ax, n_pods),
                         out, state)
        return out, {k: _restack(torch.stack([m[k] for m in metrics]),
                                 None, mesh, ax, n_pods)
                     for k in metrics[0]}

    return step


def _restack(local, like, mesh, ax: int, n_pods: int):
    """The stacked local pods ``local`` as a pod-stacked DTensor placed as
    ``like`` (a metric, ``like=None``: replicated but for the pod
    axis)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if like is None:
        pl = [Replicate()] * mesh.ndim
        pl[ax] = Shard(0)
        shape = (n_pods,) + tuple(local.shape[1:])
    else:
        pl, shape = list(like.placements), tuple(like.shape)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_dtensor.contiguous_strides(shape))


def make_fed_round_step(cfg: ModelConfig, compress: Optional[str] = None,
                        topk_frac: float = 0.05,
                        error_feedback: bool = False) -> Callable:
    """Weighted FedAvg across the pod axis.

    ``round_step(state, weights) -> state`` with ``weights`` ``(n_pods,)``
    (client data sizes). ``compress`` in ``{None, "none", "int8",
    "topk", "int8+topk"}`` round-trips each pod's update through the
    wire compression before averaging (``fedops.fedavg_pods``).
    Optimizer moments stay pod-local. With ``error_feedback=True`` the
    signature becomes ``round_step(state, weights, residuals) -> (state,
    residuals)`` (:func:`init_round_residuals` builds the zeros). The
    upload's wire size is ``fed_update_bits(cfg, compress)``.
    """
    scheme = fedops.check_scheme(compress)

    if error_feedback:
        def round_step_ef(state: TrainState, weights, residuals):
            params, new_res = fedops.fedavg_pods(
                state.params, weights, scheme=scheme, topk_frac=topk_frac,
                residuals=residuals)
            return TrainState(params=params, opt=state.opt), new_res

        return round_step_ef

    def round_step(state: TrainState, weights) -> TrainState:
        params = fedops.fedavg_pods(state.params, weights, scheme=scheme,
                                    topk_frac=topk_frac)
        return TrainState(params=params, opt=state.opt)

    return round_step


def init_round_residuals(state: TrainState):
    """Zero error-feedback residuals for the round steps with
    ``error_feedback=True``: pod-stacked float32, like the params."""
    return fedops.init_residuals(state.params)


class AsyncRoundState(NamedTuple):
    """Cross-round state of the async (FedBuff) federated loop.

    ``global_params``: pod-stacked copies of the current global model.
    ``refs``: each pod's download reference, the global model it last
    synced to, which its next upload delta is computed against.
    ``pending``: each pod's snapshotted float32 update delta, the
    payload on the wire while its upload is in flight.
    """

    global_params: Any
    refs: Any
    pending: Any


def init_async_state(state: TrainState) -> AsyncRoundState:
    """Fresh async state: every pod synced to the same global model (the
    state's parameters, shared: no step writes in place), nothing in
    flight."""
    return AsyncRoundState(
        global_params=state.params, refs=state.params,
        pending=fedops.init_residuals(state.params))


def make_async_round_step(cfg: ModelConfig, compress: Optional[str] = None,
                          topk_frac: float = 0.05,
                          error_feedback: bool = False,
                          server_lr: float = 1.0,
                          staleness_power: float = 0.5,
                          quorum_frac: Optional[float] = None,
                          quorum_expected: Optional[int] = None) -> Callable:
    """Buffered asynchronous aggregation (FedBuff) across the pod axis.

    ``async_step(state, astate, weights, arrived, staleness, frac, snap,
    rejoin) -> (state, astate)``, every argument after ``astate`` a
    ``(n_pods,)`` tensor driven by the network timeline's arrivals:

    * ``snap`` (bool): pods that just finished their local round; their
      delta ``params - refs`` is snapshotted into ``pending`` (later
      training never leaks into the in-flight payload);
    * ``arrived`` (bool): pods whose upload reached the CPS this round;
      their pending deltas merge into the global, weighted ``w_i ·
      frac_i / (1+τ_i)^p`` (``staleness`` τ in rounds);
    * ``rejoin`` (bool): pods that resync to the new global (params and
      refs); stragglers still uploading keep theirs.

    Optimizer moments stay pod-local. With ``error_feedback=True`` the
    step takes a trailing ``residuals`` and returns ``(state, astate,
    residuals)``. ``quorum_frac`` gates the merge (``fedops.fedbuff_pods``)
    against ``quorum_expected`` pods (default ``n_pods``): below quorum
    the global passes through and rejoining pods resync to it unchanged.
    """
    scheme = fedops.check_scheme(compress)

    def _advance(state, astate, weights, arrived, staleness, frac, snap,
                 rejoin, residuals):
        with _dtensor.mesh_context(state.opt.step):
            return _advance_on(state, astate, weights, arrived, staleness,
                               frac, snap, rejoin, residuals)

    def _advance_on(state, astate, weights, arrived, staleness, frac, snap,
                    rejoin, residuals):
        dev = state.opt.step.device
        snap = torch.as_tensor(snap, device=dev)
        rejoin = torch.as_tensor(rejoin, device=dev)
        # on DTensors every new leaf keeps the placements of the one it
        # replaces (a mask meets the leaves as a replicated tensor)
        pending = tree_map(
            lambda p, ref, pen: _placed_as(torch.where(
                fedops._bmask(snap, pen), p.float() - ref.float(), pen), pen),
            state.params, astate.refs, astate.pending)
        merged = fedops.fedbuff_pods(
            pending, astate.global_params, weights, arrived, staleness,
            server_lr=server_lr, scheme=scheme, topk_frac=topk_frac,
            staleness_power=staleness_power, frac=frac,
            residuals=residuals, quorum_frac=quorum_frac,
            n_expected=quorum_expected)
        new_global, new_res = merged if error_feedback else (merged, None)

        def take(new, old):
            return tree_map(lambda n, o: _placed_as(torch.where(
                fedops._bmask(rejoin, o), n, o), o), new, old)

        params = take(new_global, state.params)
        refs = take(new_global, astate.refs)
        new_astate = AsyncRoundState(global_params=new_global, refs=refs,
                                     pending=pending)
        return TrainState(params=params, opt=state.opt), new_astate, new_res

    if error_feedback:
        return _advance

    def async_step(state, astate, weights, arrived, staleness, frac, snap,
                   rejoin):
        state, astate, _ = _advance(state, astate, weights, arrived,
                                    staleness, frac, snap, rejoin, None)
        return state, astate

    return async_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``step(params, tokens, cache, extra_embeds=None) -> (logits, cache)``
    (on DTensors, plain tensors made inside join as replicated)."""

    def step(params, tokens, cache, extra_embeds=None):
        with _dtensor.mesh_context(tokens):
            return lm.prefill(params, cfg, tokens, cache, extra_embeds)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, token, cache) -> (logits, cache)`` — one token (on
    DTensors, plain tensors made inside join as replicated)."""

    def step(params, token, cache):
        with _dtensor.mesh_context(token):
            return lm.decode_step(params, cfg, token, cache)

    return step


def fed_update_bits(cfg: ModelConfig, compress: Optional[str] = "int8",
                    topk_frac: float = 0.05) -> int:
    """Wire bits of one pod's upload under ``compress`` (``M_i^UD``).

    The parameter tree is built under ``FakeTensorMode`` (shapes and
    dtypes, no storage) and counted by ``repro_torch.fl.compression``'s
    accounting, as the reference counts its ``eval_shape`` tree.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.fl.compression import (
        CompressorConfig,
        compressed_update_bits,
    )

    scheme = fedops.check_scheme(compress)
    with FakeTensorMode():
        params = lm.init_params(cfg, device="cpu")
    comp = CompressorConfig(scheme=scheme, topk_frac=topk_frac)
    return compressed_update_bits(params, comp)


def payload_summary(cfg: ModelConfig, schemes=("none", "int8"),
                    topk_frac: float = 0.05) -> dict:
    """Wire-size provenance of one pod's upload a compression scheme
    (``model_bits`` is the float32 broadcast downlink)."""
    bits = {str(s): int(fed_update_bits(cfg, s, topk_frac))
            for s in schemes}
    return {
        "model_bits": bits.get("none", int(fed_update_bits(cfg, "none"))),
        "upload_bits": bits,
        "topk_frac": topk_frac,
    }
