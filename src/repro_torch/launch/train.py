"""LM training driver on a device mesh, timed by the PON co-simulation.

    python -m repro_torch.launch.train --steps 4 --rounds 2         # smoke, card
    python -m repro_torch.launch.train --device cpu                 # plain path
    python -m repro_torch.launch.train --arch olmo-1b --full --steps 4 --rounds 2
    python -m repro_torch.launch.train --ckpt-dir ck --log-jsonl ev.jsonl
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --pods 2 --batch 4 --seq 16 --steps 2 --rounds 2      # two ranks

The counterpart of the reference package's ``launch/train.py``, with its
arguments and defaults: the config-driven model, AdamW under a
warmup-cosine schedule, ``TokenBatcher`` streams over ``lm_tokens``,
every round's sync time from one multi-round timeline of the PON
co-simulation (``net.simulate``: faults, tenant jobs, several PONs and a
CPS uplink as given), a checkpoint a round, resume, and the
``--log-jsonl``/``--trace`` observability of ``repro_torch.obs``.

The run is one process a device: under ``torchrun`` (``WORLD_SIZE >
1``) the default process group starts from the environment (``nccl`` on
the cards, ``gloo`` with ``--device cpu``); otherwise a one-rank group on
an in-process ``HashStore`` (no sockets). A caller's running group is
used as it is. Over more than one rank the state, the batches and the
steps are DTensors on a ``DeviceMesh`` of ``device``'s type over the
group's ranks (``launch/mesh.py``; a group whose backend cannot serve
that device raises), placed by ``launch/specs.py``'s specs, as the
reference places them under its mesh; one rank runs the same steps on
plain tensors, a mesh of one device splitting nothing. The returned
state is whole tensors.

The pods are the reference's: ``pods = n_pods`` where the device count
allows (``n_dev % n_pods == 0 and n_dev >= n_pods``), else one. One pod
takes the single-pod train step (on a ``("data", "model")`` mesh over
several ranks). More than one takes the federated branch (on a
``("pod", "data", "model")`` mesh): one ``TokenBatcher`` a pod, the pod-stacked state of
``init_fed_state`` split over the ``pod`` axis, ``make_fed_train_step``
and an int8 (``compress``) FedAvg round a round; with a deadline or an
async buffer, the coupled FedBuff round (``make_async_round_step``)
driven by each timeline round's arrivals, staleness, partial fractions,
drops and give-ups, its ``AsyncRoundState`` checkpointed beside the
train state. The device count is the ranks of a job of more than one,
else the cards (1 on the CPU). Over several ranks the pod axis spans
them, each rank holding ``pods // ranks`` pods; one rank holds every
pod, in turn on its device. On one card, as on one JAX device, the formula gives one pod;
``device_count`` is the seam through which the tests (and
``chip_smoke.py`` ``fed_train``) see two devices. Checkpoints hold
whole tensors; rank 0 writes them, every rank reads them.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _dtensor
from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.slicing import ClientProfile
from repro_torch.data import TokenBatcher, lm_tokens
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import sharding as shd
from repro_torch.dist import stepfns
from repro_torch.faults import FaultSchedule
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.net.api import SweepSpec, simulate
from repro_torch.net.engine import SweepCase
from repro_torch.net.jobs import JobSpec, make_competing_jobs
from repro_torch.net.multi_pon import MultiPonTopology
from repro_torch.net.sim import FLRoundWorkload, PONConfig
from repro_torch.net.timeline import TimelineSchedule
from repro_torch.obs import Collector, EventLog, SpanTracer, maybe_span
from repro_torch.optim import OptimizerConfig, warmup_cosine


def device_count(dev: torch.device) -> int:
    """The devices a run may spread over: the ranks of a
    ``torch.distributed`` job of more than one; else the cards, or 1 on
    the CPU."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size()
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def mesh_shape(n_dev: int, pods: int) -> dict:
    """The axes of the reference's ``make_host_mesh`` over ``n_dev``
    devices (model parallelism 1): ``pod`` first where there is more
    than one pod. It is the run's mesh where the ranks are the devices;
    through the ``device_count`` seam (more devices than ranks: one
    rank) there is no mesh and the rank holds every pod."""
    axes = {"pod": pods} if pods > 1 else {}
    return {**axes, "data": n_dev // pods, "model": 1}


@contextlib.contextmanager
def process_group(dev: torch.device):
    """The default process group for the block: the running one, else
    one started from the environment under ``torchrun`` (``WORLD_SIZE >
    1``; ``nccl`` on the cards, each rank on its ``LOCAL_RANK``'s card,
    ``gloo`` on the CPU) or a one-rank group on an in-process
    ``HashStore``, destroyed on the way out."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def round_masks(timeline, idx: int, pods: int, in_retry: set, dev):
    """The coupled round step's ``(arrived, staleness, frac, snap,
    rejoin)`` of the timeline's round ``idx``, as ``(pods,)`` tensors on
    ``dev``. A pod snapshots its payload where its upload is fresh (in
    the round's ``ul_bits``, neither deferred from the round before nor
    a retry of a failed upload); it contributes where it arrived (a
    served fraction where its upload was partial), and rejoins the
    global where it contributed, was dropped or partial (a fraction 0
    is discarded like a drop) or gave up on its retries."""
    rn = timeline.rounds[idx]
    prev_def = timeline.rounds[idx - 1].deferred if idx > 0 else {}
    fresh = set(rn.ul_bits) - set(prev_def) - in_retry
    contrib = {cid: 1.0 for cid in rn.arrived}
    contrib.update({cid: f for cid, f in rn.partial.items() if f > 0.0})
    arrived = np.zeros(pods, bool)
    stale = np.zeros(pods, np.int32)
    fracs = np.ones(pods, np.float32)
    snap = np.zeros(pods, bool)
    rejoin = np.zeros(pods, bool)
    for cid in range(pods):
        snap[cid] = cid in fresh
        if cid in contrib:
            arrived[cid] = True
            fracs[cid] = contrib[cid]
            stale[cid] = rn.staleness.get(cid, 0)
        if (cid in contrib or cid in rn.dropped or cid in rn.partial
                or cid in rn.gave_up):
            rejoin[cid] = True
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (arrived, stale, fracs, snap, rejoin))


def net_spec(pods: int, up_bits: float, down_bits: float, rounds: int,
             policy: str = "bs", load: float = 0.8, n_pons: int = 1,
             cps_gbps: Optional[float] = None,
             deadline_s: Optional[float] = None,
             deadline_policy: str = "defer",
             async_buffer: Optional[int] = None,
             dropout_rate: float = 0.0, outage_rate: float = 0.0,
             loss_rate: float = 0.0, fault_seed: int = 0,
             quorum: Optional[float] = None, jobs: int = 0,
             fairness: str = "maxmin"):
    """The training run's network: ``(SweepSpec, job_specs)`` of one
    case, a ``TimelineSchedule`` of ``max(rounds, 1)`` rounds, built as
    the reference's ``train`` builds it: one client a pod (at least
    two), compute times from ``default_rng(0)``, compressed uploads of
    ``up_bits`` and a ``down_bits`` broadcast; the pods' FL task is job
    0 when ``jobs`` competitors contend with it."""
    rng = np.random.default_rng(0)
    profiles = [
        ClientProfile(client_id=i, t_ud=float(t), t_dl=0.0,
                      m_ud_bits=up_bits)
        for i, t in enumerate(rng.uniform(1.0, 5.0, max(pods, 2)))
    ]
    # one segment of n_pons; client i on global ONU i % (n_pons * n_onus)
    n_clients = max(pods, 2) + 2 * max(jobs, 0)
    if n_pons > 1:
        pon = PONConfig(n_onus=max(1, -(-n_clients // n_pons)))
    else:
        pon = PONConfig(n_onus=max(8, n_clients))
    topology = None
    if n_pons > 1 or cps_gbps is not None:
        topology = MultiPonTopology(
            n_pons=n_pons,
            cps_rate_bps=None if cps_gbps is None else cps_gbps * 1e9,
        )
    faults = None
    if dropout_rate > 0.0 or outage_rate > 0.0 or loss_rate > 0.0:
        faults = FaultSchedule(
            seed=fault_seed, dropout_rate=dropout_rate,
            outage_rate=outage_rate, loss_rate=loss_rate,
        )
    job_specs = None
    if jobs > 0:
        comp, extra = make_competing_jobs(
            [p.client_id for p in profiles], down_bits, jobs)
        job_specs = (JobSpec(
            job_id=0, clients=tuple(p.client_id for p in profiles),
            model_bits=down_bits,
        ),) + comp
        profiles = profiles + list(extra)
    wl = FLRoundWorkload(clients=profiles, model_bits=down_bits)
    spec = SweepSpec(
        cases=(SweepCase(workload=wl, load=load, policy=policy, seed=0,
                         topology=topology, jobs=job_specs,
                         fairness=fairness),),
        pon=pon,
        schedule=TimelineSchedule(n_rounds=max(rounds, 1),
                                  deadline_s=deadline_s,
                                  deadline_policy=deadline_policy,
                                  buffer_k=async_buffer, faults=faults,
                                  quorum_frac=quorum),
    )
    return spec, job_specs


def train(
    arch: str = "olmo-1b",
    smoke: bool = True,
    steps_per_round: int = 20,
    rounds: int = 3,
    n_pods: int = 2,
    global_batch: int = 8,
    seq_len: int = 64,
    lr: float = 3e-3,
    ckpt_dir: Optional[str] = None,
    policy: str = "bs",
    load: float = 0.8,
    compress: str = "int8",
    log_every: int = 10,
    config_overrides: Optional[dict] = None,
    n_pons: int = 1,
    cps_gbps: Optional[float] = None,
    deadline_s: Optional[float] = None,
    deadline_policy: str = "defer",
    async_buffer: Optional[int] = None,
    log_jsonl: Optional[str] = None,
    trace_path: Optional[str] = None,
    collector=None,
    resume: bool = True,
    dropout_rate: float = 0.0,
    outage_rate: float = 0.0,
    loss_rate: float = 0.0,
    fault_seed: int = 0,
    quorum: Optional[float] = None,
    jobs: int = 0,
    fairness: str = "maxmin",
    device=DEFAULT_DEVICE,
):
    """Train for ``rounds`` x ``steps_per_round`` steps on ``device``
    (the card by default; without one it raises, unless ``device="cpu"``).
    Returns ``(state, history)``: the final ``dist.stepfns.TrainState``
    (pod-stacked on the federated branch) and one dict a round
    (``round``, mean ``loss``, ``sync_s``, ``wall_s``)."""
    if jobs > 0 and (deadline_s is not None or async_buffer is not None
                     or quorum is not None or dropout_rate > 0.0
                     or outage_rate > 0.0 or loss_rate > 0.0):
        raise ValueError(
            "--jobs contention runs plain rounds: deadlines, async "
            "buffering, fault injection and quorum are single-tenant "
            "features (per-job deadlines go through JobSpec.deadline_s)"
        )
    dev = resolve_device(device)
    with process_group(dev):
        n_dev = device_count(dev)
        pods = n_pods if n_dev % n_pods == 0 and n_dev >= n_pods else 1
        fed = pods > 1
        world, rank = dist.get_world_size(), dist.get_rank()
        lead = rank == 0
        # over several ranks the pod axis spans them (pods = n_pods only
        # where the ranks divide); one rank takes the plain path (a mesh
        # of one device splits nothing, and DTensor dispatch would double
        # the step)
        mesh = (make_host_mesh(1, pods=pods, device=dev) if world > 1
                else None)

        cfg = get_config(arch, smoke=smoke).replace(grad_accum=1)
        if config_overrides:
            cfg = cfg.replace(**config_overrides)
        opt_cfg = OptimizerConfig(name="adamw", lr=lr)
        schedule = warmup_cosine(lr, 20, steps_per_round * rounds)

        log = EventLog(jsonl_path=log_jsonl if lead else None, console=lead)
        if lead and collector is None and (log_jsonl or trace_path):
            collector = Collector(
                tracer=SpanTracer(enabled=trace_path is not None), device=dev)
        log.emit("mesh", echo="mesh: {shape} devices={devices}",
                 shape=mesh_shape(n_dev, pods), devices=n_dev, arch=arch,
                 pods=pods, policy=policy, load=load)

        # federated data: one disjoint shard a pod
        tokens = lm_tokens(400_000, cfg.vocab_size, seed=0)
        iters = [iter(TokenBatcher(tokens, global_batch // pods, seq_len,
                                   seed=i, pod_index=i, n_pods=pods))
                 for i in range(pods)]

        # every rank draws the whole state, then keeps its part
        if fed:
            state = stepfns.init_fed_state(cfg, opt_cfg, pods, device=dev)
        else:
            state = stepfns.init_train_state(cfg, opt_cfg, device=dev)
        grad_sh = batch_spec = None
        if mesh is not None:
            spec = specs.state_spec_tree(state, cfg, mesh, fed=fed)
            state = specs.place_tree(state, spec, mesh)
            if fed:
                # the per-pod step's gradients in the per-pod placements:
                # the pod entry stripped, on the mesh's other axes
                sub = mesh["data", "model"]
                grad_sh = tree_map(lambda s: shd.to_placements(
                    shd.P(*s[1:]), sub), spec.params)
                per_pod = global_batch // pods
                batch_spec = shd.P("pod", "data" if per_pod
                                   % sub["data"].size() == 0 else None, None)
            else:
                grad_sh = shd.spec_tree_placements(spec.params, mesh)
        if fed:
            step = stepfns.make_fed_train_step(cfg, opt_cfg, schedule,
                                               grad_shardings=grad_sh,
                                               spmd_axis_name="pod")
            round_step = stepfns.make_fed_round_step(cfg, compress=compress)
        else:
            step = stepfns.make_train_step(cfg, opt_cfg, schedule,
                                           grad_shardings=grad_sh)
            round_step = None
        # deadline/async rounds: the buffered staleness-weighted round step,
        # driven by the timeline's arrivals, replaces the plain FedAvg; built
        # before the restore so that the template is the tree that is saved
        coupled = fed and (deadline_s is not None or async_buffer is not None)
        astate = around = None
        if coupled:
            astate = stepfns.init_async_state(state)
            around = stepfns.make_async_round_step(
                cfg, compress=compress, quorum_frac=quorum,
                quorum_expected=pods if quorum is not None else None)

        mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
        start_round = 0
        if mgr is not None and resume:
            template = {"train": state, "async": astate} if coupled else state
            restored = mgr.restore_latest(like=template)
            if restored is not None:
                tree, meta = restored
                # whole tensors, each rank keeping its part
                tree = tree_map(_dtensor.place_like, tree, template)
                if coupled:
                    state, astate = tree["train"], tree["async"]
                else:
                    state = tree
                del tree, template
                start_round = int(meta.get("round", 0))
                log.emit("resume", echo="resumed from round {round}",
                         round=start_round)
                # a resumed run consumes the batches an uninterrupted one
                # would (TokenBatcher is a pure function of its seed)
                for _ in range(start_round * steps_per_round):
                    for g in iters:
                        next(g)

        # the round's PON timing, the slice sized for the measured payloads:
        # the compressed per-pod upload, the float32 broadcast
        up_bits = float(stepfns.fed_update_bits(cfg, compress))
        down_bits = float(stepfns.fed_update_bits(cfg, "none"))
        log.emit("payload", compress=compress, upload_bits=up_bits,
                 model_bits=down_bits)
        spec, job_specs = net_spec(
            pods, up_bits, down_bits, rounds, policy=policy, load=load,
            n_pons=n_pons, cps_gbps=cps_gbps, deadline_s=deadline_s,
            deadline_policy=deadline_policy, async_buffer=async_buffer,
            dropout_rate=dropout_rate, outage_rate=outage_rate,
            loss_rate=loss_rate, fault_seed=fault_seed, quorum=quorum,
            jobs=jobs, fairness=fairness)
        if job_specs is not None:
            log.emit("jobs", echo="tenant jobs: {n} competitors "
                     "(fairness={fairness})", n=jobs, fairness=fairness)
        # ALWAYS the whole schedule, even on resume: round r's counter
        # streams are keyed by r, so a resumed run replays the same network
        n_net_rounds = max(rounds, 1)
        with maybe_span(collector, "net:timeline", rounds=n_net_rounds):
            timeline = simulate(spec, collector=collector, device=dev)[0]
        if job_specs is not None:
            # the pods' wall clock follows their job's sync time
            sync_times = np.array([rnd.job_sync.get(0, rnd.sync_time)
                                   for rnd in timeline.rounds])
        else:
            sync_times = timeline.sync_times

        wall_simulated = 0.0
        # pods whose failed upload is retrying (they re-enter the timeline
        # as carriers and must not snapshot their payload again), replayed
        # over the rounds before a resume
        in_retry: set = set()
        for rn in timeline.rounds[:start_round]:
            in_retry |= set(rn.failed) | set(rn.lost)
            in_retry -= set(rn.arrived) | set(rn.gave_up)
        history = []
        for rnd in range(start_round, rounds):
            t0 = time.time()
            losses = []
            for it in range(steps_per_round):
                parts = [next(g) for g in iters]
                host = ({k: np.stack([p[k] for p in parts])
                         for k in parts[0]} if fed else parts[0])
                if mesh is None:
                    batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in host.items()}
                else:
                    batch = shard_batch(host, mesh, batch_spec)
                state, metrics = step(state, batch)
                loss = float(_dtensor.full(metrics["loss"]).mean())
                losses.append(loss)
                if it % log_every == 0:
                    log.emit("step",
                             echo="round {round} step {step}: loss={loss:.4f}",
                             round=rnd, step=it, loss=loss)
            if fed:
                weights = torch.ones((pods,), dtype=torch.float32, device=dev)
                if coupled:
                    idx = min(rnd, len(timeline.rounds) - 1)
                    state, astate = around(state, astate, weights,
                                           *round_masks(timeline, idx, pods,
                                                        in_retry, dev))
                    rn = timeline.rounds[idx]
                    in_retry |= set(rn.failed) | set(rn.lost)
                    in_retry -= set(rn.arrived) | set(rn.gave_up)
                else:
                    state = round_step(state, weights)
            sync = float(sync_times[min(rnd, len(sync_times) - 1)])
            wall_simulated += sync
            entry = {"round": rnd, "loss": float(np.mean(losses)),
                     "sync_s": sync, "wall_s": time.time() - t0}
            history.append(entry)
            log.emit("round", **entry)
            if mgr is not None:
                tree = {"train": state, "async": astate} if coupled else state
                tree = tree_map(_dtensor.full, tree)
                if lead:
                    mgr.save(rnd + 1, tree, metadata={"round": rnd + 1})
                del tree
        if mgr is not None:
            mgr.wait()
        if history:
            log.emit(
                "done",
                echo="done: {rounds} rounds, final loss {loss:.4f}, "
                     "simulated FL wall-clock {wall_s:.1f}s "
                     "({policy} @ load {load})",
                rounds=rounds, loss=history[-1]["loss"],
                wall_s=wall_simulated, policy=policy, load=load,
            )
        else:
            log.emit(
                "done",
                echo="nothing to do: resumed at round {round}/{rounds}",
                round=start_round, rounds=rounds, loss=None,
                wall_s=0.0, policy=policy, load=load,
            )
        if collector is not None:
            log.emit("metrics", summary=collector.report().to_dict())
            if trace_path:
                collector.tracer.save(trace_path)
        log.close()
        return tree_map(_dtensor.full, state), history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--policy", choices=("bs", "fcfs"), default="bs")
    ap.add_argument("--load", type=float, default=0.8)
    ap.add_argument("--pons", type=int, default=1,
                    help="wavelength/OLT segments sharing the CPS uplink")
    ap.add_argument("--cps-gbps", type=float, default=None,
                    help="CPS uplink rate in Gb/s (default uncontended)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="round upload deadline in seconds (stragglers "
                         "handled per --deadline-policy)")
    ap.add_argument("--deadline-policy", default="defer",
                    choices=("defer", "drop", "partial"),
                    help="what happens to a straggler's unserved bits "
                         "at the deadline")
    ap.add_argument("--async-buffer", type=int, default=None,
                    help="async (FedBuff) mode: aggregate as soon as K "
                         "uploads complete; stragglers defer with "
                         "staleness")
    ap.add_argument("--log-jsonl", default=None,
                    help="write structured JSONL events to this path "
                         "(console lines become a formatted view of "
                         "the same events)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace JSON of the run's spans "
                         "to this path (view in Perfetto)")
    ap.add_argument("--resume", dest="resume", action="store_true",
                    default=True,
                    help="resume from the latest checkpoint in "
                         "--ckpt-dir (the default); a resumed run "
                         "reproduces an uninterrupted run exactly")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="ignore existing checkpoints and start fresh")
    ap.add_argument("--dropout-rate", type=float, default=0.0,
                    help="per-round client dropout probability "
                         "(deterministic counter-based fault stream)")
    ap.add_argument("--outage-rate", type=float, default=0.0,
                    help="per-round probability of an upstream "
                         "link-outage window per PON")
    ap.add_argument("--loss-rate", type=float, default=0.0,
                    help="per-round probability a completed upload's "
                         "payload arrives corrupted")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault-injection streams")
    ap.add_argument("--quorum", type=float, default=None,
                    help="quorum aggregation: a round commits only "
                         "when at least this fraction of pending "
                         "uploads arrived (needs --deadline)")
    ap.add_argument("--jobs", type=int, default=0,
                    help="competitor FL jobs contending with the pods' "
                         "task inside the same PON/CPS cycle (each "
                         "brings 2 clients and a half-size model)")
    ap.add_argument("--fairness", default="maxmin",
                    choices=("maxmin", "weighted", "deadline"),
                    help="how each cycle's capacity is split across "
                         "tenant jobs")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train(
        arch=args.arch, smoke=args.smoke, steps_per_round=args.steps,
        rounds=args.rounds, n_pods=args.pods, global_batch=args.batch,
        seq_len=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        policy=args.policy, load=args.load,
        n_pons=args.pons, cps_gbps=args.cps_gbps,
        deadline_s=args.deadline, deadline_policy=args.deadline_policy,
        async_buffer=args.async_buffer,
        log_jsonl=args.log_jsonl, trace_path=args.trace,
        resume=args.resume,
        dropout_rate=args.dropout_rate, outage_rate=args.outage_rate,
        loss_rate=args.loss_rate, fault_seed=args.fault_seed,
        quorum=args.quorum,
        jobs=args.jobs, fairness=args.fairness, device=args.device,
    )


if __name__ == "__main__":
    main()
