#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line with its seconds; any failure exits
nonzero:

1. build the Hopper kernels from ``src/repro_torch/csrc`` (both ``nvcc``
   runs at once) and print the card's name and power limit;
2. K1, the traffic sampler, against its plain PyTorch version on the
   card, bit for bit: the sampler parity shapes, the engine's chunk
   shapes and two pinned stream fingerprints;
3. K2, the waterfill grant, against its plain version run on CPU copies
   of the same inputs, bit for bit;
4. the main path: the 16-case Fig. 2b sweep (128 ONUs, {fcfs, bs} x
   load {0.3, 0.8} x involvement {0.1, 0.4, 0.7, 1.0}) through
   ``repro_torch.net.simulate`` on the card; every sync time must match
   the JAX engine's value within 1e-9 s and both kernels must have been
   launched; one warm-up run, then the median wall time of 3;
5. full width: one FCFS load-0.8 round at 2048 ONUs (line rate scaled
   10 Gb/s * n / 128) held against the JAX engine's sync time.

Before the last line it prints one JSON object with each kernel's
launches on the main path, its error against the plain version, its
time, the plain version's time and the least time the card could take
(``bound_ms``). The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Fig. 2b sync times (s) of the JAX package's numpy engine for the cases
# of fig2b_cases(), and of its 2048-ONU FCFS load-0.8 round (seed 0);
# tests/test_torch_engine.py recomputes both from the JAX package
SYNC_TABLE = {
    "fcfs_load0.3_n12": 4.933099999999982,
    "fcfs_load0.3_n51": 5.005100000000006,
    "fcfs_load0.3_n89": 5.000100000000004,
    "fcfs_load0.3_n128": 5.280100000000098,
    "fcfs_load0.8_n12": 5.058100000000024,
    "fcfs_load0.8_n51": 5.4651000000001595,
    "fcfs_load0.8_n89": 5.55610000000019,
    "fcfs_load0.8_n128": 6.312100000000442,
    "bs_load0.3_n12": 4.909099999999974,
    "bs_load0.3_n51": 4.909099999999974,
    "bs_load0.3_n89": 4.909099999999974,
    "bs_load0.3_n128": 4.909099999999974,
    "bs_load0.8_n12": 4.909099999999974,
    "bs_load0.8_n51": 4.909099999999974,
    "bs_load0.8_n89": 4.909099999999974,
    "bs_load0.8_n128": 4.909099999999974,
}
SYNC_2048 = 6.735100000000584
SYNC_TOL = 1e-9

M_BITS = 26.416e6
N_ONUS = 128
FRACTIONS = (0.1, 0.4, 0.7, 1.0)
GRID = (("fcfs", 0.3), ("fcfs", 0.8), ("bs", 0.3), ("bs", 0.8))

# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s; the
# non-tensor 32-bit rate, applied to the sampler's integer ops; the
# non-tensor float64 rate
HBM_BYTES_S = 3.35e12
OPS32_S = 67e12
FP64_S = 34e12
THREEFRY_OPS = 120        # 32-bit ALU ops of one threefry-2x32 draw


def _line(phase: str, seconds: float, **kw) -> None:
    extra = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{phase}] {seconds:.3f}s {extra}".rstrip(), flush=True)


def _clients(n: int, n_onus: int, seed: int = 42):
    from repro_torch.core.slicing import ClientProfile

    t_uds = np.random.default_rng(seed).uniform(1.0, 5.0, n_onus)
    return [ClientProfile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                          m_ud_bits=M_BITS) for i in range(n)]


def fig2b_cases(seed: int = 1):
    """The Fig. 2b grid in ``SYNC_TABLE`` order, as port types."""
    from repro_torch.net import FLRoundWorkload, SweepCase

    names, cases = [], []
    for policy, load in GRID:
        for frac in FRACTIONS:
            n = max(1, int(frac * N_ONUS))
            wl = FLRoundWorkload(clients=_clients(n, N_ONUS),
                                 model_bits=M_BITS)
            names.append(f"{policy}_load{load}_n{n}")
            cases.append(SweepCase(workload=wl, load=load, policy=policy,
                                   seed=seed))
    return names, cases


def full_width_spec(n: int = 2048):
    """One FCFS load-0.8 round at ``n`` ONUs, every ONU a client."""
    from repro_torch.net import (
        FLRoundWorkload,
        PONConfig,
        SweepCase,
        SweepSpec,
    )

    cfg = PONConfig(n_onus=n, line_rate_bps=10e9 * n / 128)
    wl = FLRoundWorkload(clients=_clients(n, n), model_bits=M_BITS)
    return SweepSpec(cases=(SweepCase(workload=wl, load=0.8,
                                      policy="fcfs", seed=0),), pon=cfg)


def _time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from repro_torch import _cuda

    t0 = time.time()
    lib = _cuda.build()
    _cuda.library()
    log = lib.with_suffix(".log").read_text()
    for row in log.splitlines():
        if "registers" in row or "==" in row or "error" in row.lower():
            print("  " + row.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    _line("build", time.time() - t0, torch=torch.__version__,
          cuda=torch.version.cuda, lib=lib.name)
    return smi.splitlines()[0]


def _k1_inputs(keys, lam, dev):
    from repro_torch.kernels.traffic import ops, ref

    keys = np.atleast_2d(np.asarray(keys, np.uint32))
    lam = np.ascontiguousarray(np.broadcast_to(
        np.asarray(lam, np.float32), (keys.shape[0],)))
    n_draws = ops._tail_bound(float(lam.max()) * ref.WINDOW)
    thr = ref.poisson_thresholds(lam.astype(np.float64) * ref.WINDOW,
                                 n_draws)
    starts, lengths = ops._table(1.0 / 16.0, dev)
    return (torch.as_tensor(keys.astype(np.int64), device=dev),
            torch.as_tensor(thr, device=dev), starts, lengths)


def _engine_streams(n_onus: int, cases, cfg):
    """(keys, lams) of the FCFS upload rows the engine samples."""
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net import MultiPonTopology, burst_lambda, pon_bg_rates

    topo = MultiPonTopology()
    keys, lams = [], []
    for c in cases:
        if c.policy != "fcfs":
            continue
        rate = pon_bg_rates(c.workload.clients, c.workload.model_bits,
                            c.load, cfg, topo)[0]
        keys.append(make_stream_key(c.seed, 1, 0, 0))
        lams.append(burst_lambda(rate, cfg.cycle_time_s))
    return np.stack(keys), np.asarray(lams, np.float32)


def phase_k1():
    from repro_torch.kernels.traffic import kernel, ref
    from repro_torch.kernels.traffic.ops import make_stream_key
    from repro_torch.net import PONConfig

    t0 = time.time()
    dev = torch.device("cuda")
    pkt = 12_000.0
    checks = []           # (keys, cycle0, n_cycles, n_onus, lam)
    key = make_stream_key(5, 0, 1)
    for c0, nc, no in [(0, 64, 8), (5, 64, 21), (77, 130, 2),
                       (1000, 200, 37), (63, 65, 1)]:
        checks.append((key, c0, nc, no, 0.6))
    _, cases = fig2b_cases()
    k8, l8 = _engine_streams(N_ONUS, cases, PONConfig(n_onus=N_ONUS))
    checks.append((k8, 0, 1024, N_ONUS, l8))
    checks.append((k8, 5120, 1024, N_ONUS, l8))
    spec = full_width_spec()
    k1, l1 = _engine_streams(2048, spec.cases, spec.pon)
    checks.append((k1, 0, 1024, 2048, l1))
    err = 0.0
    for keys, c0, nc, no, lam in checks:
        kt, thr, st, ln = _k1_inputs(keys, lam, dev)
        got = kernel.sample_arrival_bits_cuda(
            kt, c0, thr, st, ln, pkt, n_cycles=nc, n_onus=no)
        want = ref.sample_arrival_bits_ref(
            kt, c0, thr, st, ln, pkt, n_cycles=nc, n_onus=no)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K1 differs from its plain version at "
                             f"cycle0={c0} n_cycles={nc} n_onus={no}")
        err = max(err, float((got - want).abs().max()))
    for pon, total in ((0, 209_160_000.0), (1, 193_656_000.0)):
        kt, thr, st, ln = _k1_inputs(make_stream_key(3, 1, 2, pon), 0.5,
                                     dev)
        got = kernel.sample_arrival_bits_cuda(
            kt, 128, thr, st, ln, pkt, n_cycles=256, n_onus=8)
        if float(got.sum()) != total:
            raise SystemExit(f"K1 stream fingerprint pon={pon}: "
                             f"{float(got.sum())} != {total}")

    # time at the main path's chunk shape: 8 rows x 1024 cycles x 128
    kt, thr, st, ln = _k1_inputs(k8, l8, dev)
    args = (kt, 0, thr, st, ln, pkt)
    kw = dict(n_cycles=1024, n_onus=N_ONUS)
    ms = _time_ms(lambda: kernel.sample_arrival_bits_cuda(*args, **kw))
    plain_ms = _time_ms(lambda: ref.sample_arrival_bits_ref(*args, **kw),
                        reps=5)
    cells = kt.shape[0] * ref._windows(0, 1024)[1] * N_ONUS
    bursts = int(ref.window_counts(kt, 0, 1024, N_ONUS, thr).sum())
    n_bytes = (kt.numel() * 8 + thr.numel() * 4 + st.numel() * 8
               + kt.shape[0] * 1024 * N_ONUS * 8)
    n_ops = THREEFRY_OPS * (cells + bursts)
    bound = max(n_bytes / HBM_BYTES_S, n_ops / OPS32_S) * 1e3
    _line("k1", time.time() - t0, checks=len(checks) + 2,
          bitwise="yes", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bound:.5f}")
    return {
        "name": "traffic_sampler", "route": "cuda",
        "source": "src/repro_torch/csrc/traffic.cu",
        "replaces": "src/repro/kernels/traffic/kernel.py:164",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": ("bytes" if n_bytes / HBM_BYTES_S >= n_ops / OPS32_S
                     else "operations"),
        "library_ms": None,
    }


def k2_case(rng, R: int, N: int, int_keys: bool):
    """Random waterfill rows: ties, empty queues (inf keys), zero
    backlogs, rows on both sides of ``cap - 1``."""
    from repro_torch.net.engine import _IKEY_INF

    backlog = rng.integers(0, 50, (R, N)) * 12_000.0
    backlog[:, ::3] += rng.uniform(0, 1e4, (R, (N + 2) // 3))
    backlog[rng.random((R, N)) < 0.3] = 0.0
    if int_keys:
        key = rng.integers(0, max(2, N // 4), (R, N)).astype(np.int64)
        key = np.where(backlog > 0, key, _IKEY_INF)
    else:
        key = np.round(rng.uniform(0, 1, (R, N)), 1)
        key = np.where(backlog > 0, key, np.inf)
    total = backlog.sum(axis=1)
    frac = rng.uniform(0.2, 0.9, R)
    cap = np.where(np.arange(R) % 2 == 0, total * frac,
                   total + 1.0 + rng.uniform(0, 1e3, R))
    cap[1 % R] = total[1 % R] + 1.0    # exactly at cap - 1: not hard
    return backlog, key, cap


def phase_k2():
    from repro_torch.kernels.ponsim import kernel, ops, ref

    t0 = time.time()
    rng = np.random.default_rng(11)
    err = 0.0
    n_checks = 0
    for N in (1, 37, 128, 2048):
        for int_keys in (False, True):
            b, k, c = (torch.as_tensor(a)
                       for a in k2_case(rng, 8, N, int_keys))
            # one hard mask for both: the row sums of the card and the CPU
            # may round apart on the row that sits at cap - 1
            hard = ref.hard_rows(b, c)
            got = ops.waterfill_grants(b, k, c, hard.cuda(),
                                       device="cuda").cpu()
            want = ref.waterfill_grants_ref(b, k, c, hard)
            if not torch.equal(got, want):
                raise SystemExit(f"K2 differs from its plain version at "
                                 f"N={N} int_keys={int_keys}")
            err = max(err, float((got - want).abs().max()))
            n_checks += 1

    def timed(R, N):
        b, k, c = (torch.as_tensor(a, device="cuda")
                   for a in k2_case(rng, R, N, False))
        c = b.sum(dim=1) * 0.5           # every row hard
        hard = ref.hard_rows(b, c)
        ms = _time_ms(lambda: kernel.waterfill_grants_cuda(b, k, c, hard))
        plain = _time_ms(lambda: ref.waterfill_grants_ref(b, k, c, hard))
        n_bytes = 3 * b.numel() * 8 + R * 9
        n_ops = R * (N * max(1, math.ceil(math.log2(N))) + 3 * N)
        bound = max(n_bytes / HBM_BYTES_S, n_ops / FP64_S) * 1e3
        by = "bytes" if n_bytes / HBM_BYTES_S >= n_ops / FP64_S \
            else "operations"
        return ms, plain, bound, by

    ms, plain_ms, bound, by = timed(8, N_ONUS)
    ms_w, plain_w, bound_w, _ = timed(1, 2048)
    _line("k2", time.time() - t0, checks=n_checks, bitwise="yes",
          ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          bound_ms=f"{bound:.6f}", ms_1x2048=f"{ms_w:.4f}",
          plain_ms_1x2048=f"{plain_w:.4f}",
          bound_ms_1x2048=f"{bound_w:.6f}")
    return {
        "name": "waterfill_grants", "route": "cuda",
        "source": "src/repro_torch/csrc/waterfill.cu",
        "replaces": "src/repro/kernels/ponsim/kernel.py:86",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def _check_syncs(names, results):
    for name, res in zip(names, results):
        want = SYNC_TABLE[name]
        if not math.isfinite(res.sync_time) or abs(
                res.sync_time - want) > SYNC_TOL:
            raise SystemExit(f"sync {name}: {res.sync_time!r} != {want!r}")


def phase_main():
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import PONConfig, SweepSpec, simulate

    t0 = time.time()
    names, cases = fig2b_cases()
    spec = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=N_ONUS))
    k1.launches = 0
    k2.launches = 0
    t_run = time.time()
    results = simulate(spec, device="cuda")
    torch.cuda.synchronize()
    first = time.time() - t_run
    launches = {"traffic_sampler": k1.launches,
                "waterfill_grants": k2.launches}
    _check_syncs(names, results)
    if not all(launches.values()):
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")
    walls = []
    for _ in range(3):
        t_run = time.time()
        results = simulate(spec, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.time() - t_run)
        _check_syncs(names, results)
    _line("main", time.time() - t0, cases=len(cases),
          sync_match="16/16", warmup_s=f"{first:.3f}",
          wall_s_median=f"{statistics.median(walls):.3f}",
          walls=",".join(f"{w:.3f}" for w in walls),
          k1_launches=launches["traffic_sampler"],
          k2_launches=launches["waterfill_grants"])
    return launches


def phase_full_width():
    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import simulate

    t0 = time.time()
    spec = full_width_spec()
    k1.launches = 0
    k2.launches = 0
    res = simulate(spec, device="cuda")[0]
    torch.cuda.synchronize()
    wall = time.time() - t0
    if abs(res.sync_time - SYNC_2048) > SYNC_TOL:
        raise SystemExit(f"2048-ONU sync {res.sync_time!r} != "
                         f"{SYNC_2048!r}")
    _line("full_width", wall, n_onus=2048, sync=repr(res.sync_time),
          k1_launches=k1.launches, k2_launches=k2.launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_build()
    kernels = [phase_k1(), phase_k2()]
    launches = phase_main()
    phase_full_width()
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
