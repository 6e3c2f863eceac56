"""Where a round of the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_port_round.py [--out chiprun_out/profile.json]
    python3 scripts/profile_port_round.py --backend jit   # or numpy, both
    python3 scripts/profile_port_round.py --backend jit --root DIR

Runs the Fig. 2b operating point (12 clients, 128 ONUs, FCFS, load 0.8,
seed 1) once to warm up, then once under ``torch.profiler`` and reports:
wall time, polling cycles simulated, kernel launches and host reads of
device values per cycle and per phase, the device's busy share (summed
kernel time over wall time) and the kernels that take the most device
time. ``--backend numpy`` (the default) profiles the per-cycle loop,
``jit`` the fused phase (one kernel launch a phase), ``both`` the two
in one process, the per-cycle loop first. It also times one small
kernel launch and one host read of a device value in isolation, the
two costs the per-cycle loop is made of. The JSON summary (one object a
backend under ``"backends"``) is printed and written to ``--out``.

For ``jit`` it also splits the host's time by function: a run with
timers around the phase's host functions (tables, packing, launch, the
copy back; each inclusive, in ms and as a share of the wall), the
host-to-device and device-to-host copies a phase that the profiler saw,
the host ms (wall less the device's busy time), and a ``cProfile`` run's
functions of the port by cumulative time. ``--root`` profiles another
checkout's port (for example the parent commit unpacked with
``git archive`` into a git-ignored directory) with this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv[:-1]:
    SRC = os.path.join(os.path.abspath(
        sys.argv[sys.argv.index("--root") + 1]), "src")
else:
    SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

import cProfile  # noqa: E402
import pstats  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def op_point_spec():
    from repro_torch.core.slicing import ClientProfile
    from repro_torch.net import FLRoundWorkload, PONConfig, SweepCase, \
        SweepSpec

    t_uds = np.random.default_rng(42).uniform(1.0, 5.0, 128)
    clients = [ClientProfile(client_id=i, t_ud=float(t_uds[i]), t_dl=0.0,
                             m_ud_bits=26.416e6) for i in range(12)]
    wl = FLRoundWorkload(clients=clients, model_bits=26.416e6)
    case = SweepCase(workload=wl, load=0.8, policy="fcfs", seed=1)
    return SweepSpec(cases=(case,), pon=PONConfig(n_onus=128))


def _us_per(fn, n: int = 2000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile.json"))
    ap.add_argument("--backend", choices=("numpy", "jit", "both"),
                    default="numpy")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose src/ is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_round: no CUDA device", file=sys.stderr)
        return 1
    backends = (("numpy", "jit") if args.backend == "both"
                else (args.backend,))
    x = torch.zeros(16, device="cuda")
    summary = {
        "src": SRC,
        "device": torch.cuda.get_device_name(0),
        "smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "backends": [profile_backend(b) for b in backends],
        "launch_us": _us_per(lambda: x.add_(1.0)),
        "launch_and_host_read_us": _us_per(lambda: bool(x.add_(1.0).any())),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


def profile_backend(backend: str) -> dict:
    """Profile one run of the operating point on ``backend``."""
    import dataclasses

    from repro_torch.kernels.ponsim import kernel as k2
    from repro_torch.kernels.traffic import kernel as k1
    from repro_torch.net import engine, simulate

    spec = dataclasses.replace(op_point_spec(),
                               backend=None if backend == "numpy"
                               else backend)
    simulate(spec, device="cuda")                     # build + warm up
    cycles = 0
    phases = []
    push = engine._BgQueues.push
    launch = k2.launch_phase

    def counted_push(self, k, bits):
        nonlocal cycles
        cycles += 1
        return push(self, k, bits)

    def counted_launch(spec_, dyn):
        state = launch(spec_, dyn)
        phases.append(state["k_stop"])
        return state

    engine._BgQueues.push = counted_push
    k2.launch_phase = counted_launch
    k1.launches = k2.launches = k2.phase_launches = 0
    engine.phase_fallbacks = 0
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = simulate(spec, device="cuda")[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine._BgQueues.push = push
        k2.launch_phase = launch
    if backend == "jit":
        # each phase's last cycle is the latest case's stop
        cycles = sum(int(k.max()) for k in phases)
        n_phases = len(phases)
    else:
        n_phases = 2                     # the FCFS download and upload
    events = prof.key_averages()
    by_name = {e.key: e for e in events}

    def count(name):
        return by_name[name].count if name in by_name else 0

    # device-side events only (kernels and copies): an operator's own
    # row repeats the device time of the kernels it launched
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in events if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy_us = sum(t for t, _, _ in kernels)
    launches = count("cudaLaunchKernel")
    reads = count("aten::_local_scalar_dense")
    h2d = sum(e.count for e in events if e.device_type == DeviceType.CUDA
              and e.key.startswith("Memcpy HtoD"))
    d2h = sum(e.count for e in events if e.device_type == DeviceType.CUDA
              and e.key.startswith("Memcpy DtoH"))
    summary = {
        "backend": backend,
        "sync_time": res.sync_time,
        "wall_s_profiled": wall,
        "cycles": cycles,
        "phases": n_phases,
        "us_per_cycle_profiled": wall / cycles * 1e6,
        "kernel_launches": launches,
        "launches_per_cycle": launches / cycles,
        "launches_per_phase": launches / n_phases,
        "host_reads": reads,
        "host_reads_per_cycle": reads / cycles,
        "host_reads_per_phase": reads / n_phases,
        "h2d_copies": h2d,
        "d2h_copies": d2h,
        "h2d_copies_per_phase": h2d / n_phases,
        "d2h_copies_per_phase": d2h / n_phases,
        "device_busy_share_profiled": busy_us * 1e-6 / wall,
        "device_busy_us": busy_us,
        "k1_launches": k1.launches,
        "k2_launches": k2.launches,
        "phase_launches": k2.phase_launches,
        "phase_fallbacks": engine.phase_fallbacks,
        "top_device_us": [[name, t, n] for t, name, n in kernels[:10]],
    }
    t0 = time.perf_counter()
    simulate(spec, device="cuda")
    torch.cuda.synchronize()
    summary["wall_s_unprofiled"] = time.perf_counter() - t0
    summary["us_per_cycle_unprofiled"] = (summary["wall_s_unprofiled"]
                                          / cycles * 1e6)
    # the same device work over the wall time of the run without the
    # profiler's host overhead
    summary["device_busy_share_unprofiled"] = (
        busy_us * 1e-6 / summary["wall_s_unprofiled"])
    if backend == "jit":
        summary.update(host_split(spec, busy_us))
    return summary


# the phase's host functions, timed inclusive (module, name); a checkout
# that lacks one is timed without it
_TIMED = (("ops", "run_phase_device"), ("ops", "phase_inputs"),
          ("ops", "phase_tables"), ("ops", "_fast_tables"),
          ("ops", "_layout_tables"), ("ops", "_slot_tables"),
          ("ops", "pack"), ("kernel", "run_phase_cuda"),
          ("kernel", "launch_phase"))


def host_split(spec, busy_us: float) -> dict:
    """The jit round's host time by function: one run with timers around
    ``_TIMED``, then one under ``cProfile``."""
    from repro_torch.kernels.ponsim import kernel, ops
    from repro_torch.net import engine, simulate

    mods = {"ops": ops, "kernel": kernel}
    spent = {}
    saved = []

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ms, n = spent.get(name, (0.0, 0))
                spent[name] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
        return wrapper

    for mod, name in _TIMED:
        fn = getattr(mods[mod], name, None)
        if fn is not None:
            saved.append((mods[mod], name, fn))
            setattr(mods[mod], name, timed(f"{mod}.{name}", fn))
    saved.append((engine, "run_phase_device", engine.run_phase_device))
    engine.run_phase_device = ops.run_phase_device
    try:
        t0 = time.perf_counter()
        simulate(spec, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    prof = cProfile.Profile()
    prof.enable()
    simulate(spec, device="cuda")
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    port = []
    for (path, line, name), (_, _, tt, ct, _) in stats.stats.items():
        if "repro_torch" in path:
            port.append((ct, tt, f"{path.split('repro_torch')[-1]}:{line}"
                         f"({name})"))
    port.sort(reverse=True)
    return {
        "timed_wall_ms": wall * 1e3,
        "host_ms": wall * 1e3 - busy_us * 1e-3,
        "host_split_ms": {k: {"ms": ms, "calls": n,
                              "share_of_wall": ms / (wall * 1e3)}
                          for k, (ms, n) in spent.items()},
        "cprofile_top": [{"fn": f, "cum_ms": ct * 1e3, "self_ms": tt * 1e3}
                         for ct, tt, f in port[:15]],
    }


if __name__ == "__main__":
    sys.exit(main())
