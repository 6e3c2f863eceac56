"""Where a cycle of the fused phase kernel spends its time, on a CUDA card.

    python3 scripts/profile_port_phase.py [--out chiprun_out/profile_phase.json]

Builds a copy of this checkout's port under ``build/phase_variants/``
(git-ignored) whose kernel source defines ``REPRO_PHASE_SECTIONS``, and
times the fig2b-16 sweep's three phases (``chip_smoke.fig2b_cases``)
through the copy and through this checkout's own kernel, each in its own
process, in turns (copy, this, this, copy). In the copy the kernel's
``SECTION`` marks are ``clock64`` timers on each block's thread 0: they
split each loop iteration into its steps, and each block prints
(``printf``) the cycles an iteration of each; the script reports the
block that ran the most cycles of each phase (the one that sets the
phase's time), the most costly of them. Thread 0 owns queues, not the
rows: a wait for the rows' warp shows in the section after the barrier
it waits at, since a clock read may issue before the barrier resolves.
The timers add to the kernel's time, which the turns measure.

Each timing is ``chip_smoke._device_ms`` of one launch. Exits 1 without
a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = os.path.join("src", "repro_torch", "csrc", "ponsim_phase.cu")


def _copy() -> str:
    """This checkout's port and chip_smoke.py under build/, the kernel
    built with its section timers."""
    dst = os.path.join(ROOT, "build", "phase_variants", "sections")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, KERNEL)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write("#define REPRO_PHASE_SECTIONS\n" + src)
    return dst


def time_phases(root: str) -> None:
    """(In a child process) time the fig2b-16 phases through ``root``'s
    port; print one JSON line."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    from repro_torch.kernels.ponsim import kernel, ops
    from repro_torch.net import PONConfig, SweepSpec

    _, cases = cs.fig2b_cases()
    spec = SweepSpec(cases=tuple(cases), pon=PONConfig(n_onus=cs.N_ONUS),
                     backend="jit")
    out = []
    for args, kw in cs._record_phases(spec, "cuda"):
        sc, tc = ops.phase_inputs(*args, **kw, use_k2=True, device="cuda")
        cycles = int(kernel.launch_phase(sc, tc)["k_stop"].max())
        ms = cs._device_ms(kernel.launch_phase, [(sc, tc)], reps=3)
        out.append({"mode": sc.mode, "ms": ms, "cycles": cycles,
                    "us_per_cycle": ms * 1e3 / cycles})
    print("PHASES " + json.dumps(out), flush=True)


def _run(root: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--time", root],
        capture_output=True, text=True, check=True)
    lines = proc.stdout.splitlines()
    phases = json.loads(next(ln for ln in lines
                             if ln.startswith("PHASES "))[7:])
    # each phase's slowest block: one that ran the phase's cycles, the
    # most costly of those
    fields = [(dict(w.split("=") for w in ln.split()[1:5]), ln)
              for ln in lines if ln.startswith("sections")]
    sections = []
    for p in phases:
        fcfs = str(int(p["mode"] == "fcfs"))
        hits = [(float(f["total"]), ln) for f, ln in fields
                if f["fcfs"] == fcfs and int(f["k"]) == p["cycles"]]
        sections.append(max(hits)[1] if hits else None)
    return {"root": os.path.relpath(root, ROOT), "phases": phases,
            "sections": sections}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_phase.json"))
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_port_phase: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        time_phases(args.time)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    copy = _copy()
    runs = [_run(r) for r in (copy, ROOT, ROOT, copy)]
    summary = {"smi": smi, "runs": runs}
    for run in runs:
        print(run["root"], " ".join(
            f"{p['mode']}:{p['ms']:.4f}ms/{p['cycles']}="
            f"{p['us_per_cycle']:.3f}us" for p in run["phases"]),
            flush=True)
        for line in run["sections"]:
            if line:
                print("  " + line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
