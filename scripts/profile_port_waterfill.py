"""Where the waterfill kernel K2 spends its time on a CUDA card, by phase.

    python3 scripts/profile_port_waterfill.py [--out chiprun_out/profile_waterfill.json]

K2 (``src/repro_torch/csrc/waterfill.cu``) ranks a row by a bitonic sort,
forms the prefix serially on one warp, and scatters the grants. This
script compiles the source as it is and three variants with a phase cut
out (no sort; no serial prefix; neither), binds each through its C entry,
and times one row of N queues (every row hard, keys and backlogs drawn
from a seed) at the widths the engine and the card tests use: device
milliseconds a launch, 20 launches queued behind a sleep kernel between
CUDA events. The variants' grants are wrong; only their times count. The
difference between the full kernel and a variant is that phase's time.
The JSON summary is printed and written to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

WIDTHS = (128, 2048, 4096, 16_384, 20_000)
REPS = 20
# (text in the source, its replacement): each must occur exactly once
NO_SORT = (("const bool in_regs = n_pad >= 64;", "const bool in_regs = false;"),
           ("for (int k = in_regs ? 128 : 2; k <= n_pad; k <<= 1) {",
            "for (int k = in_regs ? 128 : 2; k <= 0; k <<= 1) {"))
NO_SCAN = (("if (tid < 32) {\n    const double c",
            "if (tid < 0) {\n    const double c"),)


def _variant(src: str, cuts) -> str:
    for old, new in cuts:
        if src.count(old) != 1:
            raise SystemExit(f"waterfill.cu changed: {old!r} not found once")
        src = src.replace(old, new)
    return src


def _build(variants: dict, out_dir: str) -> dict:
    from repro_torch import _cuda

    procs = []
    for name, text in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{out}")
        lib = ctypes.CDLL(so)
        p = ctypes.c_void_p
        lib.repro_waterfill_grants.argtypes = [p, p, p, p, p, ctypes.c_int,
                                               ctypes.c_int, p, p]
        lib.repro_waterfill_grants.restype = ctypes.c_int
        lib.repro_waterfill_scratch_bytes.argtypes = [ctypes.c_int]
        lib.repro_waterfill_scratch_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def _time_ms(lib, n: int, gen: torch.Generator) -> float:
    b = torch.rand((1, n), device="cuda", dtype=torch.float64,
                   generator=gen) * 1e5
    k = torch.rand((1, n), device="cuda", dtype=torch.float64, generator=gen)
    cap = b.sum(dim=1) * 0.5
    hard = torch.ones(1, dtype=torch.bool, device="cuda")
    grants = torch.empty_like(b)
    row_bytes = lib.repro_waterfill_scratch_bytes(n)
    scratch = (torch.empty(row_bytes, dtype=torch.uint8, device="cuda")
               if row_bytes > 0 else None)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.repro_waterfill_grants(
            b.data_ptr(), k.data_ptr(), cap.data_ptr(), hard.data_ptr(),
            grants.data_ptr(), 1, n,
            None if scratch is None else scratch.data_ptr(), stream)
        if rc:
            raise SystemExit(f"waterfill launch failed: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_waterfill.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_waterfill: no CUDA device", file=sys.stderr)
        return 1
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "waterfill.cu")) as f:
        src = f.read()
    variants = {"full": src, "no_sort": _variant(src, NO_SORT),
                "no_scan": _variant(src, NO_SCAN),
                "neither": _variant(src, NO_SORT + NO_SCAN)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(variants, tmp)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = {}
        for n in WIDTHS:
            ms = {name: _time_ms(lib, n, gen) for name, lib in libs.items()}
            rows[n] = {**ms, "sort_ms": ms["full"] - ms["no_sort"],
                       "scan_ms": ms["full"] - ms["no_scan"]}
    summary = {
        "device": torch.cuda.get_device_name(0),
        "smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "reps": REPS, "ms_by_width": rows,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
