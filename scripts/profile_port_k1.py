"""K1, the Poisson-burst traffic sampler, on a CUDA card: its device
operations a call and its time beside its bound.

    python3 scripts/profile_port_k1.py [--root DIR] [--out chiprun_out/profile_k1.json]

Imports ``chip_smoke`` from ``--root`` (by default this checkout), so
that another checkout (a parent commit unpacked with ``git archive``
into a git-ignored directory) is measured by the same code: run the two
in one call, in turns, to compare them on one card. At the two shapes
the main path gives the sampler (the Fig. 2b engine's 8 FCFS rows × a
1,024-cycle chunk × 128 ONUs, and the 2048-ONU round's row × 1,024 ×
2048) it

* records ``sample_arrival_bits_cuda`` under ``torch.profiler`` over
  ``CALLS`` calls and lists every device operation (memset, kernel) by
  name with its launches and device microseconds a call;
* times a call with ``chip_smoke._device_ms`` (calls queued back to back
  behind a sleep kernel, between CUDA events);
* computes the bound as ``chip_smoke.phase_k1`` does: the larger of the
  bytes (keys, thresholds and the breakpoint table read once, the
  float64 output written once) over 3.35 TB/s and 120 ALU operations a
  threefry draw (one a cell, one a live burst) over 67 T operations/s;
* where the checkout's kernel is tiled on the host (``_launch_plan``),
  times it again under other tile-count targets (``--targets``), each
  with the ONU span, windows a tile and tiles it gives, and times
  variants of ``csrc/traffic.cu`` (``CUTS``), each compiled on its own
  and launched through the same wrapper: the breakpoint table read from
  global memory in place of its staged copy (the same bits); and with a
  part cut out: the bursts' lengths looked up; the bursts; the float64
  write; bursts and write, and from that floor in turn the breakpoint
  table's staging, draw 0, the thresholds' staging and the tile's
  zeroing, down to a launch whose CTAs scan and exit. A cut variant's
  bits are wrong; only its time counts: the full kernel's time less a
  variant's is that part's.

The JSON summary is printed and written to ``--out``. Exits 1 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20
PKT = 12_000.0
# (text in csrc/traffic.cu, its replacement): each must occur exactly once
_NO_LENGTH = (("burst_length_walk(static_cast<int32_t>(x1 >> 8), s_start, s_len, n_bp)",
               "static_cast<int32_t>(x1 & 1)"),)
_NO_BP = (("for (int i = tid; i < n_bp; i += kThreads) {",
           "for (int i = tid; i < 0; i += kThreads) {"),)
_NO_DRAW0 = (("if (tid < n_cells) {", "if (tid < 0) {"),
             ("tid < n_cells ? burst_count_of", "tid < 0 ? burst_count_of"))
_NO_STAGE = (("for (int i = tid; i < n_draws; i += kThreads)",
              "for (int i = tid; i < 0; i += kThreads)"),)
_NO_ZERO = (("for (int i = tid; i < (n_words >> 2); i += kThreads)",
             "for (int i = tid; i < 0; i += kThreads)"),)
_NO_BURSTS = (("for (int n = tid; n < total; n += kThreads) {",
               "for (int n = tid; n < 0; n += kThreads) {"),)
_NO_WRITE = (("for (; e < n_el; e += step) {", "for (; e < 0; e += step) {"),
             ("for (; e < n_el; e += kThreads) {",
              "for (; e < 0; e += kThreads) {"))
# the breakpoint table read from global memory (through L1) in place of its
# shared-memory copy: the same bits, no staging
_BP_GLOBAL = _NO_BP + (
    ("burst_length_walk(static_cast<int32_t>(x1 >> 8), s_start, s_len, n_bp)",
     "burst_length_walk(static_cast<int32_t>(x1 >> 8), bp_start, bp_len, n_bp)"),)
_FLOOR = _NO_BURSTS + _NO_WRITE
CUTS = {"bp_global": _BP_GLOBAL, "no_length": _NO_LENGTH, "no_bursts": _NO_BURSTS,
        "no_write": _NO_WRITE, "no_bursts_no_write": _FLOOR,
        "floor_no_bp": _FLOOR + _NO_BP,
        "floor_no_draw0": _FLOOR + _NO_BP + _NO_DRAW0,
        "floor_no_tables": _FLOOR + _NO_BP + _NO_DRAW0 + _NO_STAGE,
        "empty": _FLOOR + _NO_BP + _NO_DRAW0 + _NO_STAGE + _NO_ZERO}


def _profile(fn) -> dict:
    """Device operations of ``CALLS`` calls of ``fn`` by name: launches
    and device microseconds a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return {e.key: {"per_call": e.count / CALLS,
                    "us_per_call": e.self_device_time_total / CALLS}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _shape(smoke, kernel, ref, keys, lam, n_cycles: int,
           n_onus: int) -> dict:
    dev = torch.device("cuda")
    kt, thr, st, ln = smoke._k1_inputs(keys, lam, dev)
    args = (kt, 0, thr, st, ln, PKT)
    kw = dict(n_cycles=n_cycles, n_onus=n_onus)

    def call():
        return kernel.sample_arrival_bits_cuda(*args, **kw)

    ops = _profile(call)
    ms = smoke._device_ms(call, [()])
    B = kt.shape[0]
    cells = B * ref._windows(0, n_cycles)[1] * n_onus
    bursts = int(ref.window_counts(kt, 0, n_cycles, n_onus, thr).sum())
    n_bytes = (kt.numel() * 8 + thr.numel() * 4 + st.numel() * 8
               + B * n_cycles * n_onus * 8)
    n_ops = smoke.THREEFRY_OPS * (cells + bursts)
    bytes_ms = n_bytes / smoke.HBM_BYTES_S * 1e3
    ops_ms = n_ops / smoke.OPS32_S * 1e3
    return {
        "shape": [B, n_cycles, n_onus], "n_draws": thr.shape[1],
        "bursts": bursts, "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "device_ops_per_call": sum(o["per_call"] for o in ops.values()),
        "device_us_per_call": sum(o["us_per_call"] for o in ops.values()),
        "ops": ops,
    }


def _sweep(smoke, kernel, shapes, targets) -> list:
    """Device ms at each shape under each ``_TARGET_TILES`` in
    ``targets``, with the plan it gives."""
    dev = torch.device("cuda")
    rows = []
    default = kernel._TARGET_TILES
    try:
        for target in targets:
            kernel._TARGET_TILES = target
            for keys, lam, n_cycles, n_onus in shapes:
                kt, thr, st, ln = smoke._k1_inputs(keys, lam, dev)
                plan = kernel._launch_plan(kt.shape[0], 0, n_cycles,
                                           n_onus, thr.shape[1],
                                           st.shape[0])
                ms = smoke._device_ms(
                    lambda: kernel.sample_arrival_bits_cuda(
                        kt, 0, thr, st, ln, PKT, n_cycles=n_cycles,
                        n_onus=n_onus), [()])
                rows.append({"target": target,
                             "shape": [kt.shape[0], n_cycles, n_onus],
                             "span": plan.span, "wpt": plan.wpt,
                             "tiles": plan.n_tiles, "ms": ms})
    finally:
        kernel._TARGET_TILES = default
    return rows


def _variants(cuda_mod, out_dir: str) -> dict:
    """Each of ``CUTS`` applied to this checkout's ``traffic.cu``, built
    by its own nvcc into a library bound like the port's."""
    src_path = cuda_mod.CSRC / "traffic.cu"
    src = src_path.read_text()
    procs = []
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"traffic.cu changed: {old!r} not found once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_mod._nvcc(), *cuda_mod.NVCC_FLAGS, f"-I{cuda_mod.CSRC}",
               "-shared", "-o", so, cu]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    main = cuda_mod.library()
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{out}")
        lib = ctypes.CDLL(so)
        for fn in ("repro_traffic_sample", "repro_cuda_error_string"):
            getattr(lib, fn).argtypes = getattr(main, fn).argtypes
            getattr(lib, fn).restype = getattr(main, fn).restype
        libs[name] = lib
    return libs


def _cut_times(smoke, cuda_mod, kernel, shapes) -> list:
    """Device ms of the full kernel and of each variant at each shape,
    in turns (full first and last)."""
    dev = torch.device("cuda")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"full": cuda_mod.library(), **_variants(cuda_mod, tmp)}
        order = list(libs) + ["full"]
        main = cuda_mod._lib
        try:
            for keys, lam, n_cycles, n_onus in shapes:
                kt, thr, st, ln = smoke._k1_inputs(keys, lam, dev)
                row = {"shape": [kt.shape[0], n_cycles, n_onus]}
                for name in order:
                    cuda_mod._lib = libs[name]
                    ms = smoke._device_ms(
                        lambda: kernel.sample_arrival_bits_cuda(
                            kt, 0, thr, st, ln, PKT, n_cycles=n_cycles,
                            n_onus=n_onus), [()])
                    row.setdefault(name, []).append(ms)
                rows.append(row)
        finally:
            cuda_mod._lib = main
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_k1.json"))
    ap.add_argument("--targets", default="264,528,1056,2112",
                    help="tile-count targets to time (comma-separated)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_k1: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    smoke = importlib.import_module("chip_smoke")
    from repro_torch import _cuda
    from repro_torch.kernels.traffic import kernel, ref
    from repro_torch.net import PONConfig

    _cuda.library()
    _, cases = smoke.fig2b_cases()
    k8, l8 = smoke._engine_streams(smoke.N_ONUS, cases,
                                   PONConfig(n_onus=smoke.N_ONUS))
    spec = smoke.full_width_spec()
    kw, lw = smoke._engine_streams(2048, spec.cases, spec.pon)
    summary = {
        "root": os.path.abspath(args.root),
        "device": torch.cuda.get_device_name(0),
        "smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "calls_profiled": CALLS,
        "shapes": [_shape(smoke, kernel, ref, k8, l8, 1024, smoke.N_ONUS),
                   _shape(smoke, kernel, ref, kw, lw, 1024, 2048)],
    }
    if hasattr(kernel, "_launch_plan"):
        summary["target_sweep"] = _sweep(
            smoke, kernel,
            [(k8, l8, 1024, smoke.N_ONUS), (kw, lw, 1024, 2048)],
            [int(x) for x in args.targets.split(",")])
        summary["cuts_ms"] = _cut_times(
            smoke, _cuda, kernel,
            [(k8, l8, 1024, smoke.N_ONUS), (kw, lw, 1024, 2048)])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
