"""Where serving on the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_port_serve.py [--out chiprun_out/profile_serve.json]
        [--arch olmo-1b|mamba2-780m|recurrentgemma-2b]

A full-width model (olmo-1b by default: 16 layers; mamba2-780m: 48 SSD
layers; recurrentgemma-2b: 18 RG-LRU and 8 local-attention layers;
float32 parameters, bfloat16 compute, random weights from seed 0),
batch 4, 2048-token prompts (seed 1): one prefill and 8 greedy decode
steps to warm up, then the same unprofiled (host clock around work that
ends in a synchronise) and under ``torch.profiler``. For the prefill and
the decode steps apart it reports the wall time, the device's busy
share (summed kernel time over the unprofiled wall), the device time of
the flash-attention kernel K4 (and of it, the tensor-core kernel's), the
SSD scan K5 (and of it, each of the tensor-core route's three kernels:
chunk states, state passing, chunk outputs), the RG-LRU scan K6, the matrix products (cuBLAS
kernel names: gemm, gemv, xmma, cutlass, nvjet), split into float32
ones (sgemm, f32f32, simt) and the rest, of copies and casts (``copy``
in the name), of the rest, and the kernels
that take the most device time. Where the model has RG-LRU layers it
also times one float32 gate product ((B·S, R) @ (R, R), CUDA events)
and scales it to the prefill's 2 a layer. The JSON summary is printed
and written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

BATCH, PROMPT, DECODE_STEPS = 4, 2048, 8
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass", "nvjet")
F32_GEMM_MARKS = ("sgemm", "f32f32", "simt")


def _prefill(cfg, params, prompts):
    """Returns (logits, cache, seconds) of one prefill."""
    from repro_torch.dist import stepfns
    from repro_torch.models import lm

    cache = lm.init_cache(cfg, BATCH, PROMPT + DECODE_STEPS + 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = stepfns.make_prefill_step(cfg)(params, prompts, cache)
    torch.cuda.synchronize()
    return logits, cache, time.perf_counter() - t0


def _decode(cfg, params, logits, cache) -> float:
    """Seconds of ``DECODE_STEPS`` greedy decode steps."""
    from repro_torch.dist import stepfns

    decode = stepfns.make_decode_step(cfg)
    tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, cache = decode(params, tok, cache)
        tok = logits[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _breakdown(events, wall_s: float) -> dict:
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in events if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy = sum(t for t, _, _ in kernels)
    def total(pick):
        return sum(t for t, name, _ in kernels if pick(name.lower()))

    k4 = total(lambda n: "flash_fwd_kernel" in n)
    k4_tc = total(lambda n: "flash_fwd_kernel_tc" in n)
    k5_phases = {phase: total(lambda n, k=kernel: k in n) for phase, kernel
                 in (("states", "ssd_chunk_states"),
                     ("pass", "ssd_state_pass"),
                     ("outputs", "ssd_chunk_outputs"))}
    k5 = total(lambda n: "ssd_scan_kernel" in n) + sum(k5_phases.values())
    k6 = total(lambda n: "rglru_chunked_scan_kernel" in n)
    gemm = total(lambda n: any(m in n for m in GEMM_MARKS))
    gemm_f32 = total(lambda n: any(m in n for m in GEMM_MARKS)
                     and any(m in n for m in F32_GEMM_MARKS))
    copy = total(lambda n: "copy" in n and not any(m in n for m in
                                                   GEMM_MARKS))
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy * 1e-6 / wall_s,
        "k4_ms": k4 / 1e3,
        "k4_tensor_core_ms": k4_tc / 1e3,
        "k5_ms": k5 / 1e3,
        **{f"k5_tensor_core_{phase}_ms": v / 1e3
           for phase, v in k5_phases.items()},
        "k6_ms": k6 / 1e3,
        "gemm_ms": gemm / 1e3,
        "gemm_f32_ms": gemm_f32 / 1e3,
        "copy_ms": copy / 1e3,
        "other_ms": (busy - k4 - k5 - k6 - gemm - copy) / 1e3,
        "top_device_us": [[name[:120], t, n] for t, name, n in kernels[:15]],
    }


def _gate_products_ms(cfg) -> float | None:
    """CUDA-event time of one float32 gate product at the prefill's
    shape, times the prefill's count (2 a RG-LRU layer); None without
    RG-LRU layers."""
    from repro_torch.configs import RGLRU

    layers = list(cfg.pattern) * cfg.n_units + list(cfg.remainder_pattern)
    n_rec = sum(s.kind == RGLRU for s in layers)
    if not n_rec:
        return None
    R = cfg.recurrent.rnn_width
    u = torch.randn((BATCH * PROMPT, R), device="cuda")
    w = torch.randn((R, R), device="cuda")
    u @ w
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        u @ w
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10 * 2 * n_rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_serve.json"))
    ap.add_argument("--arch", default="olmo-1b",
                    help="olmo-1b (K4 in the prefill), mamba2-780m (K5) or "
                    "recurrentgemma-2b (K6 and K4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_serve: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(args.arch)
    with torch.inference_mode():
        params = lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.randint(
            0, cfg.vocab_size, (BATCH, PROMPT), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(1))
        _decode(cfg, params, *_prefill(cfg, params, prompts)[:2])  # warm up
        summary = {
            "device": torch.cuda.get_device_name(0),
            "smi": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(),
            "arch": args.arch, "batch": BATCH, "prompt": PROMPT,
            "decode_steps": DECODE_STEPS,
        }
        logits, cache, wall = _prefill(cfg, params, prompts)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _prefill(cfg, params, prompts)
        summary["prefill"] = _breakdown(prof.key_averages(), wall)
        wall = _decode(cfg, params, logits, cache)
        logits, cache, _ = _prefill(cfg, params, prompts)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _decode(cfg, params, logits, cache)
        summary["decode"] = _breakdown(prof.key_averages(), wall)
        summary["prefill"]["gate_gemm_f32_ms_timed"] = _gate_products_ms(cfg)
    summary["decode_ms_per_step"] = (summary["decode"]["wall_ms"]
                                     / DECODE_STEPS)
    summary["decode_tok_s"] = BATCH * DECODE_STEPS / (
        summary["decode"]["wall_ms"] / 1e3)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
