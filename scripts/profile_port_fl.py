"""Where a Fig. 2a FL round on the PyTorch port spends its time on a CUDA card.

    python3 scripts/profile_port_fl.py [--out chiprun_out/profile_fl.json]

``benchmarks/fig2a_accuracy.py``'s setting at full involvement: 16
clients x 64 samples (data seed 0), local SGD at lr 0.04, batch 16, 2
epochs, the LEAF CNN at width 1 from torch seed 0, int8 update
compression with error feedback, FedAvg, server seed 1. One round warms
up; the next runs unprofiled (host clock around work that ends in a
synchronise) and the one after under ``torch.profiler``. It reports the
round's wall time, the device's busy share (summed kernel time over the
unprofiled wall), the device time of K3 and K3' (int8 quantise and
dequantise) and their share, their device time a launch on the fc1
weight inside the round (the largest leaf: of K3's large-block kernel
and of K3' the round's longest launches, one an arrived update), the
device time of the convolutions (cuDNN), the matrix products (cuBLAS)
and the rest, the kernels that take the most device time, the kernel
launches, and the host syncs: the device-to-host
reads (``aten::item``, from ``float(loss)`` a step and the round's
accuracy) with their count and host time. It also times one client's
local training, one update's compression and the FedAvg of 16 updates
alone (host clock, synchronised). The JSON summary is printed and
written to ``--out``.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

N_CLIENTS, SAMPLES, TEST = 16, 64, 512
K3_MARKS = ("quant_tile_kernel", "quant_grid_kernel")
K3P_MARK = "dequant_kernel"
CONV_MARKS = ("conv", "cudnn", "winograd", "fft", "fprop", "dgrad",
              "wgrad")
GEMM_MARKS = ("gemm", "gemv", "xmma", "cutlass", "nvjet")


def _timed(fn) -> float:
    """Host milliseconds of ``fn`` between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _breakdown(events, wall_ms: float) -> dict:
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in events if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy = sum(t for t, _, _ in kernels)

    def total(pick):
        return sum(t for t, name, _ in kernels if pick(name.lower()))

    def count(pick):
        return sum(n for _, name, n in kernels if pick(name.lower()))

    def is_k3(n):
        return any(m in n for m in K3_MARKS)

    def is_k3p(n):
        return K3P_MARK in n

    def is_conv(n):
        return any(m in n for m in CONV_MARKS) and not (is_k3(n)
                                                        or is_k3p(n))

    def is_gemm(n):
        return any(m in n for m in GEMM_MARKS) and not is_conv(n)

    k3, k3p = total(is_k3), total(is_k3p)
    conv, gemm = total(is_conv), total(is_gemm)
    syncs = [e for e in events if e.key in ("aten::item",
                                            "aten::_local_scalar_dense")]
    item = next((e for e in syncs if e.key == "aten::item"), None)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / 1e3 / wall_ms,
        "device_launches": sum(n for _, _, n in kernels),
        "k3_ms": k3 / 1e3,
        "k3_launches": count(is_k3),
        "k3_prime_ms": k3p / 1e3,
        "k3_prime_launches": count(is_k3p),
        "k3_share_of_device": (k3 + k3p) / max(busy, 1e-9),
        "conv_ms": conv / 1e3,
        "gemm_ms": gemm / 1e3,
        "other_ms": (busy - k3 - k3p - conv - gemm) / 1e3,
        "host_syncs": item.count if item else 0,
        "host_sync_ms": (item.cpu_time_total / 1e3) if item else 0.0,
        "top_device_us": [[name[:120], t, n] for t, name, n in kernels[:15]],
    }


def _fc1_launch_us(prof, n_arrived: int) -> dict:
    """Median device microseconds of K3 (its large-block kernel, one
    launch a leaf) and K3' on the fc1 weight in the profiled round: of
    each kernel the ``n_arrived`` longest launches, one an arrived
    update's fc1."""
    def longest(mark):
        times = sorted((e.device_time_total for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and mark in e.name), reverse=True)[:n_arrived]
        return float(np.median(times)) if times else float("nan")

    return {"k3_fc1_us": longest("quant_grid_kernel"),
            "k3_prime_fc1_us": longest(K3P_MARK)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_fl.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_fl: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import fl
    from repro_torch._tree import tree_map
    from repro_torch.data import build_federated_cnn_clients
    from repro_torch.models import cnn

    clients, test = build_federated_cnn_clients(
        n_clients=N_CLIENTS, samples_per_client=SAMPLES, loss_fn=cnn.loss_fn,
        train_cfg=fl.LocalTrainConfig(lr=0.04, batch_size=16,
                                      local_epochs=2), seed=0)
    test_batch = {k: v[:TEST] for k, v in test.items()}
    params = cnn.init_params(torch.Generator(device="cuda").manual_seed(0))
    server = fl.CPSServer(
        global_params=params, clients=clients,
        selection=fl.SelectionConfig(strategy="fraction", fraction=1.0),
        compression=fl.CompressorConfig(scheme="int8"), seed=1)

    def round_():
        return server.run_round(
            eval_fn=lambda p: cnn.accuracy(p, test_batch))

    summary = {
        "device": torch.cuda.get_device_name(0),
        "smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "clients": N_CLIENTS, "fraction": 1.0, "scheme": "int8",
    }
    round_()                                          # warm-up
    wall = _timed(round_)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        log = round_()
        torch.cuda.synchronize()
    summary["round"] = _breakdown(prof.key_averages(), wall)
    summary["round"]["n_arrived"] = log.n_arrived
    summary["round"].update(_fc1_launch_us(prof, log.n_arrived))
    summary["round"]["sgd_steps"] = log.n_arrived * 2 * (SAMPLES // 16)

    # the stages alone, from the current global model
    g = server.global_params
    rng = np.random.default_rng(5)
    local = {}
    summary["client_train_ms"] = _timed(
        lambda: local.update(p=clients[0].train(g, rng)[0]))
    delta = tree_map(lambda a, b: a - b, local["p"], g)
    summary["compress_ms"] = _timed(lambda: fl.compress_delta(
        delta, server.compression, fl.init_error_state(delta)))
    arrived = [tree_map(lambda a, d: a + d, g, delta)] * N_CLIENTS
    summary["fedavg_ms"] = _timed(
        lambda: fl.fedavg(arrived, [c.n_samples for c in clients]))
    summary["eval_ms"] = _timed(lambda: float(cnn.accuracy(g, test_batch)))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
