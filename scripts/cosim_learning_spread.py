"""Spread of the co-simulation's learning on the card against its CPU run.

    python3 scripts/cosim_learning_spread.py [--seeds N] [--repeats N]

Runs ``chip_smoke.py``'s ``cosim`` co-simulation (every mode of
``COSIM_MODES``: 8 clients x 64 samples, LEAF CNN, int8 updates, BS at
load 0.8, 4 rounds, the network through ``backend="jit"`` on the card)
from ``--seeds`` initial weights (CNN seeds 0, 1, ...). For each seed:
once on the CPU (worker processes, beside the card runs), and on the
card ``--repeats`` times on cuDNN's default algorithms (its weight
gradients summed by atomics, in another order each run), twice on its
deterministic algorithms, and once with the clients' and the
aggregation's float32 products and convolutions in TF32 (the
lower-precision control, which the learning gate should tell apart).

Each reading is a mode's largest gap to the CPU run of its seed over the
rounds: accuracy (absolute) and mean loss (relative to the CPU's), the
two quantities ``chip_smoke.py``'s ``FL_REF_GAP`` bounds. Prints, for
each mode and variant, the largest and smallest reading over seeds and
repeats; writes every reading to ``chiprun_out/cosim_spread.json``.
Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def _setup(device: str, seed: int):
    """The co-sim's clients, test batch and the CNN's initial weights
    from ``seed`` (made on the card, as the smoke makes them, then moved
    to ``device``)."""
    from repro_torch import fl
    from repro_torch._tree import tree_map
    from repro_torch.data import build_federated_cnn_clients
    from repro_torch.models import cnn

    clients, test = build_federated_cnn_clients(
        n_clients=smoke.COSIM_CLIENTS,
        samples_per_client=smoke.COSIM_SAMPLES, loss_fn=cnn.loss_fn,
        train_cfg=fl.LocalTrainConfig(lr=smoke.COSIM_LR,
                                      batch_size=smoke.COSIM_BATCH,
                                      local_epochs=smoke.COSIM_EPOCHS),
        seed=smoke.COSIM_DATA_SEED)
    test_batch = {k: v[:smoke.COSIM_TEST] for k, v in test.items()}
    params = cnn.init_params(torch.Generator(device="cuda").manual_seed(seed))
    return clients, test_batch, tree_map(lambda t: t.to(device), params)


def _curves(runs) -> dict:
    """mode -> per-round (accuracy, mean loss, arrivals)."""
    return {mode: [(r["eval_metric"], r["mean_loss"], r["n_arrived"])
                   for r in res.rounds] for mode, (res, _) in runs.items()}


def _cpu_curves(seed: int, threads: int) -> dict:
    """The co-sim on the CPU from ``seed``'s weights (a worker process)."""
    torch.set_num_threads(threads)
    clients, test_batch, params = _setup("cpu", seed)
    return _curves(smoke._cosim_runs("cpu", clients, test_batch, params,
                                     contextlib.nullcontext()))


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic convolution algorithms inside the block."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def _variant(name: str):
    """The card's training set up as variant ``name``."""
    from repro_torch.fl import aggregation, client

    if name == "default":
        yield
    elif name == "deterministic":
        with _cudnn_deterministic():
            yield
    elif name == "tf32":
        with mock.patch.object(client, "full_float32", smoke._tf32_on), \
                mock.patch.object(aggregation, "full_float32",
                                  smoke._tf32_on):
            yield
    else:
        raise ValueError(name)


def _gaps(card: dict, cpu: dict) -> dict:
    """mode -> (largest accuracy gap, largest relative loss gap); the
    arrivals must agree round by round."""
    out = {}
    for mode, rounds in card.items():
        want = cpu[mode]
        if [r[2] for r in rounds] != [r[2] for r in want]:
            raise SystemExit(f"{mode}: arrivals {rounds} != {want}")
        out[mode] = (max(abs(a[0] - b[0]) for a, b in zip(rounds, want)),
                     max(abs(a[1] - b[1]) / abs(b[1])
                         for a, b in zip(rounds, want)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cosim_learning_spread: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.time()
    print(smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
    smoke.phase_build()
    seeds = list(range(args.seeds))
    cores = len(os.sched_getaffinity(0))
    threads = max(1, (cores - 1) // len(seeds))
    pool = ProcessPoolExecutor(
        len(seeds), mp_context=multiprocessing.get_context("spawn"))
    cpu_runs = {s: pool.submit(_cpu_curves, s, threads) for s in seeds}
    variants = (["default"] * args.repeats + ["deterministic"] * 2
                + ["tf32"])
    card = []
    for seed in seeds:
        clients, test_batch, params = _setup("cuda", seed)
        for name in variants:
            with _variant(name):
                runs = smoke._cosim_runs("cuda", clients, test_batch, params,
                                         contextlib.nullcontext(),
                                         backend="jit")
            card.append((seed, name, _curves(runs)))
        print(f"[card] seed {seed} done at {time.time() - t0:.1f}s",
              flush=True)
    cpu = {s: f.result() for s, f in cpu_runs.items()}
    pool.shutdown()
    readings = [{"seed": seed, "variant": name, "mode": mode,
                 "acc_gap": acc, "loss_rel_gap": loss}
                for seed, name, curves in card
                for mode, (acc, loss) in _gaps(curves, cpu[seed]).items()]
    for mode in smoke.COSIM_MODES:
        for name in dict.fromkeys(variants):
            rs = [r for r in readings
                  if r["mode"] == mode and r["variant"] == name]
            acc = [r["acc_gap"] for r in rs]
            loss = [r["loss_rel_gap"] for r in rs]
            print(f"  {mode} {name}: {len(rs)} runs; acc gap "
                  f"{min(acc):.4f}-{max(acc):.4f}; loss gap "
                  f"{min(loss):.4f}-{max(loss):.4f}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "cosim_spread.json"),
              "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "readings": readings,
                   "cpu": {str(s): c for s, c in cpu.items()},
                   "card": [{"seed": s, "variant": n, "curves": c}
                            for s, n, c in card]}, f, indent=1)
    print(f"[cosim_learning_spread] {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
