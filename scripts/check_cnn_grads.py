"""How far the LEAF CNN's gradients on a CUDA card stand from exact.

    python3 scripts/check_cnn_grads.py

One batch of 16 (the first of client 0 in ``benchmarks/fig2a_accuracy.py``'s
data, seed 0) through the port's CNN at width 1 (torch seed 0): the loss
and each parameter's gradient on the card in full float32 (TF32 off), with
cuDNN's default algorithms, with ``cudnn.deterministic`` and with cuDNN
off, and, as the control of what TF32 would do, with TF32 on for cuDNN's
convolutions and cuBLAS's products; each against the port's float32 run
on the CPU and its float64 run on the CPU, as the largest difference
over the leaf's largest value. The CPU float32 run is held to the
float64 one too. Prints one line a setting, the card's name and power
limit first.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

NAMES = ("conv1/b", "conv1/w", "conv2/b", "conv2/w", "fc1/b", "fc1/w",
         "fc2/b", "fc2/w")


@contextlib.contextmanager
def _tf32_on():
    """TF32 for cuDNN's convolutions and cuBLAS's products."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _grads(params, batch, precision=None):
    """(loss, gradients in tree order) as a client step computes them, in
    full float32 (or under the ``precision`` context)."""
    from repro_torch._device import full_float32
    from repro_torch._tree import tree_leaves, tree_unflatten
    from repro_torch.models import cnn

    live = [p.detach().clone().requires_grad_(True)
            for p in tree_leaves(params)]
    with (precision or full_float32)():
        loss = cnn.loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.item(), [g.detach().cpu().double() for g in grads]


def _rel(got, want) -> str:
    return " ".join(
        f"{n}={float((g - w).abs().max() / w.abs().max()):.3g}"
        for n, g, w in zip(NAMES, got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("check_cnn_grads: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch._tree import tree_map
    from repro_torch.data import build_federated_cnn_clients
    from repro_torch.fl import LocalTrainConfig
    from repro_torch.models import cnn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    clients, _ = build_federated_cnn_clients(
        16, 64, cnn.loss_fn, LocalTrainConfig(lr=0.04, batch_size=16,
                                              local_epochs=2), seed=0)
    batch = {k: v[:16] for k, v in clients[0].data.items()}
    params = cnn.init_params(torch.Generator(device="cuda").manual_seed(0))
    loss32, cpu32 = _grads(tree_map(lambda t: t.cpu(), params), batch)
    loss64, cpu64 = _grads(
        tree_map(lambda t: t.cpu().double(), params),
        {"images": batch["images"].astype("float64"),
         "labels": batch["labels"]})
    print(f"cpu float32 vs float64: loss {loss32:.9g} vs {loss64:.9g}; "
          f"{_rel(cpu32, cpu64)}")
    settings = (("cudnn default", True, False, None),
                ("cudnn deterministic", True, True, None),
                ("cudnn off", False, False, None),
                ("tf32 on", True, False, _tf32_on))
    saved = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic)
    try:
        for label, enabled, deterministic, precision in settings:
            torch.backends.cudnn.enabled = enabled
            torch.backends.cudnn.deterministic = deterministic
            loss, card = _grads(params, batch, precision)
            print(f"{label}: loss {loss:.9g}; vs cpu float32 "
                  f"{_rel(card, cpu32)}; vs cpu float64 {_rel(card, cpu64)}")
    finally:
        (torch.backends.cudnn.enabled,
         torch.backends.cudnn.deterministic) = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
