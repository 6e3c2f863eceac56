"""Each rank's bytes in a FedAvg round at the 2x16x16 production mesh.

    python scripts/dryrun_fed_round.py [--arch NAME ...] [--compress none int8]
        [--out FILE.jsonl]

Traces ``dist/stepfns.py::make_fed_round_step`` (the cross-pod FedAvg
whose upload the paper's BS slice is sized for) for each config at its
published widths, uncompressed and through the int8 wire round trip (K3
and K3' one launch a stacked leaf), with ``launch/dryrun.py::trace_step``
on fake ``cuda`` tensors, one rank of a fake 512-rank process group, and
prints one line a (config, scheme): the rank's argument bytes (its part
of the pod-stacked state), the peak of the bytes the round's operators
hold at once, the collective bytes by kind and the kernel operators.
Runs on the CPU, with no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, list_architectures  # noqa: E402
from repro_torch.dist import stepfns  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.optim.optimizers import OptimizerConfig  # noqa: E402


def trace(arch: str, schemes) -> list:
    cfg = get_config(arch)
    abstract = make_production_mesh(multi_pod=True)
    n_pods = abstract.shape["pod"]
    opt_cfg = OptimizerConfig(name="adamw", state_dtype=cfg.opt_state_dtype)
    state, _ = specs.state_specs(cfg, opt_cfg, abstract, fed=True,
                                 n_pods=n_pods)
    out = []
    with dryrun.fake_process_group(abstract.size):
        mesh = dryrun.fake_mesh(abstract)
        with dryrun.fake_mode():
            args = (dryrun.fake_tree(state, mesh, "cuda"),
                    torch.ones(n_pods, device="cuda"))
        for scheme in schemes:
            rec = dryrun.trace_step(stepfns.make_fed_round_step(
                cfg, compress=scheme), args, mesh, donate=0)
            rec.pop("ops")
            out.append(dict(rec, arch=arch, compress=scheme))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--compress", nargs="*", default=["none", "int8"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for arch in args.arch or list_architectures():
        for rec in trace(arch, args.compress):
            mem = rec["memory_analysis"]
            print(f"{arch} {rec['compress']}: args "
                  f"{mem['argument_size_in_bytes']} B, peak temp "
                  f"{mem['temp_size_in_bytes']} B, collectives "
                  f"{rec['collectives']['per_kind']}, kernels "
                  f"{rec['kernels']}, dot flops {rec['hlo_flops']:.6e}, "
                  f"trace {rec['lower_s']} s", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
