"""Roofline terms of dry-run records at an NVIDIA H100's peaks.

    python -m repro_torch.launch.roofline dryrun.jsonl [--csv out.csv]

The counterpart of the reference package's ``launch/roofline.py``, with
its terms, ``TOKENS`` and model FLOPs, at the H100 SXM's peaks in place
of TPU v5e's. Per (arch x shape x mesh) cell, in seconds:

  compute    = dot FLOPs per device / PEAK_FLOPS
  memory     = HBM bytes per device / HBM_BW
  collective = collective bytes per device / COLLECTIVE_BW

with MODEL_FLOPS = 6·N·D for training and 2·N·D otherwise (N the active
parameters of a MoE) and the useful ratio MODEL_FLOPS / (dot FLOPs x
chips). The per-device figures are ``launch/hlo_analysis.py``'s counts of
one traced step (``launch/dryrun.py``): the terms are derived from
counts, not measured.

Peaks, from NVIDIA's *H100 Tensor Core GPU* datasheet, H100 SXM5 column:
989 TFLOP/s dense BF16 on the tensor cores, 3.35 TB/s of HBM3. The
collective rate is the slowest hop of the production meshes: every
16-wide axis of the 256- and 512-device meshes spans two 8-GPU nodes,
joined by one 400 Gb/s NDR InfiniBand port a GPU (50 GB/s a direction).
Within a node NVLink 4 carries 450 GB/s a direction a GPU.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12          # dense bf16 per GPU (H100 SXM5)
HBM_BW = 3.35e12             # bytes/s per GPU (HBM3)
COLLECTIVE_BW = 50e9         # bytes/s per GPU: NDR 400 Gb/s between nodes
NVLINK_BW = 450e9            # bytes/s per GPU a direction, within a node

TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,        # one token per sequence
    "long_500k": 1,
}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    roofline_fraction: float
    mem_bytes_per_dev: Optional[int]
    record: Dict

    @property
    def bound(self) -> str:
        return self.dominant


def analyze_record(rec: Dict) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    chips = rec.get("chips", 256)
    flops_dev = rec.get("hlo_flops", 0.0)
    hbm_dev = rec.get("hlo_hbm_bytes", 0.0)
    coll_dev = rec.get("collectives", {}).get("total_bytes", 0.0)

    compute_s = flops_dev / PEAK_FLOPS
    memory_s = hbm_dev / HBM_BW
    collective_s = coll_dev / COLLECTIVE_BW

    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)

    tokens = TOKENS.get(rec["shape"], 1)
    n_active = rec.get("params_active", rec.get("params_total", 0))
    mult = 6 if rec.get("kind") == "train" else 2
    model_flops = mult * n_active * tokens
    hlo_global = flops_dev * chips
    useful = model_flops / hlo_global if hlo_global else 0.0
    frac = compute_s / max(max(terms.values()), 1e-30)

    ma = rec.get("memory_analysis") or {}
    mem_dev = None
    if ma:
        out_extra = max(
            0,
            ma.get("output_size_in_bytes", 0)
            - ma.get("alias_size_in_bytes", 0),   # donated buffers alias
        )
        mem_dev = (
            ma.get("argument_size_in_bytes", 0)
            + out_extra
            + ma.get("temp_size_in_bytes", 0)
        )
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        hlo_flops_global=hlo_global, useful_ratio=useful,
        roofline_fraction=frac, mem_bytes_per_dev=mem_dev, record=rec,
    )


def load_rows(paths: List[str]) -> List[RooflineRow]:
    rows = []
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = analyze_record(json.loads(line))
                if row is not None:
                    rows.append(row)
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (
        f"{'arch':18s} {'shape':12s} {'mesh':8s} "
        f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
        f"{'dominant':>10s} {'useful':>7s} {'roofline':>9s} {'mem/dev':>9s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        mem = f"{r.mem_bytes_per_dev/2**30:.1f}G" if r.mem_bytes_per_dev else "-"
        lines.append(
            f"{r.arch:18s} {r.shape:12s} {r.mesh:8s} "
            f"{r.compute_s:10.4f} {r.memory_s:10.4f} {r.collective_s:10.4f} "
            f"{r.dominant:>10s} {r.useful_ratio:7.2f} "
            f"{r.roofline_fraction:9.3f} {mem:>9s}"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+", help="dryrun JSONL files")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load_rows(args.inputs)
    rows.sort(key=lambda r: (r.mesh, r.arch, r.shape))
    print(format_table(rows))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(
                "arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
                "useful_ratio,roofline_fraction,mem_bytes_per_dev\n"
            )
            for r in rows:
                f.write(
                    f"{r.arch},{r.shape},{r.mesh},{r.compute_s:.6g},"
                    f"{r.memory_s:.6g},{r.collective_s:.6g},{r.dominant},"
                    f"{r.useful_ratio:.4g},{r.roofline_fraction:.4g},"
                    f"{r.mem_bytes_per_dev or ''}\n"
                )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
