"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: the
card's program traced on fake ``cuda`` tensors, per device, on fake
process groups of the production meshes' 256 and 512 ranks.

The configs run at their smoke widths (with ``attn_impl="chunked"`` where
K4 should be on the path) in every kind of cell: train and the federated
step (through the CLI, which preloads the stand-in CUDA device a
backward needs), prefill, decode, ``long_500k`` for a sub-quadratic
config, an MoE config and the FedAvg round. One prefill cell's kernel
work is held to a hand count, the int8 round's K3/K3' to one a leaf, and
the roofline terms to the H100's peaks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.hlo_analysis import live_keys
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
CHUNKED = {"attn_impl": "chunked"}


def _cell(arch, shape, multi=False, **kw):
    return dryrun.run_cell(arch, SHAPES_BY_NAME[shape], multi, smoke=True,
                           **kw)


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The train cell on 16x16 and the federated step on 2x16x16 through
    the CLI, side by side: ``{name: (exit code, output, records)}``."""
    out = tmp_path_factory.mktemp("dryrun")
    runs = {
        "train": ("--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                  "single"),
        "fed": ("--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                "multi", "--fed"),
    }
    procs = {name: _cli(*args, "--override", json.dumps(CHUNKED),
                        "--out", str(out / f"{name}.jsonl"))
             for name, args in runs.items()}
    done = {}
    for name, proc in procs.items():
        text, _ = proc.communicate(timeout=600)
        path = out / f"{name}.jsonl"
        recs = ([json.loads(line) for line in path.read_text().splitlines()]
                if path.exists() else [])
        done[name] = (proc.returncode, text, recs)
    return done


@pytest.mark.parametrize("name", ["train", "fed"])
def test_cli_traces_the_training_cells(cli_runs, name):
    rc, text, recs = cli_runs[name]
    assert rc == 0, text[-3000:]
    assert "1/1 cells OK" in text
    (rec,) = recs
    assert rec["ok"] and rec["kind"] == "train" and rec["device"] == "cuda"
    assert rec["fed"] == (name == "fed")
    assert rec["chips"] == (512 if name == "fed" else 256)
    cfg = get_config("olmo-1b", smoke=True)
    # attn_impl="chunked": K4 with its log-sum-exp twice a layer a
    # microbatch (the forward and its recomputation under remat="full")
    # and the backward from it once; the federated step runs this rank's
    # one pod
    assert cfg.remat == "full"
    assert rec["kernels"] == {
        "flash_attention_lse": 2 * cfg.n_layers * cfg.grad_accum,
        "flash_attention_bwd": cfg.n_layers * cfg.grad_accum}
    assert rec["hlo_flops"] > 0 and rec["hlo_dot_count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    mem = rec["memory_analysis"]
    # the donated state: the arguments but the batch
    assert (mem["alias_size_in_bytes"]
            == mem["argument_size_in_bytes"] - _batch_bytes(rec))
    assert mem["temp_size_in_bytes"] > 0


def _batch_bytes(rec) -> int:
    """A rank's part of the tokens and labels (int32)."""
    shape = SHAPES_BY_NAME[rec["shape"]]
    ranks = 16 * (2 if rec["fed"] else 1)       # the batch's split
    return 2 * shape.global_batch // ranks * shape.seq_len * 4


def test_cli_reports_failures_in_its_exit_code(capsys):
    rc = dryrun.main(["--arch", "olmo-1b", "--shape", "prefill_32k",
                      "--smoke", "--device", "cpu", "--override",
                      json.dumps({"attn_impl": "bogus"})])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] olmo-1b x prefill_32k x 16x16" in out
    assert "0/1 cells OK" in out


def test_prefill_cell_by_hand():
    rec = _cell("olmo-1b", "prefill_32k", config_overrides=CHUNKED)
    cfg = get_config("olmo-1b", smoke=True)
    assert rec["ok"] and rec["chips"] == 256
    shape = SHAPES_BY_NAME["prefill_32k"]
    # batch 32 over the 16-way data axis; the 4 heads do not divide the
    # 16-way model axis, so every rank attends over all of them
    b_local, S = shape.global_batch // 16, shape.seq_len
    k4 = 4 * b_local * cfg.n_heads * cfg.d_head * live_keys(S, S, True,
                                                            None)
    assert rec["kernels"] == {"flash_attention": cfg.n_layers}
    assert rec["hlo_flops"] >= cfg.n_layers * k4
    assert rec["hlo_flops"] - cfg.n_layers * k4 < k4 / 10
    # the cache is donated: each rank holds its 2 of the 32 sequences
    # and its 4 of the 64 kv features, in the compute dtype (float32 at
    # the smoke size), for the k and v of each layer
    assert cfg.dtype == "float32"
    cache = cfg.n_layers * 2 * b_local * S * (cfg.n_kv_heads * cfg.d_head
                                              // 16) * 4
    assert rec["memory_analysis"]["alias_size_in_bytes"] == cache


@pytest.mark.parametrize("arch,shape,multi", [
    ("olmo-1b", "decode_32k", False),
    ("mamba2-780m", "long_500k", False),
    ("mamba2-780m", "long_500k", True),
    ("mixtral-8x22b", "decode_32k", False),
    ("recurrentgemma-2b", "prefill_32k", False),
])
def test_forward_cells(arch, shape, multi):
    rec = _cell(arch, shape, multi)
    assert rec["ok"] and rec["chips"] == (512 if multi else 256)
    assert rec["hlo_flops"] > 0 and rec["hlo_hbm_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["params_active"] <= rec["params_total"]
    if arch == "recurrentgemma-2b":
        # K6 once a recurrent layer of the two units
        cfg = get_config(arch, smoke=True)
        n_rec = sum(s.kind == "rglru" for s in cfg.pattern) * cfg.n_units
        assert rec["kernels"] == {"rglru_scan": n_rec}


def test_int8_fed_round_runs_k3_once_a_leaf():
    from repro_torch.dist import stepfns
    from repro_torch.launch import specs
    from repro_torch.optim.optimizers import OptimizerConfig

    cfg = get_config("olmo-1b", smoke=True)
    abstract = make_production_mesh(multi_pod=True)
    opt_cfg = OptimizerConfig(name="adamw")
    state, _ = specs.state_specs(cfg, opt_cfg, abstract, fed=True, n_pods=2)
    n_leaves = len(dryrun._leaves(state.params))
    with dryrun.fake_process_group(abstract.size):
        mesh = dryrun.fake_mesh(abstract)
        with dryrun.fake_mode():
            args = (dryrun.fake_tree(state, mesh, "cuda"),
                    torch.ones(2, device="cuda"))
        got = {c: dryrun.trace_step(stepfns.make_fed_round_step(
            cfg, compress=c), args, mesh, donate=0) for c in ("none", "int8")}
    assert got["none"]["kernels"] == {}
    assert got["int8"]["kernels"] == {"quantize_int8": n_leaves,
                                      "dequantize_int8": n_leaves}
    for rec in got.values():
        assert rec["chips"] == 512
        assert set(rec["collectives"]["per_kind"]) <= {"all-gather"}
        assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    # the uncompressed round: one float32 all-gather of each leaf's two
    # pods, the weighted sum a (1 x 2) by (2 x n) product a leaf
    none = got["none"]
    local = none["memory_analysis"]["argument_size_in_bytes"]
    params = local - _opt_bytes(args[0]) - 2 * 4
    assert none["collectives"]["per_kind"]["all-gather"] == 2 * params
    assert none["hlo_flops"] == 2 * 2 * params // 4
    assert none["hlo_dot_count"] == n_leaves


def _opt_bytes(state) -> int:
    from repro_torch import _dtensor

    return sum(_dtensor.local(t).numel() * _dtensor.local(t).element_size()
               for t in dryrun._leaves(state.opt))


def test_roofline_terms_at_the_h100_peaks():
    rec = {"ok": True, "arch": "a", "shape": "train_4k", "mesh": "16x16",
           "chips": 256, "kind": "train", "hlo_flops": 989e12,
           "hlo_hbm_bytes": 2 * 3.35e12,
           "collectives": {"total_bytes": 50e9}, "params_active": 10,
           "memory_analysis": {"argument_size_in_bytes": 4,
                               "output_size_in_bytes": 5,
                               "alias_size_in_bytes": 4,
                               "temp_size_in_bytes": 2}}
    row = roofline.analyze_record(rec)
    assert (row.compute_s, row.memory_s, row.collective_s) == (1.0, 2.0, 1.0)
    assert row.dominant == "memory" and row.roofline_fraction == 0.5
    assert row.model_flops == 6 * 10 * 4096 * 256
    assert row.mem_bytes_per_dev == 4 + 1 + 2
    assert roofline.analyze_record({"ok": False}) is None
    assert "memory" in roofline.format_table([row])
