"""Tests for repro_torch.analysis, the port's static analysis pass.

For every RPA0xx code a violating snippet in PyTorch's idiom must fire
and its fixed twin must stay silent (the reference's cases of
``tests/test_analysis.py`` where they carry over, as parametrised
cases); the stream-key registry is exercised on a synthetic
``repro_torch``-shaped tree and held equal to the JAX package's; the
reference's own self-test fixtures for the rules the port keeps as they
are give the same verdicts under the port's checkers; and the real port
(with ``chip_smoke.py``) comes out clean against
``analysis-baseline-torch.json``.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import ANALYSIS_VERSION
from repro_torch.analysis import registry as port_registry
from repro_torch.analysis.baseline import apply_baseline, load_baseline
from repro_torch.analysis.cli import main
from repro_torch.analysis.core import (
    ModuleInfo,
    all_checkers,
    load_modules,
    run_checkers,
)
from repro_torch.analysis.selftest import (
    FALLBACK_OPS,
    run_self_test,
    triple_findings,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "src" / "repro_torch"
BASELINE = REPO_ROOT / "analysis-baseline-torch.json"


def _findings(code, path, source):
    mod = ModuleInfo(path=path, tree=ast.parse(source), source=source)
    return run_checkers([mod], all_checkers(select=[code]))


def _assert_fires(code, path, source):
    found = _findings(code, path, source)
    assert any(f.code == code for f in found), f"{code} did not fire"
    return found


def _assert_silent(code, path, source):
    found = _findings(code, path, source)
    assert not found, f"{code} fired unexpectedly: {found[0].message}"


# (id, code, path, source, fires)
CASES = [
    # -- RPA001: host RNG in engine paths, torch's global generator in
    # the whole port
    ("rpa001-unseeded-numpy", "RPA001", "repro_torch/net/x.py",
     "import numpy as np\n"
     "def jitter(n):\n"
     "    return np.random.poisson(3.0, n)\n", True),
    ("rpa001-stdlib-random", "RPA001", "repro_torch/kernels/x.py",
     "import random\n"
     "def pick(xs):\n"
     "    return random.choice(xs)\n", True),
    ("rpa001-seeded-generator", "RPA001", "repro_torch/net/x.py",
     "import numpy as np\n"
     "def jitter(n, seed):\n"
     "    return np.random.default_rng(seed).poisson(3.0, n)\n", False),
    ("rpa001-host-rng-scoped-to-engine", "RPA001", "repro_torch/obs/x.py",
     "import random\n"
     "def pick(xs):\n"
     "    return random.choice(xs)\n", False),
    ("rpa001-torch-randn-global", "RPA001", "repro_torch/models/x.py",
     "import torch\n"
     "def init(shape):\n"
     "    return torch.randn(shape)\n", True),
    ("rpa001-torch-randint-aliased", "RPA001", "repro_torch/launch/x.py",
     "from torch import randint as ri\n"
     "def prompts(n, vocab):\n"
     "    return ri(0, vocab, (n,))\n", True),
    ("rpa001-torch-inplace-sampler", "RPA001", "repro_torch/models/x.py",
     "def init(w):\n"
     "    return w.normal_(0.0, 0.02)\n", True),
    ("rpa001-torch-manual-seed", "RPA001", "repro_torch/fl/x.py",
     "import torch\n"
     "def setup(seed):\n"
     "    torch.manual_seed(seed)\n", True),
    ("rpa001-torch-cuda-seed-all", "RPA001", "repro_torch/launch/x.py",
     "import torch\n"
     "def setup(seed):\n"
     "    torch.cuda.manual_seed_all(seed)\n", True),
    ("rpa001-torch-explicit-generator", "RPA001", "repro_torch/models/x.py",
     "import torch\n"
     "def init(shape, w, seed):\n"
     "    g = torch.Generator().manual_seed(seed)\n"
     "    w.normal_(0.0, 0.02, generator=g)\n"
     "    return torch.randn(shape, generator=g)\n", False),
    ("rpa001-torch-outside-the-port", "RPA001", "tools/x.py",
     "import torch\n"
     "def init(shape):\n"
     "    return torch.randn(shape)\n", False),
    # -- RPA002: wall-clock reads
    ("rpa002-time-time", "RPA002", "repro_torch/net/x.py",
     "import time\n"
     "def stamp(rows):\n"
     "    return [(time.time(), r) for r in rows]\n", True),
    ("rpa002-time-is-a-parameter", "RPA002", "repro_torch/net/x.py",
     "def stamp(rows, now_s):\n"
     "    return [(now_s, r) for r in rows]\n", False),
    ("rpa002-noqa", "RPA002", "repro_torch/net/x.py",
     "import time\n"
     "def stamp():\n"
     "    return time.time()  # noqa: RPA002\n", False),
    ("rpa002-scoped-to-engine", "RPA002", "repro_torch/launch/x.py",
     "import time\n"
     "def stamp():\n"
     "    return time.perf_counter()\n", False),
    # -- RPA003: unordered iteration
    ("rpa003-set-iteration", "RPA003", "repro_torch/net/x.py",
     "def total(ids):\n"
     "    out = 0.0\n"
     "    for i in set(ids):\n"
     "        out += 1.0 / (1 + i)\n"
     "    return out\n", True),
    ("rpa003-unsorted-listdir", "RPA003", "repro_torch/faults/x.py",
     "import os\n"
     "def cases(d):\n"
     "    return [f for f in os.listdir(d)]\n", True),
    ("rpa003-sorted", "RPA003", "repro_torch/net/x.py",
     "def total(ids):\n"
     "    out = 0.0\n"
     "    for i in sorted(set(ids)):\n"
     "        out += 1.0 / (1 + i)\n"
     "    return out\n", False),
    ("rpa003-order-free-reduction", "RPA003", "repro_torch/net/x.py",
     "def n_unique(ids):\n"
     "    return len(set(ids))\n", False),
    # -- RPA004: ambient precision and default flips
    ("rpa004-ambient-matmul-tf32", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "torch.backends.cuda.matmul.allow_tf32 = True\n", True),
    ("rpa004-aliased-cudnn-tf32", "RPA004", "bench.py",
     "import torch.backends.cudnn as cudnn\n"
     "def fast():\n"
     "    cudnn.allow_tf32 = True\n", True),
    ("rpa004-tuple-store", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "def off():\n"
     "    (torch.backends.cudnn.allow_tf32,\n"
     "     torch.backends.cuda.matmul.allow_tf32) = (False, False)\n", True),
    ("rpa004-reduced-precision", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "m = torch.backends.cuda.matmul\n"
     "torch.backends.cuda.matmul"
     ".allow_bf16_reduced_precision_reduction = False\n", True),
    ("rpa004-set-default-dtype", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "torch.set_default_dtype(torch.float64)\n", True),
    ("rpa004-matmul-precision", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "def fast():\n"
     "    torch.set_float32_matmul_precision('high')\n", True),
    ("rpa004-env-store", "RPA004", "repro_torch/util.py",
     "import os\n"
     "os.environ[\"NVIDIA_TF32_OVERRIDE\"] = \"0\"\n", True),
    ("rpa004-putenv", "RPA004", "repro_torch/util.py",
     "import os\n"
     "os.putenv(\"TORCH_ALLOW_TF32_CUBLAS_OVERRIDE\", \"1\")\n", True),
    ("rpa004-setattr", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "setattr(torch.backends.cudnn, 'allow_tf32', False)\n", True),
    ("rpa004-restore-outside-finally", "RPA004", "repro_torch/util.py",
     "import contextlib\n"
     "import torch\n"
     "@contextlib.contextmanager\n"
     "def no_tf32():\n"
     "    saved = torch.backends.cuda.matmul.allow_tf32\n"
     "    torch.backends.cuda.matmul.allow_tf32 = False\n"
     "    yield\n"
     "    torch.backends.cuda.matmul.allow_tf32 = saved\n", True),
    ("rpa004-restore-to-a-literal", "RPA004", "repro_torch/util.py",
     "import contextlib\n"
     "import torch\n"
     "@contextlib.contextmanager\n"
     "def no_tf32():\n"
     "    torch.backends.cuda.matmul.allow_tf32 = False\n"
     "    try:\n"
     "        yield\n"
     "    finally:\n"
     "        torch.backends.cuda.matmul.allow_tf32 = True\n", True),
    ("rpa004-scoped-context", "RPA004", "repro_torch/util.py",
     "from contextlib import contextmanager\n"
     "import torch\n"
     "@contextmanager\n"
     "def in_float64():\n"
     "    saved = torch.get_default_dtype()\n"
     "    torch.set_default_dtype(torch.float64)\n"
     "    try:\n"
     "        yield\n"
     "    finally:\n"
     "        torch.set_default_dtype(saved)\n", False),
    ("rpa004-reads-are-fine", "RPA004", "repro_torch/util.py",
     "import torch\n"
     "def flags():\n"
     "    return torch.backends.cudnn.allow_tf32\n", False),
    # -- RPA005: host syncs where the card dispatches or the dry run traces
    ("rpa005-item-in-autograd-backward", "RPA005",
     "repro_torch/kernels/x/ops.py",
     "import torch\n"
     "class Op(torch.autograd.Function):\n"
     "    @staticmethod\n"
     "    def forward(ctx, x):\n"
     "        return x * 2\n"
     "    @staticmethod\n"
     "    def backward(ctx, g):\n"
     "        return g * g.sum().item()\n", True),
    ("rpa005-cpu-in-cuda-entry", "RPA005", "repro_torch/kernels/x/kernel.py",
     "def op_cuda(x):\n"
     "    return x.cpu()\n", True),
    ("rpa005-int-in-register-fake", "RPA005",
     "repro_torch/kernels/x/kernel.py",
     "import torch\n"
     "@torch.library.custom_op('x::op', mutates_args=())\n"
     "def _op(x: torch.Tensor) -> torch.Tensor:\n"
     "    return torch.empty_like(x)\n"
     "@_op.register_fake\n"
     "def _(x):\n"
     "    return x.new_empty(int(x.max()))\n", True),
    ("rpa005-synchronize-in-custom-op", "RPA005",
     "repro_torch/kernels/x/kernel.py",
     "import torch\n"
     "@torch.library.custom_op('x::op', mutates_args=())\n"
     "def _op(x: torch.Tensor) -> torch.Tensor:\n"
     "    out = torch.empty_like(x)\n"
     "    torch.cuda.synchronize()\n"
     "    return out\n", True),
    ("rpa005-branch-in-same-module-callee", "RPA005",
     "repro_torch/kernels/x/ref.py",
     "import torch\n"
     "def _clip(x, lim):\n"
     "    y = torch.clamp(x, min=0.0)\n"
     "    while (y > lim).any():\n"
     "        y = y / 2\n"
     "    return y\n"
     "def clip_ref(x, lim):\n"
     "    return _clip(x, lim)\n", True),
    ("rpa005-torch-where", "RPA005", "repro_torch/kernels/x/ref.py",
     "import torch\n"
     "def scale_ref(x, lim):\n"
     "    return torch.where(x > lim, x, torch.clamp(x, max=lim))\n", False),
    ("rpa005-annotated-static-param", "RPA005",
     "repro_torch/kernels/x/ref.py",
     "import torch\n"
     "def win_ref(x, *, n_draws: int):\n"
     "    j_half = max(1, n_draws // 2)\n"
     "    if j_half < n_draws:\n"
     "        x = x * 2\n"
     "    return torch.cumsum(x, 0) * n_draws\n", False),
    ("rpa005-static-accessors", "RPA005", "repro_torch/kernels/x/ref.py",
     "import torch\n"
     "def pad_ref(x, h0=None):\n"
     "    if x.dim() == 1 and x.numel():\n"
     "        x = x[None, :]\n"
     "    if h0 is None or x.shape[0] == 0 or not x.is_cuda:\n"
     "        h0 = torch.zeros_like(x)\n"
     "    return torch.cumsum(x + h0, dim=-1)\n", False),
    ("rpa005-unreached-helper", "RPA005", "repro_torch/kernels/x/ops.py",
     "def _debug(x):\n"
     "    return x.cpu()\n", False),
    ("rpa005-scoped-to-the-triple", "RPA005",
     "repro_torch/kernels/x/tables.py",
     "def table_ref(x):\n"
     "    return x.tolist()\n", False),
    # -- RPA007: collector purity
    ("rpa007-unguarded-use", "RPA007", "repro_torch/net/x.py",
     "def simulate(state, collector=None):\n"
     "    collector.event(\"round\")\n"
     "    return state + 1\n", True),
    ("rpa007-engine-write-in-guard", "RPA007", "repro_torch/net/x.py",
     "def simulate(state, collector=None):\n"
     "    if collector is not None:\n"
     "        collector.event(\"round\")\n"
     "        state = state + 1\n"
     "    return state\n", True),
    ("rpa007-tuple-store-in-guard", "RPA007", "repro_torch/net/x.py",
     "def simulate(state, cap, collector=None):\n"
     "    if collector is not None:\n"
     "        state[0], cap = collector.read(), 0.0\n"
     "    return state, cap\n", True),
    ("rpa007-self-collector-unguarded", "RPA007", "repro_torch/fl/x.py",
     "class Sim:\n"
     "    def step(self, x):\n"
     "        if self._collector is None:\n"
     "            pass\n"
     "        self._collector.event(\"step\")\n"
     "        return x\n", True),
    ("rpa007-guarded-readonly", "RPA007", "repro_torch/net/x.py",
     "def simulate(state, collector=None):\n"
     "    if collector is not None:\n"
     "        collector.event(\"round\", state=state)\n"
     "    return state + 1\n", False),
    ("rpa007-obs-local-names", "RPA007", "repro_torch/net/x.py",
     "def run(state, collector=None):\n"
     "    obs = None\n"
     "    if collector is not None:\n"
     "        obs = collector.phase(\"up\")\n"
     "    for k in range(3):\n"
     "        if obs is not None:\n"
     "            ob_want = ob_eff = None\n"
     "        state = state + k\n"
     "        if obs is not None:\n"
     "            ob_want, ob_eff = state, k\n"
     "            obs.cycle(state, cps_want=ob_want, cps_eff=ob_eff)\n"
     "    return state\n", False),
    ("rpa007-early-none-return", "RPA007", "repro_torch/net/x.py",
     "def record(collector, rows):\n"
     "    if collector is None or not rows:\n"
     "        return\n"
     "    collector.event(\"rows\", n=len(rows))\n", False),
    ("rpa007-required-collector", "RPA007", "repro_torch/obs/x.py",
     "def export(collector):\n"
     "    rows = collector.rows()\n"
     "    return {\"n\": len(rows), \"meta\": collector.meta}\n", False),
    ("rpa007-pass-through-is-not-an-alias", "RPA007", "repro_torch/net/x.py",
     "def run(cfg, collector=None):\n"
     "    timeline = simulate(cfg, collector=collector)\n"
     "    total = timeline.sum()\n"
     "    return total\n", False),
]


@pytest.mark.parametrize("code,path,source,fires",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_rule_fires_or_stays_silent(code, path, source, fires):
    if fires:
        _assert_fires(code, path, source)
    else:
        _assert_silent(code, path, source)


def test_rpa005_branch_and_float_both_flagged():
    found = _assert_fires(
        "RPA005",
        "repro_torch/kernels/x/ref.py",
        "import torch\n"
        "def scale_ref(x, lim):\n"
        "    if (x > lim).any():\n"
        "        return float(x.max())\n"
        "    return torch.clamp(x, max=lim)\n",
    )
    assert len(found) >= 2  # both the branch and the float() sync


def _function_source(path: pathlib.Path, names) -> str:
    """The source of the named top-level functions of ``path``, with the
    module's imports."""
    src = path.read_text()
    tree = ast.parse(src)
    parts = ["import contextlib\nimport torch\n"]
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            start = node.decorator_list[0].lineno if node.decorator_list \
                else node.lineno
            parts.append("\n".join(src.splitlines()[start - 1:node.end_lineno]))
    assert len(parts) == 1 + len(names)
    return "\n\n".join(parts) + "\n"


@pytest.mark.parametrize("path,names", [
    (PORT / "_device.py", ("full_float32",)),
    (REPO_ROOT / "chip_smoke.py", ("_tf32_flags", "_tf32_on")),
    (REPO_ROOT / "chip_smoke.py", ("_matmul_tf32_off",)),
], ids=["full_float32", "tf32_on", "matmul_tf32_off"])
def test_rpa004_port_scopes_are_silent_and_unscoped_twins_fire(path, names):
    src = _function_source(path, names)
    _assert_silent("RPA004", "repro_torch/x.py", src)
    # the same body without the context manager is an ambient flip
    unscoped = src.replace("@contextlib.contextmanager\n", "")
    assert unscoped != src
    _assert_fires("RPA004", "repro_torch/x.py", unscoped)


# ---------------------------------------------------------------------------
# RPA008: kernel-triple conformance (the self-test's conforming triple)

_FAKE = "repro_torch/kernels/fake/"


@pytest.mark.parametrize("overrides,message", [
    ({_FAKE + "ref.py": None}, "missing"),
    ({_FAKE + "ref.py": "from repro_torch.kernels.fake import kernel\n"
                        "def op_ref(x, block):\n    return x\n"},
     "independent witness"),
    ({_FAKE + "kernel.py": "from repro_torch.kernels.fake import ops\n"
                           "def op_cuda(x, block):\n    return x\n"},
     "dispatch layer"),
    ({_FAKE + "ref.py": "def op_ref(block, x):\n    return x\n"},
     "primary operand"),
    ({_FAKE + "kernel.py": "def op_cuda(x, y, block):\n    return x\n",
      _FAKE + "ops.py": "def op(x, block, y):\n    return x\n"},
     "transposed"),
    ({_FAKE + "kernel.py": "def op_launch(x, block):\n    return x\n"},
     "no public accelerator entry"),
    ({_FAKE + "ops.py": FALLBACK_OPS}, "falls back"),
    ({_FAKE + "ops.py": FALLBACK_OPS.replace(
        "from repro_torch.kernels.fake import ref as _ref\n",
        "from .ref import op_ref\n").replace("_ref.op_ref", "op_ref")},
     "falls back"),
], ids=["missing-ref", "ref-imports-kernel", "kernel-imports-ops",
        "leading-param", "transposed-cuda-params", "no-cuda-entry",
        "fallback-to-oracle", "fallback-to-imported-oracle"])
def test_rpa008_fires(overrides, message):
    found = triple_findings(overrides)
    assert any(message in f.message for f in found), found


@pytest.mark.parametrize("overrides", [
    {},
    {_FAKE + "ops.py": "def op(x, *, block, width):\n    return x\n",
     _FAKE + "ref.py": "def op_ref(x, *, width, block):\n    return x\n"},
    {_FAKE + "ops.py": FALLBACK_OPS.replace(
        "        return _ref.op_ref(x, block)\n",
        "        raise\n")},
], ids=["complete-triple", "kwonly-order-free", "try-that-re-raises"])
def test_rpa008_silent(overrides):
    found = triple_findings(overrides)
    assert not found, found[0].message


# ---------------------------------------------------------------------------
# RPA006: stream-key disjointness (synthetic repro_torch-shaped tree)

_REF_SRC = (
    "KEY_WEYL_0 = 0x9E3779B9\n"
    "KEY_WEYL_1 = 0x85EBCA6B\n"
    "_C240 = 0x1BD11BDA\n"
)
_OPS_SRC = (
    "_PON_WEYL_0 = 0xCC9E2D51\n"
    "_PON_WEYL_1 = 0x1B873593\n"
    "_JOB_WEYL_0 = 0xC2B2AE35\n"
    "_JOB_WEYL_1 = 0x27D4EB2F\n"
)
_STREAMS_SRC = (
    "_CLASS_WEYL_0 = 0x9E3779B1\n"
    "_CLASS_WEYL_1 = 0x85EBCA77\n"
    "_CASE_WEYL = 0x6C8E9CF5\n"
)


def _write_tree(tmp_path, streams_src):
    pkg = tmp_path / "repro_torch"
    (pkg / "kernels" / "traffic").mkdir(parents=True)
    (pkg / "faults").mkdir()
    (pkg / "kernels" / "traffic" / "ref.py").write_text(_REF_SRC)
    (pkg / "kernels" / "traffic" / "ops.py").write_text(_OPS_SRC)
    (pkg / "faults" / "streams.py").write_text(streams_src)
    return str(pkg)


@pytest.mark.parametrize("streams,rc,needle", [
    (_STREAMS_SRC, 0, None),
    # one fault-class constant corrupted into the traffic sampler's
    # KEY_WEYL_0: the latent collision the reference fixed for real
    (_STREAMS_SRC.replace("0x9E3779B1", "0x9E3779B9"), 1, "duplicate"),
    (_STREAMS_SRC.replace("0x6C8E9CF5", "0x6C8E9CF4"), 1, "even"),
    # a rename that empties part of the registry is a wiring error
    (_STREAMS_SRC.replace("_CASE_WEYL", "CASE_SHIFT"), 1,
     "expected at least"),
], ids=["clean", "colliding", "even", "shrunk"])
def test_rpa006_registry(tmp_path, capsys, streams, rc, needle):
    root = _write_tree(tmp_path, streams)
    assert main(["--select", "RPA006", "--baseline", str(BASELINE),
                 root]) == rc
    if needle:
        out = capsys.readouterr().out
        assert "RPA006" in out and needle in out


# ---------------------------------------------------------------------------
# baseline mechanics


def test_baseline_suppresses_and_reports_stale(tmp_path):
    src = (
        "import time\n"
        "def stamp():\n"
        "    return time.time()\n"
    )
    mod = ModuleInfo(
        path="repro_torch/net/x.py", tree=ast.parse(src), source=src
    )
    findings = run_checkers([mod], all_checkers(select=["RPA002"]))
    assert findings
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"code": "RPA002", "path": "repro_torch/net/x.py", "symbol": "*",
         "note": "test exemption"},
        {"code": "RPA001", "path": "repro_torch/net/gone.py",
         "symbol": "*", "note": "stale on purpose"},
    ]}))
    new, suppressed, stale = apply_baseline(findings, load_baseline(str(bl)))
    assert not new and suppressed
    assert [e.path for e in stale] == ["repro_torch/net/gone.py"]


@pytest.mark.parametrize("entry,match", [
    ({"code": "RPA002", "path": "x.py", "symbol": "*", "note": "   "},
     "empty note"),
    ({"code": "RPA002", "path": "x.py", "symbol": "*"}, "missing"),
], ids=["empty-note", "no-note"])
def test_baseline_requires_justification(tmp_path, entry, match):
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [entry]}))
    with pytest.raises(ValueError, match=match):
        load_baseline(str(bl))


def test_cli_reports_stale_entries_without_failing(tmp_path, capsys):
    pkg = tmp_path / "repro_torch" / "net"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text("def f(x):\n    return x\n")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"code": "RPA002", "path": "repro_torch/net/gone.py", "symbol": "*",
         "note": "stale on purpose"}]}))
    assert main(["--format", "json", "--baseline", str(bl),
                 str(tmp_path / "repro_torch")]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["summary"]["stale_baseline_entries"] == 1


# ---------------------------------------------------------------------------
# CLI behaviour


def test_cli_json_format_and_artifact(tmp_path, capsys):
    pkg = tmp_path / "repro_torch" / "net"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text(
        "import time\n"
        "def stamp():\n"
        "    return time.time()\n"
    )
    out_path = tmp_path / "report.json"
    rc = main(["--format", "json", "--output", str(out_path),
               "--baseline", str(BASELINE), str(tmp_path / "repro_torch")])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["analysis_version"] == ANALYSIS_VERSION
    assert payload["summary"]["findings"] >= 1
    assert any(f["code"] == "RPA002" for f in payload["findings"])
    on_disk = json.loads(out_path.read_text())
    assert on_disk["summary"] == payload["summary"]


def test_cli_wiring_errors_exit_2(tmp_path):
    assert main([str(tmp_path / "does-not-exist")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main([str(empty)]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert main(["--baseline", str(bad), str(PORT / "analysis")]) == 2


def test_cli_unknown_select_exits_2():
    assert main(["--select", "RPA999", str(PORT)]) == 2


def test_cli_dump_registry(capsys):
    assert main(["--dump-registry", str(PORT)]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert not payload["problems"]
    assert len(payload["constants"]) == port_registry.MIN_CONSTANTS


def test_self_test_passes():
    assert run_self_test(verbose=False) == 0


def test_self_test_runs_without_torch_or_numpy():
    """The package is stdlib-only at run time too: ``--self-test`` and a
    lint of the port pass with torch and numpy made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['numpy'] = None\n"
        "from repro_torch.analysis.cli import main\n"
        f"sys.exit(main(['--self-test']) or main(['--baseline', "
        f"{str(BASELINE)!r}, {str(PORT)!r}]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all probes passed" in proc.stdout


# ---------------------------------------------------------------------------
# the real port is clean modulo the checked-in baseline


def test_self_run_on_the_port_is_clean():
    assert main(["--baseline", str(BASELINE), str(PORT),
                 str(REPO_ROOT / "chip_smoke.py")]) == 0


def test_defaults_scan_the_port_against_its_baseline(monkeypatch, capsys):
    monkeypatch.chdir(REPO_ROOT)
    assert main([]) == 0
    err = capsys.readouterr().err
    assert "0 finding(s)" in err and "0 stale" in err


def test_baseline_entries_are_justified_and_used():
    entries = load_baseline(str(BASELINE))
    findings = run_checkers(load_modules([str(PORT)]))
    new, _, stale = apply_baseline(findings, entries)
    assert not new and not stale
    assert all(len(e.note) > 40 for e in entries)


# ---------------------------------------------------------------------------
# against the reference


def test_stream_key_registry_equals_the_reference():
    from repro.analysis import registry as ref_registry
    from repro.analysis.core import load_modules as ref_load

    ref = ref_registry.extract_constants(
        ref_load([str(REPO_ROOT / "src" / "repro")]))
    port = port_registry.extract_constants(load_modules([str(PORT)]))
    assert {(c.name, c.value) for c in port} == {
        (c.name, c.value) for c in ref}
    assert len(port) == port_registry.MIN_CONSTANTS
    assert not port_registry.validate_constants(port)


def _reference_fixtures():
    from repro.analysis.selftest import FIXTURES

    return [f for f in FIXTURES if f[0] in ("RPA001", "RPA002", "RPA003",
                                            "RPA007")]


@pytest.mark.parametrize("index", range(4),
                         ids=["RPA001", "RPA002", "RPA003", "RPA007"])
def test_reference_fixtures_give_the_same_verdicts(index):
    fixtures = _reference_fixtures()
    assert [f[0] for f in fixtures] == ["RPA001", "RPA002", "RPA003",
                                        "RPA007"]
    code, bad, good, path = fixtures[index]
    assert path.startswith("repro/")
    path = "repro_torch/" + path[len("repro/"):]
    _assert_fires(code, path, bad)
    _assert_silent(code, path, good)


def test_rule_codes_match_the_reference():
    from repro.analysis.core import all_checkers as ref_checkers

    assert [c.code for c in all_checkers()] == [
        c.code for c in ref_checkers()]


# ---------------------------------------------------------------------------
# the package imports only the stdlib and itself


@pytest.mark.parametrize(
    "path", sorted((PORT / "analysis").rglob("*.py")),
    ids=lambda p: p.relative_to(PORT / "analysis").as_posix())
def test_analysis_imports_only_the_stdlib(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                bad.append(f"relative import from {node.module}")
                continue
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if name == "repro_torch.analysis" or name.startswith(
                    "repro_torch.analysis."):
                continue
            if top == "__future__" or top in sys.stdlib_module_names:
                continue
            bad.append(name)
    assert not bad, f"{path.name} imports {bad}"
