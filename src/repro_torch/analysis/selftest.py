"""``--self-test``: the analysis pass checks itself before checking code.

For every rule, a minimal *violating* snippet in the port's idiom must
fire and its *fixed twin* must stay silent, and a synthetically
corrupted stream-key constant must trip RPA006. A checker whose
positive fixture stops firing has silently lost its teeth: that must
fail exactly like a real regression would.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.analysis import registry
from repro_torch.analysis.core import ModuleInfo, all_checkers, run_checkers

# (code, violating-source, clean-twin-source, synthetic path)
FIXTURES: List[Tuple[str, str, str, str]] = [
    (
        "RPA001",
        "import torch\n"
        "def init(shape):\n"
        "    return torch.randn(shape)\n",
        "import torch\n"
        "def init(shape, seed):\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    return torch.randn(shape, generator=g)\n",
        "repro_torch/models/_fixture_rng.py",
    ),
    (
        "RPA002",
        "import time\n"
        "def stamp(rows):\n"
        "    return [(time.time(), r) for r in rows]\n",
        "def stamp(rows, now_s):\n"
        "    return [(now_s, r) for r in rows]\n",
        "repro_torch/net/_fixture_clock.py",
    ),
    (
        "RPA003",
        "def total(ids):\n"
        "    out = 0.0\n"
        "    for i in set(ids):\n"
        "        out += 1.0 / (1 + i)\n"
        "    return out\n",
        "def total(ids):\n"
        "    out = 0.0\n"
        "    for i in sorted(set(ids)):\n"
        "        out += 1.0 / (1 + i)\n"
        "    return out\n",
        "repro_torch/net/_fixture_set.py",
    ),
    (
        "RPA004",
        "import torch\n"
        "def run(fn):\n"
        "    torch.backends.cuda.matmul.allow_tf32 = False\n"
        "    return fn()\n",
        "import contextlib\n"
        "import torch\n"
        "@contextlib.contextmanager\n"
        "def full_float32():\n"
        "    saved = torch.backends.cuda.matmul.allow_tf32\n"
        "    torch.backends.cuda.matmul.allow_tf32 = False\n"
        "    try:\n"
        "        yield\n"
        "    finally:\n"
        "        torch.backends.cuda.matmul.allow_tf32 = saved\n",
        "repro_torch/_fixture_precision.py",
    ),
    (
        "RPA005",
        "import torch\n"
        "def scale_ref(x, lim):\n"
        "    if (x > lim).any():\n"
        "        return float(x.max())\n"
        "    return torch.clamp(x, max=lim)\n",
        "import torch\n"
        "def scale_ref(x, lim):\n"
        "    return torch.where(x > lim, x, torch.clamp(x, max=lim))\n",
        "repro_torch/kernels/_fixture/ref.py",
    ),
    (
        "RPA007",
        "def simulate(state, collector):\n"
        "    if collector is not None:\n"
        "        collector.event(\"round\")\n"
        "        state = state + 1\n"
        "    return state\n",
        "def simulate(state, collector):\n"
        "    if collector is not None:\n"
        "        collector.event(\"round\", state=state)\n"
        "    return state + 1\n",
        "repro_torch/net/_fixture_collector.py",
    ),
]

#: a conforming kernel package: the kernel's binding, the oracle and a
#: dispatch that launches the kernel on a CUDA tensor or raises
TRIPLE: Dict[str, str] = {
    "repro_torch/kernels/fake/__init__.py": "",
    "repro_torch/kernels/fake/kernel.py": (
        "def op_cuda(x, block):\n    return x\n"
    ),
    "repro_torch/kernels/fake/ref.py": (
        "def op_ref(x, block):\n    return x\n"
    ),
    "repro_torch/kernels/fake/ops.py": (
        "from repro_torch.kernels.fake import kernel as _kernel\n"
        "from repro_torch.kernels.fake import ref as _ref\n"
        "def op(x, block):\n"
        "    if x.is_cuda:\n"
        "        return _kernel.op_cuda(x, block)\n"
        "    return _ref.op_ref(x, block)\n"
    ),
}

#: ops.py that hides a failing kernel behind its oracle
FALLBACK_OPS = (
    "from repro_torch.kernels.fake import kernel as _kernel\n"
    "from repro_torch.kernels.fake import ref as _ref\n"
    "def op(x, block):\n"
    "    try:\n"
    "        return _kernel.op_cuda(x, block)\n"
    "    except RuntimeError:\n"
    "        return _ref.op_ref(x, block)\n"
)


def _mod(path: str, source: str) -> ModuleInfo:
    return ModuleInfo(path=path, tree=ast.parse(source), source=source)


def triple_findings(overrides: Dict[str, object]):
    """RPA008's findings on :data:`TRIPLE` with ``overrides`` applied (a
    None value drops the file)."""
    files = dict(TRIPLE)
    files.update(overrides)
    return run_checkers(
        [_mod(p, s) for p, s in sorted(files.items()) if s is not None],
        all_checkers(select=["RPA008"]),
    )


def run_self_test(verbose: bool = True) -> int:
    """0 on success; prints one line per probe."""
    failures = 0

    def report(ok: bool, label: str) -> None:
        nonlocal failures
        if not ok:
            failures += 1
        if verbose or not ok:
            print(f"self-test {'ok  ' if ok else 'FAIL'}: {label}")

    for code, bad_src, good_src, path in FIXTURES:
        checkers = all_checkers(select=[code])
        bad = run_checkers([_mod(path, bad_src)], checkers)
        good = run_checkers([_mod(path, good_src)], checkers)
        report(
            any(f.code == code for f in bad),
            f"{code} fires on its violating fixture",
        )
        report(
            not good,
            f"{code} stays silent on the fixed twin"
            + (f" (got: {good[0].message})" if good else ""),
        )

    # RPA006: corrupt one Weyl constant of a synthetic two-module anchor
    # set so the duplicate-detection path is exercised end to end.
    ref_src = (
        "KEY_WEYL_0 = 0x9E3779B9\n"
        "KEY_WEYL_1 = 0x85EBCA6B\n"
        "_C240 = 0x1BD11BDA\n"
    )
    ops_src = (
        "_PON_WEYL_0 = 0xCC9E2D51\n"
        "_PON_WEYL_1 = 0x1B873593\n"
        "_JOB_WEYL_0 = 0xC2B2AE35\n"
        "_JOB_WEYL_1 = 0x27D4EB2F\n"
    )
    fault_ok = (
        "_CLASS_WEYL_0 = 0x9E3779B1\n"
        "_CLASS_WEYL_1 = 0x85EBCA77\n"
        "_CASE_WEYL = 0x6C8E9CF5\n"
    )

    def registry_run(faults_src: str):
        return run_checkers(
            [
                _mod("repro_torch/kernels/traffic/ref.py", ref_src),
                _mod("repro_torch/kernels/traffic/ops.py", ops_src),
                _mod("repro_torch/faults/streams.py", faults_src),
            ],
            all_checkers(select=["RPA006"]),
        )

    report(not registry_run(fault_ok),
           "RPA006 passes a disjoint synthetic registry")
    # corruption: the fault-class constant collides with KEY_WEYL_0
    report(
        any("duplicate" in f.message for f in registry_run(
            fault_ok.replace("0x9E3779B1", "0x9E3779B9"))),
        "RPA006 flags a corrupted (colliding) stream-key constant",
    )
    report(
        any("even" in f.message for f in registry_run(
            fault_ok.replace("0x6C8E9CF5", "0x6C8E9CF4"))),
        "RPA006 flags an even Weyl increment",
    )

    # RPA008: a package missing its oracle, or falling back to it when
    # the kernel raises, must be flagged; the conforming triple passes
    report(
        any("missing" in f.message for f in triple_findings(
            {"repro_torch/kernels/fake/ref.py": None})),
        "RPA008 flags a kernel package without ref.py",
    )
    report(
        any("falls back" in f.message for f in triple_findings(
            {"repro_torch/kernels/fake/ops.py": FALLBACK_OPS})),
        "RPA008 flags a dispatch that hides the kernel behind its oracle",
    )
    full = triple_findings({})
    report(not full, "RPA008 passes a complete conforming triple"
           + (f" (got: {full[0].message})" if full else ""))

    # registry sanity: the validator itself must reject a duplicate
    consts = [
        registry.StreamConstant("a.py", "A_WEYL", 0x9E3779B9, 1),
        registry.StreamConstant("b.py", "B_WEYL", 0x9E3779B9, 1),
    ]
    report(
        bool(registry.validate_constants(consts)),
        "registry validator rejects duplicated constants",
    )

    if failures:
        print(f"self-test: {failures} probe(s) FAILED")
        return 1
    print("self-test: all probes passed")
    return 0
