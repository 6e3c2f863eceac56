"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or
``msgpack`` (which the card's machine does not have), and every
port module, kernel modules included, imports on a machine with no
``nvcc`` and no card without building anything."""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_scan_covers_the_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES[:-1]}
    for expected in ("net/engine.py", "kernels/traffic/kernel.py",
                     "kernels/ponsim/kernel.py", "_device.py",
                     "configs/base.py", "configs/__init__.py",
                     "configs/olmo_1b.py", "models/layers.py",
                     "models/attention.py", "models/lm.py",
                     "models/convert.py", "kernels/attention/ref.py",
                     "kernels/attention/kernel.py",
                     "kernels/attention/ops.py", "dist/stepfns.py",
                     "launch/serve.py", "configs/mamba2_780m.py",
                     "models/ssd.py", "models/rglru.py",
                     "kernels/ssd/ref.py", "kernels/ssd/kernel.py",
                     "kernels/ssd/ops.py", "configs/recurrentgemma_2b.py",
                     "kernels/rglru/ref.py", "kernels/rglru/kernel.py",
                     "kernels/rglru/ops.py", "kernels/quant/ref.py",
                     "kernels/quant/kernel.py", "kernels/quant/ops.py",
                     "core/deadline.py", "data/synthetic.py",
                     "data/federated.py", "models/cnn.py", "_tree.py",
                     "fl/client.py", "fl/selection.py",
                     "fl/compression.py", "fl/aggregation.py",
                     "fl/server.py", "fl/__init__.py",
                     "net/timeline.py", "fl/simulation.py",
                     "core/round_model.py", "core/membership.py",
                     "dist/fedops.py", "obs/__init__.py", "obs/trace.py",
                     "obs/export.py", "obs/metrics.py", "net/dba.py",
                     "net/sim.py", "net/traffic.py", "net/multi_pon.py",
                     "net/jobs.py", "optim/__init__.py",
                     "optim/optimizers.py", "optim/schedules.py",
                     "data/pipeline.py", "checkpoint/__init__.py",
                     "checkpoint/checkpoint.py", "checkpoint/manager.py",
                     "launch/train.py", "dist/__init__.py",
                     "dist/sharding.py", "launch/mesh.py",
                     "launch/specs.py", "_dtensor.py",
                     "launch/dryrun.py", "launch/hlo_analysis.py",
                     "launch/roofline.py", "analysis/core.py",
                     "analysis/cli.py", "analysis/registry.py",
                     "analysis/checkers/kernel_triple.py",
                     "models/flash_xla.py"):
        assert expected in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_modules_import_without_building():
    from repro_torch import _cuda

    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in FILES[:-1]]
    for name in mods:
        importlib.import_module(name.removesuffix(".__init__"))
    assert _cuda._lib is None
