"""Multi-pod dry run: trace every (arch x input shape x mesh) cell's step.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl
    python -m repro_torch.launch.dryrun --arch olmo-1b --fed --mesh multi
    python -m repro_torch.launch.dryrun --arch olmo-1b --fed-round --mesh multi
    python -m repro_torch.launch.dryrun --all --override '{"n_layers": 2}'

The counterpart of the reference package's ``launch/dryrun.py``, with its
flags and record keys. The reference lowers and compiles each cell on
512 placeholder host devices; here each cell's step runs once, eagerly,
as one rank of the production mesh would run it, on fake tensors:

1. a fake process group (``torch.testing``'s ``fake`` backend, no
   communication) of 256 or 512 ranks carries a ``DeviceMesh`` of
   ``launch/mesh.py::make_production_mesh``'s shape, of device type
   ``cuda`` (``--device cpu``: ``cpu``);
2. under ``FakeTensorMode`` (shapes, no storage) the state and the
   inputs are DTensors placed by ``launch/specs.py``'s specs, each rank
   part of the whole shape;
3. one step of ``dist/stepfns.py`` runs under
   ``hlo_analysis.OpCounter``: the card's program, the kernels' fake
   implementations standing in for their launches, counted per device;
4. one JSON record a cell, for ``launch/roofline.py``.

On ``cuda`` that is the program a card runs: the kernels are reached
through the same dispatch as on a card. A PyTorch built without CUDA has
no CUDA device guard, which indexing a fake ``cuda`` tensor needs;
:func:`fake_cuda` then builds and loads a no-op one
(``csrc/fake_cuda.cpp``, with the host's C++ compiler).

The record's ``cost_analysis`` (``flops``, ``bytes accessed``) holds the
counter's figures, not XLA's; ``memory_analysis`` the arguments' and the
outputs' bytes on one rank, the donated state's (``alias``) and the
peak of the bytes the step's operators hold at once (``temp``), as
storages are made and freed. ``compile_s``, ``hlo_bytes`` and
``loop_trips`` have no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _dtensor
from repro_torch._tree import tree_map
from repro_torch.configs import applicable_shapes, get_config, list_architectures
from repro_torch.configs.base import SHAPES_BY_NAME, InputShape, param_count
from repro_torch.dist import sharding as shd
from repro_torch.dist import stepfns
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.optimizers import OptimizerConfig

PORT = Path(__file__).resolve().parents[1]
FAKE_CUDA_SOURCE = PORT / "csrc" / "fake_cuda.cpp"
BUILD_DIR = PORT / "_build"
_fake_cuda = None
_PRELOADED = "REPRO_TORCH_FAKE_CUDA_PRELOADED"


# ---------------------------------------------------------------------------
# fake devices and meshes
# ---------------------------------------------------------------------------


def fake_cuda_library() -> Path:
    """The stand-in CUDA device's library (``csrc/fake_cuda.cpp``), built
    once into ``_build/`` with the host's C++ compiler (``$CXX`` or
    ``c++``) against this PyTorch, named by both."""
    root = Path(torch.__file__).resolve().parent
    digest = hashlib.sha256(FAKE_CUDA_SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libfake_cuda_{torch.__version__}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("c++") or "g++"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, "-O1", "-w", "-shared", "-fPIC", "-std=c++17",
           "-I", str(root / "include"), str(FAKE_CUDA_SOURCE),
           "-L", str(root / "lib"), "-lc10", "-ltorch_cpu",
           f"-Wl,-rpath,{root / 'lib'}", "-o", tmp]
    done = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"building the stand-in CUDA device failed:\n"
                           f"{done.stdout}")
    os.replace(tmp, lib)
    return lib


def cuda_backward_ready() -> bool:
    """Whether a backward can run on fake ``cuda`` tensors here: PyTorch
    is built with CUDA, or the stand-in device was loaded before it."""
    if torch.backends.cuda.is_built():
        return True
    acc = torch.accelerator.current_accelerator()
    return acc is not None and acc.type == "cuda"


def fake_cuda() -> None:
    """Make fake ``cuda`` tensors usable on a PyTorch built without CUDA
    (a build with CUDA needs nothing): load the stand-in device. Loaded
    after PyTorch, it serves indexing, not a backward
    (:func:`cuda_backward_ready`; the CLI runs itself again with the
    library preloaded)."""
    global _fake_cuda
    if _fake_cuda is None and not torch.backends.cuda.is_built():
        _fake_cuda = ctypes.CDLL(str(fake_cuda_library()))


def fake_mode():
    """A ``FakeTensorMode`` in which fake ``cuda`` tensors work here."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_cuda()
    return FakeTensorMode()


class FakeDevice(TorchDispatchMode):
    """Run code on the fake tensors of ``fake_mode`` with that mode not
    entered: each operator on fake tensors enters it for itself (a fake
    tensor's own dispatch), an operator that makes a tensor on the
    device runs in it, and the host's own tensors stay real.

    So the step runs as on a card: DTensor keeps its caches of sharding
    decisions (it bypasses them while a fake mode is entered) and
    computes a placement's offsets with real host tensors, which it
    reads back (``tolist``), as a fake tensor cannot be. ``torch.tensor``
    on the device makes its value there, as on a card, and is lifted to
    a fake tensor; without CUDA it is built on the host and lifted before
    it moves. Use it where the device is not the host."""

    _LIFT = ("lift_fresh", "lift_fresh_copy")

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self._lift_cpu = None

    def __enter__(self):
        self._lift_cpu = torch._C._only_lift_cpu_tensors()
        self._lazy_init = torch.cuda._lazy_init
        if not torch.backends.cuda.is_built():
            # no CUDA to start: ``torch.tensor`` builds on the host, and a
            # factory on the device skips starting CUDA (the stand-in
            # device, fake tensors only)
            torch._C._set_only_lift_cpu_tensors(True)
            torch.cuda._lazy_init = lambda: None
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            torch._C._set_only_lift_cpu_tensors(self._lift_cpu)
            torch.cuda._lazy_init = self._lazy_init

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import is_fake
        from torch.utils._pytree import tree_flatten

        kwargs = kwargs or {}
        if any(hasattr(t, "__tensor_flatten__") for t in types):
            return NotImplemented
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
            # a fake mode is entered (DTensor learning an output's
            # metadata in one of its own): it serves the operator
            return func(*args, **kwargs)
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if any(is_fake(t) for t in tensors):
            return func(*args, **kwargs)
        device = kwargs.get("device")
        on_device = (func._schema.name.split("::")[-1] in self._LIFT
                     or any(t.device.type != "cpu" for t in tensors)
                     or (device is not None
                         and torch.device(device).type != "cpu"))
        if on_device:
            with self.fake_mode:
                return func(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group, for the block's length: a fake one of
    ``world_size`` ranks (this process rank 0; collectives move nothing).
    A group already running in this process raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; run the "
                           "dry run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(abstract, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``device_type`` with ``abstract``'s axes and
    sizes, over the fake process group."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(abstract.shape.values())
    ranks = torch.arange(abstract.size, device="cpu").reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=abstract.axis_names)


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples
    (NamedTuples rebuilt), a ``TensorSpec`` being a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, specs_mod.TensorSpec):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def fake_tree(spec_tree, mesh, device):
    """Fake DTensors of a tree of ``specs_mod.TensorSpec``s on ``mesh``
    (plain fake tensors without a mesh), each rank's part of the whole
    shape; call under :func:`fake_mode`."""
    def leaf(ts):
        t = torch.zeros(ts.shape, dtype=ts.dtype, device=device)
        if mesh is None:
            return t
        return _dtensor.place(t, mesh, shd.to_placements(ts.spec, mesh))

    return _map(leaf, spec_tree)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def _local_bytes(tree) -> int:
    return sum(_dtensor.local(t).numel() * _dtensor.local(t).element_size()
               for t in _leaves(tree) if isinstance(t, torch.Tensor))


def trace_step(step, args, mesh=None, donate: Optional[int] = None) -> Dict:
    """Run ``step(*args)`` once under an ``OpCounter`` and return its
    counts as a record's fields: ``hlo_flops``, ``hlo_hbm_bytes``,
    ``hlo_dot_count``, ``collectives``, ``cost_analysis``,
    ``memory_analysis``, ``ops``, ``kernels``, ``chips`` and ``lower_s``.

    ``args`` are fake tensors (built under :func:`fake_mode`; the step
    runs in their fake mode) or real ones (the step runs on their
    device), DTensors on ``mesh`` or plain. ``donate`` is the index of
    the argument whose buffers the step's new values replace (the
    state, the cache): its bytes are ``alias_size_in_bytes``."""
    from torch._guards import detect_fake_mode

    leaves = [t for t in _leaves(args) if isinstance(t, torch.Tensor)]
    mode = detect_fake_mode(leaves)
    device_type = (mesh.device_type if mesh is not None
                   else leaves[0].device.type)
    counter = OpCounter(device_type)
    counter.known(args)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if mode is not None:
            stack.enter_context(FakeDevice(mode) if device_type != "cpu"
                                else mode)
        stack.enter_context(counter)
        out = step(*args)
    lower_s = time.time() - t0
    counts = counter.summary()
    memory = {
        "argument_size_in_bytes": _local_bytes(args),
        "output_size_in_bytes": _local_bytes(out),
        "alias_size_in_bytes": (0 if donate is None
                                else _local_bytes(args[donate])),
        "temp_size_in_bytes": counts["peak_bytes"],
    }
    return {
        "chips": 1 if mesh is None else mesh.size(),
        "lower_s": round(lower_s, 2),
        "cost_analysis": {"flops": counts["flops"],
                          "bytes accessed": counts["hbm_bytes"]},
        "memory_analysis": memory,
        "hlo_flops": counts["flops"],
        "hlo_hbm_bytes": counts["hbm_bytes"],
        "hlo_dot_count": counts["dot_count"],
        "collectives": counts["collectives"],
        "ops": counts["ops"],
        "kernels": counts["kernels"],
    }


def _cell_inputs(cfg, shape: InputShape, mesh, abstract, opt_cfg, fed: bool,
                 fed_round: bool, device):
    """``(step, args, donate)`` of one cell, the args fake DTensors."""
    n_pods = abstract.shape.get("pod", 1)
    if fed_round:
        state, _ = specs_mod.state_specs(cfg, opt_cfg, abstract, fed=True,
                                         n_pods=n_pods)
        weights = torch.ones((n_pods,), dtype=torch.float32, device=device)
        return (stepfns.make_fed_round_step(cfg),
                (fake_tree(state, mesh, device), weights), 0)
    if shape.kind == "train":
        state, spec = specs_mod.state_specs(cfg, opt_cfg, abstract, fed=fed,
                                            n_pods=n_pods)
        batch = specs_mod.train_batch_specs(cfg, shape, abstract, fed=fed,
                                            n_pods=n_pods)
        if fed:
            # the per-pod step's gradients in the per-pod placements: the
            # pod entry stripped, on the mesh's other axes
            sub = mesh["data", "model"]
            grad_sh = tree_map(lambda s: shd.to_placements(shd.P(*s[1:]),
                                                           sub), spec.params)
            step = stepfns.make_fed_train_step(
                cfg, opt_cfg, grad_shardings=grad_sh, spmd_axis_name="pod")
        else:
            step = stepfns.make_train_step(
                cfg, opt_cfg,
                grad_shardings=shd.spec_tree_placements(spec.params, mesh))
        return step, (fake_tree(state, mesh, device),
                      fake_tree(batch, mesh, device)), 0
    state, _ = specs_mod.state_specs(cfg, opt_cfg, abstract)
    params = fake_tree(state.params, mesh, device)
    if shape.kind == "prefill":
        tokens, cache, _, extra = specs_mod.prefill_input_specs(
            cfg, shape, abstract)
        cache = fake_tree(cache, mesh, device)
        cache["pos"] = 0
        args = (params, fake_tree(tokens, mesh, device), cache)
        if extra is not None:
            args += (fake_tree(extra, mesh, device),)
        return stepfns.make_prefill_step(cfg), args, 2
    token, cache, _ = specs_mod.decode_input_specs(cfg, shape, abstract)
    cache = fake_tree(cache, mesh, device)
    cache["pos"] = shape.seq_len - 1
    return (stepfns.make_decode_step(cfg),
            (params, fake_tree(token, mesh, device), cache), 2)


def run_cell(
    arch: str,
    shape: InputShape,
    multi_pod: bool,
    fed: bool = False,
    fed_round: bool = False,
    config_overrides: Optional[Dict] = None,
    device: str = "cuda",
    smoke: bool = False,
) -> Dict:
    """Trace one cell's step on a fake production mesh; returns the JSON
    record. ``smoke`` takes the config's smoke size (the tests)."""
    cfg = get_config(arch, smoke=smoke)
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    abstract = make_production_mesh(multi_pod=multi_pod)
    if (fed or fed_round) and "pod" not in abstract.shape:
        raise ValueError("the federated steps need the multi-pod mesh")
    opt_cfg = OptimizerConfig(name="adamw", state_dtype=cfg.opt_state_dtype)
    rec: Dict = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": abstract.size,
        "kind": shape.kind,
        "fed": fed,
        "fed_round": fed_round,
        "device": device,
        "ok": False,
    }
    if (device == "cuda" and shape.kind == "train" and not fed_round
            and not cuda_backward_ready()):
        raise RuntimeError(
            "a backward on fake cuda tensors needs PyTorch built with CUDA "
            "or the stand-in device loaded first; run the dry run's CLI, "
            "which preloads it")
    with fake_process_group(abstract.size):
        mesh = fake_mesh(abstract, device)
        with fake_mode():
            step, args, donate = _cell_inputs(cfg, shape, mesh, abstract,
                                              opt_cfg, fed, fed_round,
                                              torch.device(device))
        rec.update(trace_step(step, args, mesh, donate))
    pc = param_count(cfg)
    rec["params_total"] = pc["total"]
    rec["params_active"] = pc["active"]
    rec["ok"] = True
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x applicable shape) cell")
    ap.add_argument("--fed", action="store_true",
                    help="trace the federated pod-axis steps instead")
    ap.add_argument("--fed-round", action="store_true",
                    help="trace the cross-pod FedAvg round step")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (fake tensors either way)")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke size (tests)")
    args = ap.parse_args(argv)
    if (args.fed or args.fed_round) and args.mesh != "multi":
        ap.error("--fed and --fed-round need --mesh multi (a pod axis)")
    if args.device == "cuda" and not cuda_backward_ready():
        # a PyTorch without CUDA: run again with the stand-in device
        # loaded before PyTorch
        if os.environ.get(_PRELOADED):
            raise RuntimeError("the stand-in CUDA device did not load")
        env = dict(os.environ, **{_PRELOADED: "1"})
        env["LD_PRELOAD"] = " ".join(
            p for p in (str(fake_cuda_library()), env.get("LD_PRELOAD"))
            if p)
        argv = sys.argv[1:] if argv is None else list(argv)
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
            env=env).returncode

    cells = []
    archs = list_architectures() if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        cfg = get_config(arch)
        shapes = (
            applicable_shapes(cfg) if (args.all or not args.shape)
            else [SHAPES_BY_NAME[args.shape]]
        )
        for shape in shapes:
            meshes = {
                "single": [False], "multi": [True], "both": [False, True]
            }[args.mesh]
            for multi in meshes:
                cells.append((arch, shape, multi))

    overrides = json.loads(args.override) if args.override else None
    records = []
    failures = 0
    for arch, shape, multi in cells:
        label = f"{arch} x {shape.name} x {'2x16x16' if multi else '16x16'}"
        try:
            rec = run_cell(arch, shape, multi, fed=args.fed,
                           fed_round=args.fed_round,
                           config_overrides=overrides, device=args.device,
                           smoke=args.smoke)
            flops = rec["cost_analysis"].get("flops", 0)
            coll = rec["collectives"]["total_bytes"]
            print(
                f"[ok] {label}: lower {rec['lower_s']}s "
                f"flops {flops:.3e} coll {coll:.3e}B",
                flush=True,
            )
        except Exception as e:
            failures += 1
            rec = {
                "arch": arch, "shape": shape.name,
                "mesh": "2x16x16" if multi else "16x16",
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"[FAIL] {label}: {type(e).__name__}: {e}", flush=True)
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    print(f"\n{len(records) - failures}/{len(records)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
