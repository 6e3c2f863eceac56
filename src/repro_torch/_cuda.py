"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc -c`` for ``sm_90a``, all at
once, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. Nothing is built when a module is
imported: :func:`library` builds at first CUDA use. The library is named
by a hash of the sources and flags and kept under ``_build/`` beside
this file (listed in ``.gitignore``), so a changed source rebuilds and an
unchanged one is reused. The hash covers the headers (``csrc/*.cuh``)
too, so an edited header rebuilds every source. ``nvcc`` comes from
``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("traffic.cu", "waterfill.cu", "ponsim_phase.cu", "flash_attn.cu",
           "flash_attn_bwd.cu", "ssd_scan.cu", "ssd_scan_tc.cu", "rglru_scan.cu",
           "quant_int8.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libreprotorch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if no library of these sources exists yet;
    returns its path. ``ptxas`` resource notes go to ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed)
                               + ":\n" + "\n".join(log))
        so = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(log))
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.repro_traffic_sample.argtypes = [
            p, p, p, p, p, ctypes.c_double, i, i, ctypes.c_uint, i, i, i, i,
            i, i, i, i, q, q, p]
        lib.repro_traffic_sample.restype = i
        lib.repro_waterfill_grants.argtypes = [p, p, p, p, p, i, i, p, p]
        lib.repro_waterfill_grants.restype = i
        lib.repro_waterfill_scratch_bytes.argtypes = [i]
        lib.repro_waterfill_scratch_bytes.restype = ctypes.c_longlong
        lib.repro_ponsim_phase.argtypes = [p, i, p, p]
        lib.repro_ponsim_phase.restype = i
        lib.repro_phase_plan.argtypes = [p, p]
        lib.repro_phase_plan.restype = i
        lib.repro_phase_plan_words.argtypes = []
        lib.repro_phase_plan_words.restype = i
        lib.repro_phase_region_name.argtypes = [i]
        lib.repro_phase_region_name.restype = ctypes.c_char_p
        lib.repro_phase_args_bytes.argtypes = []
        lib.repro_phase_args_bytes.restype = ctypes.c_longlong
        lib.repro_flash_attn_fwd.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        lib.repro_flash_attn_fwd.restype = i
        lib.repro_flash_attn_bwd.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, p]
        lib.repro_flash_attn_bwd.restype = i
        lib.repro_ssd_scan_fwd.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, q, q, q, q, q, q, i, p]
        lib.repro_ssd_scan_fwd.restype = i
        lib.repro_ssd_scan_tc.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, q, q, q, q, q, q, p]
        lib.repro_ssd_scan_tc.restype = i
        lib.repro_rglru_scan_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.repro_rglru_scan_fwd.restype = i
        lib.repro_quant_int8_fwd.argtypes = [p, q, q, i, p, p, p, q, p]
        lib.repro_quant_int8_fwd.restype = i
        lib.repro_dequant_int8_fwd.argtypes = [p, p, q, q, p, p]
        lib.repro_dequant_int8_fwd.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape (``None`` in ``shape`` matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}; got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
