"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each ``.cu`` file exports a plain C launch function and is compiled by
its own ``nvcc`` process into a shared library, all of them started
together, then loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds, not minutes.  Libraries land in
``build/repro_torch_kernels/`` at the repository root (``build/`` is
git-ignored), named by a hash of their sources and flags so an edited
source is rebuilt and an unchanged one is reused.  The build runs at the
first kernel launch of a process, never at import: a machine without
``nvcc`` imports every module and runs the plain versions.

Every wrapper counts its kernel launches in :data:`LAUNCHES`; nothing
else writes there.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["LAUNCHES", "SOURCES", "BUILD_DIR", "build_all", "lib", "check", "require"]

_HERE = os.path.dirname(os.path.abspath(__file__))  # <root>/src/repro_torch/kernels
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
                         "build", "repro_torch_kernels")
SOURCES = ("fd_round", "support_update", "wedge_count", "bloom_update",
           "butterfly_count", "flash_attention")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> launches made by its wrapper in this process
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
            "the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in (f"{name}.cu", "common.cuh"):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every missing library, one ``nvcc`` per source, all in
    parallel; raise with the compiler's output if any fails.  Returns
    {name: path}.  The compiler log of each build (``-Xptxas=-v``:
    registers, shared memory, spills) is kept beside its library."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {n: _lib_path(n) for n in SOURCES}
        todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
        if not todo:
            return paths
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(log)
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                              f"{log}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use).
    Every exported launch function takes ``void*`` pointers, ``int``
    sizes and the stream, and returns a ``cudaError_t``."""
    if name not in _libs:
        path = build_all()[name]
        _libs[name] = ctypes.CDLL(path)
    return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise if a launch function reported a CUDA error (a refused
    launch never runs, and a later synchronize would not say so)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {err}")


def require(kernel: str, *specs) -> None:
    """Validate a CUDA launch: each spec is ``(name, tensor, dtype,
    shape)``; every tensor must lie on the first one's CUDA device, with
    that dtype and shape, contiguous.  Raises otherwise — a tensor on
    any device but the CPU reaches the kernel or an error, never the
    plain version."""
    device = specs[0][1].device
    if device.type != "cuda":
        raise ValueError(
            f"{kernel}: takes CPU tensors (plain version) or CUDA tensors "
            f"(the kernel), got {device}")
    for name, t, dtype, shape in specs:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
