"""Builds the hand-written CUDA kernels at first use and loads them with ctypes.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <name>.cu

The output lives under ``build/kernels/`` at the repository root (ignored by
git) and is named by a hash of the source and flags, so an edited source is
rebuilt and a current one is reused.  Each build writes a per-process
temporary file and renames it into place, so processes that build at the
same time never load a half-written library.  Pointers and the stream cross
the C boundary as ``c_void_p``; every entry point returns
``cudaGetLastError()`` and ``check`` raises on anything nonzero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise KernelBuildError(f"nvcc not found on PATH or in {home}/bin: the "
                           "CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _build(name: str, out: Path) -> str:
    """Compile ``csrc/<name>.cu`` into ``out``; returns nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library.
    Returns {name: nvcc output} for the sources compiled in this call."""
    logs = {}
    for name in sources():
        out = _target(name)
        if not out.exists():
            logs[name] = _build(name, out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _build(name, out)
        lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        import torch
        msg = ""
        try:
            cudart = torch.cuda.cudart()
            msg = cudart.cudaGetErrorString(err)
        except (AttributeError, RuntimeError, TypeError):
            pass
        raise RuntimeError(f"{what}: CUDA error {err} {msg}".rstrip())
