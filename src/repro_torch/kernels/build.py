"""Builds the hand-written CUDA kernels at first use and loads them with ctypes.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <name>.cu

The output lives under ``build/kernels/`` at the repository root (ignored by
git) and is named by a hash of the source and flags, so an edited source is
rebuilt and a current one is reused.  ``build_all`` starts one ``nvcc`` per
stale source at once and waits for all of them.  Each build writes a
per-process temporary file and renames it into place, so processes that
build at the same time never load a half-written library.  Pointers and the
stream cross the C boundary as ``c_void_p``; every entry point returns
``cudaGetLastError()`` and ``check`` raises on anything nonzero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

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


class _Build:
    """One running ``nvcc`` of ``csrc/<name>.cu`` into ``out``.  Its output
    goes to a temporary file, so a chatty compiler never blocks on a full
    pipe while the others run."""

    def __init__(self, name: str, out: Path):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.name, self.out = name, out
        self.tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self.log = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(self.tmp),
             str(CSRC / f"{name}.cu")],
            stdout=self.log, stderr=subprocess.STDOUT, text=True)
        self.seconds = None

    def poll(self) -> bool:
        """True once nvcc has exited (and records when it did)."""
        if self.seconds is None and self.proc.poll() is not None:
            self.seconds = time.perf_counter() - self.t0
        return self.seconds is not None

    def finish(self) -> str:
        """Wait, rename the library into place and return nvcc's output;
        raises if nvcc failed."""
        self.proc.wait()
        self.poll()
        self.log.seek(0)
        text = self.log.read()
        self.log.close()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed on {self.name}.cu (exit "
                                   f"{self.proc.returncode}):\n{text}")
        os.replace(self.tmp, self.out)
        return text


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Tuple[str, float]]:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together.  Returns {name: (nvcc output, seconds)}
    for the sources compiled in this call.  Every build is finished (its
    library renamed into place, or its temporary file removed) before the
    first failure is raised."""
    running = [_Build(name, _target(name)) for name in sources()
               if not _target(name).exists()]
    try:
        while not all([b.poll() for b in running]):   # poll every build
            time.sleep(0.05)
    finally:
        for b in running:              # interrupted: stop what still runs
            if b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()
                b.tmp.unlink(missing_ok=True)
    done, errors = {}, []
    for b in running:
        try:
            done[b.name] = (b.finish(), b.seconds)
        except KernelBuildError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _Build(name, out).finish()
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
