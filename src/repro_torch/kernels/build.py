"""Build the CUDA kernels at first use and load them with ctypes.

Each source under kernels/csrc/ compiles with nvcc into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds);
the `.cuh` headers beside them hold device code the sources share.
Libraries go into `build/kernels/` at the root of the checkout, named by a
digest of the source and the flags, so an edited source rebuilds and an
unchanged one loads from disk. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's report (ptxas registers, shared memory, spills) of every library
#: this process built, by source name.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc was not found on PATH or under "
                           "/usr/local/cuda/bin; the CUDA kernels cannot "
                           "be built")
    return found


def library_path(source: str) -> Path:
    """Where the library built from csrc/<source> lives. The digest covers
    the source, every shared header under csrc/ and the flags."""
    src = (CSRC / source).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless its library is already on disk."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        BUILD_LOGS[source] = proc.stderr
        os.replace(tmp, out)             # atomic: readers never see a partial
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built first if needed."""
    return ctypes.CDLL(str(build(source)))


def build_all() -> dict[str, Path]:
    """Compile every source under csrc/ at once, one nvcc each."""
    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


@functools.cache
def bind(source: str, name: str, argtypes: tuple) -> tuple:
    """(launch, error) C functions of the library of csrc/<source>:
    `<name>_launch`, taking `argtypes` and returning an int status, and
    `<name>_error`, naming a status."""
    lib = load(source)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = list(argtypes)
    launch.restype = ctypes.c_int
    error = getattr(lib, f"{name}_error")
    error.argtypes = [ctypes.c_int]
    error.restype = ctypes.c_char_p
    return launch, error


def check_status(name: str, status: int, error) -> None:
    """Raise RuntimeError unless a launch returned 0."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + error(status).decode())
