"""Build the CUDA kernels from the sources in ``kernels/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>-<hash>.so`` under
the checkout's root (a directory ``.gitignore`` lists), then loaded with
``ctypes``. The file name carries a hash of the source and flags, so an
edited source is rebuilt and a current one is reused. :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load_library", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("block_gather_matmul_fused",)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``, then ``PATH``. Raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (target, process, temporary
    output), the last two None when the target is already built."""
    target = _target(name)
    if target.is_file():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, proc, tmp


def _finish(name, target, proc, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent builder sees all or nothing
    return log


def build_all() -> dict:
    """Build every source in :data:`SOURCES` in parallel; returns the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills) per
    source, empty for sources already built."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, *started[name]) for name in SOURCES}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        target, proc, tmp = _start(name)
        _finish(name, target, proc, tmp)
        lib = ctypes.CDLL(str(target))
        _LOADED[name] = lib
    return lib
