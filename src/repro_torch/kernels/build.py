"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Every ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface for ``sm_90a``
(Hopper).  The kernels include no PyTorch header: a source that does takes
minutes to compile where these take seconds, and every run on a fresh machine
builds anew.  Libraries are cached in ``_build/`` (listed in ``.gitignore``)
under a hash of the source and flags, so a second process reuses them.

Nothing here runs at import: the first caller of :func:`library` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: compiler output (``-Xptxas=-v`` registers / shared memory)
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every source not yet cached, one nvcc each, in parallel, and
    load them all.  Returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [s for s in sources() if s.stem not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = _target(src)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in todo:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib
