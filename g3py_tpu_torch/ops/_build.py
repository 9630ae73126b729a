"""Compiling and loading the port's CUDA kernel libraries (internal).

Each source under ``csrc/`` is compiled with ``nvcc`` for sm_90a into a
shared library with a plain C interface, at first use on a CUDA tensor,
into ``build/g3py_tpu_torch/`` beside the package, keyed by a hash of the
source and flags, and loaded with ``ctypes``.  :func:`build` starts one
``nvcc`` per source, all at once, and loads every library; a missing
``nvcc`` or a failed build raises — there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import namedtuple
from pathlib import Path

__all__ = ["KernelBuild", "build", "library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "g3py_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: library name -> its source file under csrc/
SOURCES = {"stationary_gram": "stationary_gram.cu",
           "panel_cholesky": "panel_cholesky.cu"}

KernelBuild = namedtuple("KernelBuild", "path seconds log cached")

_lock = threading.Lock()
_libraries = {}  # name -> (ctypes.CDLL, KernelBuild) once built and loaded


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise FileNotFoundError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from csrc/ at first use on a CUDA tensor")


def build():
    """Compile (once per source hash, all sources in parallel) and load every
    kernel library; returns ``{name: KernelBuild}``.  Raises when nvcc is
    missing or a build fails."""
    with _lock:
        if len(_libraries) == len(SOURCES):
            return {name: rec for name, (_, rec) in _libraries.items()}
        t0 = time.perf_counter()
        jobs = {}
        for name, fname in SOURCES.items():
            src = _CSRC / fname
            key = hashlib.sha256(src.read_bytes()
                                 + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
            path = _BUILD_DIR / f"{name}_{key}.so"
            proc = tmp = None
            if not path.is_file():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
            jobs[name] = (src, path, tmp, proc)
        failed = []
        for name, (src, path, tmp, proc) in jobs.items():
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"nvcc failed building {src}:\n{log}")
                    continue
                os.replace(tmp, path)
            rec = KernelBuild(str(path), time.perf_counter() - t0, log, proc is None)
            _libraries[name] = (ctypes.CDLL(str(path)), rec)
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: rec for name, (_, rec) in _libraries.items()}


def library(name):
    """The loaded ``ctypes.CDLL`` of kernel library ``name`` (building all
    libraries at first use)."""
    hit = _libraries.get(name)
    if hit is None:
        build()
        hit = _libraries[name]
    return hit[0]
