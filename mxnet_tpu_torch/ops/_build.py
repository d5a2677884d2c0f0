"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`)
into a shared library with a plain C interface, which the kernel
wrappers load with ctypes. Nothing is built at import: the first launch
builds what it needs, and `build_all()` builds every source at once, one
`nvcc` process per source, all started together. Libraries land in
`build/kernels/` at the root of the checkout (ignored by git), named by
a digest of their source and flags, so an edited source is rebuilt and
an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"ragged_attention": _PKG / "csrc" / "ragged_attention.cu"}
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise MXNetError("nvcc not found: the CUDA toolkit is needed to "
                         "build the port's kernels")
    return path


def library_path(name):
    """Where the library of source `name` is (or will be) built."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=None):
    """Compile every named source (default: all) whose library is not
    built yet, all nvcc processes in parallel. Returns {name: compiler
    output} for the sources it compiled; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names or SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs[name] = (proc, tmp, out, log)
    logs, failed = {}, []
    for name, (proc, tmp, out, log) in jobs.items():
        proc.wait()
        logs[name] = log.read_text()
        if proc.returncode:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
