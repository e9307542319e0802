"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. All sources build at once, one
``nvcc`` process each, into the git-ignored ``vsearch_tpu_torch/_build/``
directory; a library is rebuilt when its source or a header is newer.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
SOURCES = {"pack": "pack.cu", "scores": "scores.cu",
           "bucketed": "bucketed.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# wall seconds and compiler output of the last build
last_build: Dict[str, object] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pack": ("vs_pack_ell", [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    "scores": ("vs_bitpack_scores", [_P, _P, _P, _L, _I, _I, _I, _P]),
    "bucketed": ("vs_bucketed_keys", [_P, _P, _P, _L, _L, _I, _I, _I, _I,
                                      _P]),
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build from source at first use")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(_CSRC, SOURCES[name])] + glob.glob(
        os.path.join(_CSRC, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build_all(verbose: bool = False, force: bool = False) -> float:
    """Compile every stale kernel library concurrently; raise with the
    compiler's output if any fails. ``verbose`` adds ``-Xptxas -v`` (the
    register and shared-memory report lands in ``last_build``). Returns
    the wall seconds of the build (0.0 when nothing was stale)."""
    with _LOCK:
        names = [n for n in SOURCES if force or _stale(n)]
        if not names:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        extra = ["-Xptxas", "-v"] if verbose else []
        t0 = time.perf_counter()
        procs = {}
        for n in names:
            tmp = _lib_path(n) + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", _CSRC, "-o", tmp,
                   os.path.join(_CSRC, SOURCES[n])]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = {}, []
        for n, (tmp, p) in procs.items():
            logs[n] = p.communicate()[0]
            if p.returncode:
                failed.append(n)
            else:
                os.replace(tmp, _lib_path(n))
        secs = time.perf_counter() - t0
        last_build.clear()
        last_build.update(seconds=secs, logs=logs)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return secs


def kernel_fn(name: str):
    """The C entry point of kernel ``name`` (building the libraries first
    if needed), with its ctypes signature set."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(_lib_path(name))
        _libs[name] = lib
    sym, argtypes = _SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn

