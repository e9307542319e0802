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
           "bucketed": "bucketed.cu", "int8_bucketed": "int8_bucketed.cu",
           "scores_plane": "scores_plane.cu",
           "bucketed_plane": "bucketed_plane.cu",
           # the probe kernels (ops/probes.py; vsearch_tpu_torch/scripts)
           "bitcast_rows": "probe_bitcast.cu", "pack_t": "pack_t.cu",
           "bucketed_t": "bucketed_t.cu",
           "bucketed_t_decode_only": "bucketed_t_decode_only.cu",
           "plane_operand_only": "plane_operand_only.cu",
           "plane_fragments_only": "plane_fragments_only.cu",
           # the granite trunk's Mamba-2 chunk scan (ops/ssd.py)
           "ssd_chunk": "ssd_chunk.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# each kernel's C function, looked up and typed once (``kernel_fn``)
_fns: Dict[str, object] = {}
# wall seconds and compiler output of the last build
last_build: Dict[str, object] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pack": ("vs_pack_ell", [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    # (words, qT, out, n_pad, num_words, b, b_pad, grid_x), grid_x from
    # bitpack.score_geometry
    "scores": ("vs_bitpack_scores", [_P, _P, _P, _L] + [_I] * 4 + [_P]),
    # (words, qT, keys, num_rows, num_words, b, b_pad, kb, grid_x), grid_x
    # from bitpack.fold_geometry
    "bucketed": ("vs_bucketed_keys", [_P, _P, _P, _L] + [_I] * 5 + [_P]),
    # (words, q8T, keys, num_rows, num_words, b, b_pad, kb, lane_q,
    # grid_x), the last three from bitpack.int8_fold_geometry
    "int8_bucketed": ("vs_int8_bucketed_keys",
                      [_P, _P, _P, _L] + [_I] * 6 + [_P]),
    # (words, qI, out, n_pad, num_words, nplanes, b, b_pad, grid_x),
    # nplanes and grid_x from bitpack.plane_geometry
    "scores_plane": ("vs_bitpack_scores_plane",
                     [_P, _P, _P, _L] + [_I] * 5 + [_P]),
    # (words, qI, keys, num_rows, n_pad, num_words, nplanes, b, b_pad, kb,
    # split, grid_x)
    "bucketed_plane": ("vs_bucketed_keys_plane",
                       [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # (x, out, s, l)
    "bitcast_rows": ("vs_bitcast_rows", [_P, _P, _L, _I, _P]),
    # (cols, nnz, words_t, n, n_pad, nnz_pad, v, num_words)
    "pack_t": ("vs_pack_ell_t", [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    # (words_t, qT, keys, state, num_rows, n_pad, num_words, b, b_pad,
    # bucket, cap, grid_x, smem), the last three from
    # probes.keys_t_geometry
    "bucketed_t": ("vs_bucketed_keys_t", [_P, _P, _P, _P, _L, _L]
                   + [_I] * 7 + [_P]),
    "bucketed_t_decode_only": ("vs_bucketed_keys_t_decode_only",
                               [_P, _P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # the arguments of "bucketed_plane"
    "plane_operand_only": ("vs_plane_operand_only",
                           [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    "plane_fragments_only": ("vs_plane_fragments_only",
                             [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # (proj, stride, x_off, dt_off, conv_w, conv_b, dt_bias, A_log, D, out,
    # batch, len, heads)
    "ssd_chunk": ("vs_ssd_chunk", [_P, _L, _I, _I] + [_P] * 6
                  + [_I] * 3 + [_P]),
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
    if needed), with its ctypes signature set. It is looked up and typed
    at the first call and cached: every launch of the port asks for it."""
    fn = _fns.get(name)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def occupancy(name: str) -> int:
    """CTAs of kernel ``name`` (#2-#4 in either form, P5 at bucket 8 and
    ``probes.KEYS_T_CAP``, and the timing variants) that one SM of the
    current device holds at once, as the CUDA runtime works them out from
    the kernel's registers and shared memory."""
    kernel_fn(name)  # builds and loads the library
    fn = getattr(_libs[name], _SIGNATURES[name][0] + "_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"occupancy of '{name}': cudaError {err}")
    return ctas.value
