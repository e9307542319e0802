"""Build, load and launch the port's CUDA kernels.

``KERNELS`` is the one table of them: each kernel's source, C entry point
and ctypes argument types. Each ``csrc/*.cu`` source compiles with
``nvcc`` into its own shared library with a plain C interface, loaded
with ``ctypes``: no PyTorch headers, so a build takes seconds. All sources
build at once, one ``nvcc`` process each, into the git-ignored
``vsearch_tpu_torch/_build/`` directory; a library is rebuilt when its
source or a header is newer. Nothing here runs at import time: the CPU
tests import every module.

Each kernel wrapper (``ops/bitpack.py``, ``ops/probes.py``, ``ops/ssd.py``)
runs its plain PyTorch twin when ``uses_plain`` says its inputs lie on the
CPU, else ``launch``es the kernel, which counts the launch in
``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


class Kernel(NamedTuple):
    source: str  # under csrc/
    symbol: str  # the C entry point; its last argument is the stream
    argtypes: List[type]


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS: Dict[str, Kernel] = {
    "pack": Kernel("pack.cu", "vs_pack_ell",
                   [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    # (words, qT, out, n_pad, num_words, b, b_pad, grid_x), grid_x from
    # bitpack.score_geometry
    "scores": Kernel("scores.cu", "vs_bitpack_scores",
                     [_P, _P, _P, _L] + [_I] * 4 + [_P]),
    # (words, qT, keys, num_rows, num_words, b, b_pad, kb, grid_x), grid_x
    # from bitpack.fold_geometry
    "bucketed": Kernel("bucketed.cu", "vs_bucketed_keys",
                       [_P, _P, _P, _L] + [_I] * 5 + [_P]),
    # (words, q8T, keys, num_rows, num_words, b, b_pad, kb, lane_q,
    # grid_x), the last three from bitpack.int8_fold_geometry
    "int8_bucketed": Kernel("int8_bucketed.cu", "vs_int8_bucketed_keys",
                            [_P, _P, _P, _L] + [_I] * 6 + [_P]),
    # (words, qI, out, n_pad, num_words, nplanes, b, b_pad, grid_x),
    # nplanes and grid_x from bitpack.plane_geometry
    "scores_plane": Kernel("scores_plane.cu", "vs_bitpack_scores_plane",
                           [_P, _P, _P, _L] + [_I] * 5 + [_P]),
    # (words, qI, keys, num_rows, n_pad, num_words, nplanes, b, b_pad, kb,
    # split, grid_x)
    "bucketed_plane": Kernel("bucketed_plane.cu", "vs_bucketed_keys_plane",
                             [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # the probe kernels (ops/probes.py; vsearch_tpu_torch/scripts)
    # (x, out, s, l)
    "bitcast_rows": Kernel("probe_bitcast.cu", "vs_bitcast_rows",
                           [_P, _P, _L, _I, _P]),
    # (cols, nnz, words_t, n, n_pad, nnz_pad, v, num_words)
    "pack_t": Kernel("pack_t.cu", "vs_pack_ell_t",
                     [_P, _P, _P, _L, _L, _I, _I, _I, _P]),
    # (words_t, qT, keys, state, num_rows, n_pad, num_words, b, b_pad,
    # bucket, cap, grid_x, smem), the last three from
    # probes.keys_t_geometry
    "bucketed_t": Kernel("bucketed_t.cu", "vs_bucketed_keys_t",
                         [_P, _P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    "bucketed_t_decode_only": Kernel(
        "bucketed_t_decode_only.cu", "vs_bucketed_keys_t_decode_only",
        [_P, _P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # the arguments of "bucketed_plane"
    "plane_operand_only": Kernel("plane_operand_only.cu",
                                 "vs_plane_operand_only",
                                 [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    "plane_fragments_only": Kernel("plane_fragments_only.cu",
                                   "vs_plane_fragments_only",
                                   [_P, _P, _P, _L, _L] + [_I] * 7 + [_P]),
    # the granite trunk's Mamba-2 chunk scan (ops/ssd.py): (proj, stride,
    # x_off, dt_off, conv_w, conv_b, dt_bias, A_log, D, out, batch, len,
    # heads)
    "ssd_chunk": Kernel("ssd_chunk.cu", "vs_ssd_chunk",
                        [_P, _L, _I, _I] + [_P] * 6 + [_I] * 3 + [_P]),
}

# launches of each kernel since the last reset: a run can show that its
# main path went through the kernels
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# each kernel's C function, looked up and typed once (``kernel_fn``)
_fns: Dict[str, object] = {}
# wall seconds and compiler output of the last build
last_build: Dict[str, object] = {}


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
    deps = [os.path.join(_CSRC, KERNELS[name].source)] + glob.glob(
        os.path.join(_CSRC, "*.cuh"))
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build_all(verbose: bool = False, force: bool = False) -> float:
    """Compile every stale kernel library concurrently; raise with the
    compiler's output if any fails. ``verbose`` adds ``-Xptxas -v`` (the
    register and shared-memory report lands in ``last_build``). Returns
    the wall seconds of the build (0.0 when nothing was stale)."""
    with _LOCK:
        names = [n for n in KERNELS if force or _stale(n)]
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
                   os.path.join(_CSRC, KERNELS[n].source)]
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
        fn = getattr(lib, KERNELS[name].symbol)
        fn.argtypes = KERNELS[name].argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def occupancy(name: str) -> int:
    """CTAs of kernel ``name`` (#2-#4 in either form, P5 at bucket 8 and
    ``probes.KEYS_T_CAP``, and the timing variants) that one SM of the
    current device holds at once, as the CUDA runtime works them out from
    the kernel's registers and shared memory."""
    kernel_fn(name)  # builds and loads the library
    fn = getattr(_libs[name], KERNELS[name].symbol + "_occupancy")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"occupancy of '{name}': cudaError {err}")
    return ctas.value


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def uses_plain(name: str, *inputs: Tuple[torch.Tensor, torch.dtype]
               ) -> bool:
    """True when the inputs lie on the CPU (the plain version runs).
    For CUDA inputs, check what the kernel takes and return False; raise
    for any other device, a device mismatch, a dtype or a layout the
    kernel does not take."""
    first = inputs[0][0]
    if not first.is_cuda:
        if first.device.type == "cpu":
            return True
        raise ValueError(f"{name}: unsupported device {first.device}")
    dev = first.get_device()
    for t, dtype in inputs:
        if t.get_device() != dev:
            raise ValueError(f"{name}: inputs on {t.device} and "
                             f"{first.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return False


# The current device's index, and the current stream of a device index as
# a raw handle without building a ``torch.cuda.Stream`` (where this build
# of PyTorch offers them; both read the same state as the public calls)
_current_device = (getattr(torch._C, "_cuda_getDevice", None)
                   or torch.cuda.current_device)
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda index: torch.cuda.current_stream(index)
                   .cuda_stream))


def launch(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream of ``out``'s device,
    raise if the launch failed, and count it. A device guard is entered
    only when ``out`` lies on another device than the current one (the
    mesh paths' shards)."""
    fn = kernel_fn(name)
    dev = out.get_device()
    if dev == _current_device():
        err = fn(*args, _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _raw_stream(dev))
    if err:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    return out
