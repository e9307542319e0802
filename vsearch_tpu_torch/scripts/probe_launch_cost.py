"""Where the host time of one kernel call goes, and P1 against its plain
expression (the port's own probe; the TPU repo has no counterpart).

    python -m vsearch_tpu_torch.scripts.probe_launch_cost [--device cpu]

A kernel call of the port runs its wrapper (checks, the output's
allocation), then ``ops.cuda_build.launch``, the one launch path of every
kernel, then the ctypes call of the kernel's C entry point. This probe
times each of those by the host clock (``time.perf_counter`` over
``--calls`` calls, in batches of ``BATCH`` issued without a synchronise
so that the device queue never fills, the variants in turns) for two
kernels: P1 (``probes.bitcast_rows``) at the TPU probe's [8, 128], whose
device work is nil, and #2 (``bitpack.score_bits``) at the alpha path's
fallback shape (4,096 rows of 64 ids, B = 32). Beside them: the
uncached launch path that every call took before the launch cache,
replayed (a device guard, the C function looked up and its ctypes
signature set, a ``Stream`` object built, on every call), and its three
parts alone.

Then P1's device time against its plain expression by CUDA events, in
turns (the median of ``ROUNDS`` rounds of ``ROUND_CALLS`` calls), at
[8, 128] and at [65,536, 1,024] u32 (256 MiB in, 256 MiB out), with P1
held bit for bit against the plain expression at both shapes and at the
ragged [4,099, 1,030].
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict, Optional

import torch

from ..ops import bitpack, cuda_build, probes
from . import common

SMALL = (8, 128)
LARGE = (65536, 1024)
RAGGED = (4099, 1030)
CALLS = 10000
BATCH = 200  # calls issued between synchronises
ROUNDS, ROUND_CALLS = 5, 2000
S2_ROWS, S2_IDS, S2_B = 4096, 64, 32  # #2 at the fallback's shape
CARD_ONLY = ("p1_launch", "p1_legacy_launch", "p1_ctypes", "guard",
             "lookup_and_type", "stream_object", "s2_launch",
             "s2_legacy_launch")


def legacy_lookup(name: str):
    """The C function of kernel ``name`` looked up and typed, as the
    uncached ``cuda_build.kernel_fn`` did on every call."""
    kernel = cuda_build.KERNELS[name]
    fn = getattr(cuda_build._libs[name], kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return fn


def legacy_launch(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    """The uncached ``cuda_build.launch``, replayed for timing: a device
    guard, the C function looked up and typed, a ``Stream`` object, then
    the call. It counts nothing (the wrappers' counters are the
    port's)."""
    with torch.cuda.device(out.device):
        err = legacy_lookup(name)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"'{name}' failed to launch: cudaError {err}")
    return out


def guard(t: torch.Tensor) -> None:
    """A device guard on ``t``'s device, entered and left."""
    with torch.cuda.device(t.device):
        pass


def host_us(fns: Dict[str, Callable], dev: torch.device, calls: int
            ) -> Dict[str, Optional[float]]:
    """Mean host microseconds a call of each of ``fns``, by
    ``time.perf_counter`` over ``calls`` calls in batches of ``BATCH``,
    the functions in turns batch by batch; the synchronise after each
    batch is not timed. None on the CPU."""
    if dev.type != "cuda":
        for fn in fns.values():
            fn()
        return dict.fromkeys(fns)
    for fn in fns.values():  # warm-up
        fn()
    common.sync(dev)
    total = dict.fromkeys(fns, 0.0)
    for _ in range(max(1, calls // BATCH)):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(BATCH):
                fn()
            total[name] += time.perf_counter() - t0
            common.sync(dev)
    n = max(1, calls // BATCH) * BATCH
    return {name: t / n * 1e6 for name, t in total.items()}


def words(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """Random u32 words (int32 bit patterns) of ``shape``."""
    gen = common.generator(dev, seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                         device=dev, dtype=torch.int32)


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--calls", type=int, default=CALLS)
        ap.add_argument("--large", default="%d,%d" % LARGE,
                        help="rows,words of P1's large shape")

    args, dev, out = common.start(__doc__, argv, add)
    cuda = dev.type == "cuda"

    # -- P1 at [8, 128]: the host's part of a call --------------------------
    x = words(SMALL, args.seed, dev)
    y = probes.bitcast_rows(x)
    fns = {"p1_wrapper": lambda: probes.bitcast_rows(x),
           "p1_plain": lambda: probes.bitcast_rows_plain(x)}
    if cuda:
        p1 = (x.data_ptr(), y.data_ptr(), SMALL[0], SMALL[1])
        fn = cuda_build.kernel_fn("bitcast_rows")
        stream = torch.cuda.current_stream().cuda_stream
        fns.update({
            "p1_launch": lambda: cuda_build.launch("bitcast_rows", y, *p1),
            "p1_legacy_launch": lambda: legacy_launch("bitcast_rows", y,
                                                      *p1),
            "p1_ctypes": lambda: fn(*p1, stream),
            # the legacy path's three parts alone
            "guard": lambda: guard(y),
            "lookup_and_type": lambda: legacy_lookup("bitcast_rows"),
            "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
        })
    launch = host_us(fns, dev, args.calls)

    # -- #2 at the fallback's shape: the same paths on a main-path kernel --
    cols, nnz = common.stratified_ell(S2_ROWS, common.V_BERT, args.seed + 1,
                                      dev, nnz_pad=S2_IDS, nnz_lo=S2_IDS,
                                      nnz_hi=S2_IDS)
    w2 = bitpack.pack_bits(cols, nnz, common.V_BERT)
    vp = w2.shape[1] * 32
    qT = bitpack._prepare_bf16(common.make_queries(S2_B, common.V_BERT,
                                                   args.seed + 2, dev), vp)
    s2 = bitpack.score_bits(w2, qT)
    fns = {"s2_wrapper": lambda: bitpack.score_bits(w2, qT)}
    if cuda:
        g = bitpack.score_geometry(w2.shape[0], S2_B, w2.shape[1])
        a2 = (w2.data_ptr(), qT.data_ptr(), s2.data_ptr(), w2.shape[0],
              w2.shape[1], S2_B, qT.shape[1], *g.c_args())
        fns.update({
            "s2_launch": lambda: cuda_build.launch("scores", s2, *a2),
            "s2_legacy_launch": lambda: legacy_launch("scores", s2, *a2)})
    launch.update(host_us(fns, dev, args.calls))
    for name in CARD_ONLY:  # launched only on the card
        launch.setdefault(name, None)
    out["host_us_a_call"] = launch
    out["calls"] = args.calls
    out["s2_shape"] = {"rows": S2_ROWS, "ids": S2_IDS, "b": S2_B}

    # -- P1's device time against the plain expression, and its checks -----
    checks = {}
    large = tuple(int(v) for v in args.large.split(","))
    for label, shape in (("small", SMALL), ("large", large),
                         ("ragged", RAGGED)):
        xs = words(shape, args.seed + 3, dev)
        # by bit patterns: random words hold NaNs
        checks[label] = dict(shape=list(shape), **common.compare(
            probes.bitcast_rows(xs).view(torch.int16),
            probes.bitcast_rows_plain(xs).view(torch.int16)))
        if label == "ragged":
            continue
        t = common.in_turns({"p1": lambda: probes.bitcast_rows(xs),
                             "plain": lambda: probes.bitcast_rows_plain(xs)},
                            dev, ROUNDS, ROUND_CALLS if cuda else 1)
        checks[label].update(
            p1_ms=t["p1"], p1_rounds_ms=t["p1_rounds"], plain_ms=t["plain"],
            plain_rounds_ms=t["plain_rounds"],
            **common.bound(xs.numel() * 4 * 2))
        del xs
    out["p1"] = checks
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
