"""What the port's probes share: arguments, the card's name and power
limit, timing by CUDA events, bounds, the JSON line, checks against the
plain versions, and the synthetic data of the JAX probes, made on the
device from a seed."""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.bitpack import LANES, TILE_BITS, _round_up

# NVIDIA's data sheet of the H100 SXM, dense rates: the bounds' peaks
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_INT8_OPS = 1979e12
V_BERT = 30522  # the uncased BERT vocabulary of the JAX probes
V_PACK = 29523  # bench.py's V' (the shifted vocabulary) of probe_pack
ACTIVE = 768  # query ids of the JAX probes' random queries (VDR's topk)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the probe runs (default cuda; raises when "
                         "CUDA is absent); 'cpu' runs the plain versions "
                         "and times nothing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=8,
                    help="timed repetitions after one warm-up")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    return ap


def device_info(dev: torch.device) -> Dict[str, str]:
    """The device's name, and on the card its power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "not read"
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable, dev: torch.device, iters: int,
            warm: bool = True) -> Optional[float]:
    """Mean device milliseconds of ``fn`` over ``iters`` calls after one
    warm-up (``warm=False``: ``fn`` has just run), by CUDA events. On the
    CPU ``fn`` runs once and nothing is timed (None): a host time is no
    device metric."""
    if warm or dev.type != "cuda":
        fn()
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def in_turns(fns: Dict[str, Callable], dev: torch.device, rounds: int,
             iters: int) -> Dict[str, object]:
    """Device ms a call of each of ``fns``, in turns after a warm-up of
    all: the median of ``rounds`` rounds of ``iters`` calls each
    (``name``) and every round (``name_rounds``), so that the clocks'
    ramp and drift fall on every function alike. None on the CPU."""
    for fn in fns.values():
        fn()
    times: Dict[str, list] = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, dev, iters, warm=False))
    out: Dict[str, object] = {}
    for name, ts in times.items():
        out[name] = None if ts[0] is None else sorted(ts)[len(ts) // 2]
        out[f"{name}_rounds"] = ts
    return out


def wall_s(fn: Callable, dev: torch.device
           ) -> Tuple[Optional[float], object]:
    """(host seconds, result) of one call of ``fn`` that ends in a
    synchronise: for paths that return to the host between launches. On
    the CPU the seconds are None, as ``time_ms``'s."""
    sync(dev)
    t0 = time.perf_counter()
    r = fn()
    sync(dev)
    return (time.perf_counter() - t0 if dev.type == "cuda" else None), r


def per_s(count: float, secs: Optional[float]) -> Optional[float]:
    return None if secs is None else count / secs


def bound(nbytes: float, ops: float = 0.0, peak: float = H100_F32_FLOPS
          ) -> Dict[str, object]:
    """The least time of the work on an H100: its bytes at 3.35 TB/s or
    its operations at ``peak``, the larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(got: torch.Tensor, want: torch.Tensor) -> Dict[str, object]:
    """How a kernel's output stands against its plain version's: bit for
    bit (16-bit floats by their bit patterns, so NaNs compare too) and the
    largest difference."""
    if got.dtype in (torch.bfloat16, torch.float16):
        same = bool(torch.equal(got.view(torch.int16),
                                want.view(torch.int16)))
    else:
        same = bool(torch.equal(got, want))
    if got.dtype in (torch.int32, torch.int64):
        err = 0.0 if same else float((got.long() - want.long()).abs().max())
    else:
        err = float((got.float() - want.float()).abs().max())
    return {"bit_identical": same, "max_abs_err": err}


def pack_checks(cols: torch.Tensor, nnz: torch.Tensor, v: int,
                words: torch.Tensor, words_t: torch.Tensor,
                rows: int = 1 << 18) -> Dict[str, bool]:
    """Kernel #1's words and P2's words_T of one ELL against the plain
    pack and against each other, in slices of ``rows`` rows (the plain
    pack of 2M rows at once would need ~50 GB)."""
    from ..ops.bitpack import pack_bits_plain

    n = cols.shape[0]
    out = {"pack_bit_identical": not bool(words[n:].any()),
           "pack_t_bit_identical": not bool(words_t[:, n:].any()),
           "words_t_equals_words_T": True}
    for s in range(0, n, rows):
        e = min(n, s + rows)
        want = pack_bits_plain(cols[s:e], nnz[s:e], v)[:e - s]
        out["pack_bit_identical"] &= bool(torch.equal(words[s:e], want))
        out["pack_t_bit_identical"] &= bool(torch.equal(words_t[:, s:e],
                                                        want.T))
        out["words_t_equals_words_T"] &= bool(torch.equal(words_t[:, s:e],
                                                          words[s:e].T))
    return out


def key_scores(keys: torch.Tensor) -> torch.Tensor:
    """Kernel #3's keys decoded to scores (low 10 bits cleared), 0 for
    empty keys."""
    return (keys & ~1023).view(torch.float32).clamp_min(0)


def emit(out: dict, path: Optional[str]) -> dict:
    line = json.dumps(out)
    print(line, flush=True)
    if path:
        with open(path, "w") as f:
            f.write(line + "\n")
    return out


def start(doc: str, argv, add=None):
    """Parse ``argv`` with the common arguments (and ``add(ap)``'s), resolve
    the device (raising without CUDA unless ``--device cpu``) and return
    (args, device, the result dict with the device line)."""
    ap = parser(doc)
    if add is not None:
        add(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return args, dev, dict(device_info(dev), seed=args.seed)


# -- synthetic data -----------------------------------------------------------
def generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def make_queries(b: int, v: int, seed: int, dev: torch.device,
                 active: int = ACTIVE) -> torch.Tensor:
    """[b, v] f32: ``active`` distinct random ids a query with U[0, 1)
    weights, as the JAX probes make their queries. Query i depends on
    the seed and i alone, so a smaller batch is a prefix of a larger."""
    active = min(active, v)
    u = torch.rand((b, v + active), generator=generator(dev, seed),
                   device=dev)
    q = torch.zeros((b, v), device=dev)
    return q.scatter_(1, u[:, :v].topk(active, dim=1).indices, u[:, v:])


def dyadic_operand(vp: int, v: int, b: int, seed: int, dev: torch.device
                   ) -> torch.Tensor:
    """[vp, b] bf16 of multiples of 1/16 in [0, 8], zero past ``v``: every
    sum of up to 2^17 of them is exact in f32 in any order, so a kernel
    and its plain version agree bit for bit."""
    gen = generator(dev, seed)
    dy = torch.randint(0, 129, (vp, b), generator=gen, device=dev) / 16.0
    dy[v:] = 0
    return dy.to(torch.bfloat16)


def stratified_ell(n: int, v: int, seed: int, dev: torch.device,
                   nnz_pad: int = 128, nnz_lo: int = 48, nnz_hi: int = 96,
                   dtype: torch.dtype = torch.int32,
                   chunk: int = 1 << 21) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX probes' wiki21m-shaped ELL (``probe_stream.make_host_ell``):
    slot j of a row draws from its own stratum [j * s, (j + 1) * s) of the
    vocabulary (s = v // nnz_pad), so a row's ids are distinct and
    ascending; ``nnz`` uniform in [nnz_lo, nnz_hi]. Made in chunks of
    ``chunk`` rows on ``dev``; ``dtype`` int16 holds uint16 bit patterns
    (the tiers' compact ELL). Returns (cols [n, nnz_pad], nnz [n] int32)."""
    gen = generator(dev, seed)
    stride = v // nnz_pad
    base = torch.arange(nnz_pad, device=dev, dtype=torch.int32) * stride
    cols = torch.empty((n, nnz_pad), dtype=dtype, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        r = torch.randint(0, stride, (m, nnz_pad), generator=gen, device=dev,
                          dtype=torch.int32)
        cols[s:s + m] = (r + base).to(dtype)
    nnz = torch.randint(nnz_lo, nnz_hi + 1, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    return cols, nnz


def bernoulli_ell(n: int, v: int, seed: int, dev: torch.device,
                  p: float = 2.0 ** -8, nnz_pad: int = 192,
                  chunk: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows whose every column is set with probability ``p`` alone (the
    JAX probes' random bits: an AND of 8 random words, ~119 ids a row at
    v = 30,522), as an ELL: each row's ids are the running sums of
    geometric gaps, distinct and ascending, padded with the sentinel ``v``.
    ``nnz_pad`` 192 lies 6.7 standard deviations above the mean count;
    a row would lose only the ids past its 192nd. Returns (cols [n,
    nnz_pad] int32, nnz [n] int32)."""
    gen = generator(dev, seed)
    cols = torch.empty((n, nnz_pad), dtype=torch.int32, device=dev)
    nnz = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        gaps = torch.empty((m, nnz_pad), device=dev,
                           dtype=torch.float64).geometric_(p, generator=gen)
        ids = gaps.cumsum(dim=1) - 1
        inside = ids < v
        cols[s:s + m] = torch.where(inside, ids, v).to(torch.int32)
        nnz[s:s + m] = inside.sum(dim=1).to(torch.int32)
    return cols, nnz


def random_words(n_pad: int, v: int, seed: int, dev: torch.device,
                 chunk: int = 1 << 18) -> torch.Tensor:
    """A bit matrix [n_pad, VP/32] int32 whose bits are set with
    probability 2^-8 each (the AND of 8 random words, as the JAX probes
    fill theirs), with the bits of columns >= ``v`` cleared."""
    gen = generator(dev, seed)
    nw = _round_up(v, TILE_BITS) // 32
    words = torch.empty((n_pad, nw), dtype=torch.int32, device=dev)
    # vocab id of (word w, bit p): (w // 128) * 4096 + p * 128 + w % 128
    w_idx = torch.arange(nw, device=dev)
    p_idx = torch.arange(32, device=dev)
    ids = ((w_idx // LANES) * TILE_BITS + w_idx % LANES)[:, None] \
        + p_idx[None, :] * LANES
    keep = ((ids < v).to(torch.int64) << p_idx).sum(dim=1)
    keep = torch.where(keep >= 2 ** 31, keep - 2 ** 32, keep).to(torch.int32)
    for s in range(0, n_pad, chunk):
        m = min(chunk, n_pad - s)
        acc = None
        for _ in range(8):
            r = torch.randint(0, 256, (m, nw * 4), generator=gen, device=dev,
                              dtype=torch.uint8)
            acc = r if acc is None else acc.bitwise_and_(r)
        words[s:s + m] = acc.view(torch.int32) & keep
    return words


def alpha_rows(n: int, v: int, nnz: int, seed: int, dev: torch.device,
               chunk: int = 1 << 20):
    """Real-valued rows as the JAX package's alpha-at-scale index
    (``bench.py``): ``nnz`` ids a row uniform over ``v``, distinct (a
    duplicate is drawn again), ascending; weights 0.5 + U[0, 1) in bf16.
    Returns (cols [n, nnz] int32, nnz [n] int32, vals [n, nnz] bf16)."""
    gen = generator(dev, seed)
    cols = torch.empty((n, nnz), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        ids = torch.randint(0, v, (m, nnz), generator=gen, device=dev)
        while True:
            ids = ids.sort(dim=1).values
            dup = torch.zeros_like(ids, dtype=torch.bool)
            dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
            if not bool(dup.any()):
                break
            ids = torch.where(dup, torch.randint(0, v, ids.shape,
                                                 generator=gen, device=dev),
                              ids)
        cols[s:s + m] = ids.to(torch.int32)
    vals = (0.5 + torch.rand((n, nnz), generator=gen, device=dev)
            ).to(torch.bfloat16)
    return cols, torch.full((n,), nnz, dtype=torch.int32, device=dev), vals


def ell_scores(q: torch.Tensor, cols: torch.Tensor, nnz: torch.Tensor,
               v: int, vals: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Exact f32 scores [B, n] of queries ``q`` [B, v] over an ELL (int16
    cols are uint16 bit patterns), summed by a gather in chunks of rows:
    the plain reference of the probes' recall, independent of the
    kernels."""
    from ..ops.ell import widen_cols

    n, nnz_pad = cols.shape
    qp = torch.nn.functional.pad(q.float(), (0, 1))  # column v weighs 0
    out = torch.empty((q.shape[0], n), device=q.device)
    pos = torch.arange(nnz_pad, device=q.device)[None, :]
    chunk = max(1, (1 << 28) // (q.shape[0] * nnz_pad))  # 1 GiB gathered
    for s in range(0, n, chunk):
        c = widen_cols(cols[s:s + chunk]).long().clamp(0, v)
        valid = (pos < nnz[s:s + chunk, None]) & (c < v)
        c = torch.where(valid, c, v)
        g = qp[:, c]  # [B, rows, nnz_pad]
        if vals is not None:
            g = g * vals[s:s + chunk].float()[None]
        out[:, s:s + chunk] = g.sum(dim=-1)
    return out


def recall_at(ids: torch.Tensor, scores: torch.Tensor, k: int,
              tol: float) -> float:
    """Share of the returned rows ``ids`` [B, k] whose exact score
    (``scores`` [B, n]) reaches the exact k-th, within ``tol`` of it
    relative (at least 1): the JAX probes' score-tolerance recall."""
    kth = scores.topk(k, dim=1).values[:, -1:]
    got = torch.gather(scores, 1, ids.long().to(scores.device))
    return float((got >= kth - tol * kth.clamp_min(1.0)).float().mean())
