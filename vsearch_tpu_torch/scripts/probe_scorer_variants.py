"""Kernel #3's function in three layouts of the bits, and the plane
form's time split (counterpart of ``scripts/probe_scorer_variants.py``).

    python -m vsearch_tpu_torch.scripts.probe_scorer_variants
        [--rows 2000000] [--b 1024] [--device cpu]

At the TPU probe's shape (2,000,000 rows whose bits are set with
probability 2^-8 each over V = 30,522, ~119 ids a row; B = 1,024 random
queries of 768 ids; bucket 8) it times the fused score-and-bucket
function three ways: ``v0_current`` as kernel #3's gather form (the TPU's
v0, whose twin ``v2_twoacc`` only asked a question of the TPU's compiler),
``plane`` as #3's plane form (``num_cols`` V), and ``v3_transpose`` as P5
(``ops.probes.bucket_keys_t``) over the words_T that P2 packs from the
same rows. The TPU's v3 took pair-interleaved queries scaled by 1/2, an
artifact of ``pltpu.bitcast``; P5 takes the ordinary qT [VP, B]. The
three and P5's timing-only variant (``bucket_keys_t_decode_only``: the
words read and decoded, no gathers or adds) run in turns, the median of
``TURN_ROUNDS`` rounds (``v3_split`` says what binds P5). Each row
reports ms, the function's bound, and the TPU probe's "TF/s equivalent"
(2 * B * N_pad * VP / time) and queries/s equivalent; ``v3_long_rows``
counts the rows that took P5's long-row path there, and ``long_check``
holds P5 against #3's gather form on rows longer than its lists.

Then the plane form's two streams of work, on the shape where PERF.md
asked which binds it (a 262,144-row block of 768 ids, V' = 29,523, B =
32, bucket 8): the shipped kernel against ``plane_operand_only`` (the
words loaded, no fragments built) and ``plane_fragments_only`` (the
operand ring filled once), in turns, the median of 5 rounds of 20
launches each (``ops.probes.plane_variant``). Those two are timing-only;
their keys are never used.

First, the TPU probe's small check (4,096 rows of ~1% density, bucket 1,
128 queries): P5's decoded scores against an f32 reference, and P5, P2
and #3 held against their plain versions on dyadic weights, bit for bit.
"""
from __future__ import annotations

import torch

from ..ops import bitpack, probes
from ..ops.bitpack import BUCKET, _prepare_bf16
from . import common

N, B = 2_000_000, 1024
V = common.V_BERT
V_DENSE, DENSE_ROWS, DENSE_IDS, DENSE_B = 29523, 1 << 18, 768, 32
CHECK_ROWS, CHECK_B, CHECK_P = 4096, 128, 0.01
SPLIT_ROUNDS, SPLIT_ITERS = 5, 20
TURN_ROUNDS = 5  # rounds of the three layouts and P5's variant in turns
# rows longer than P5's lists (probes.KEYS_T_CAP): ~400 ids a row of
# 30,522, up to 640
LONG_ROWS, LONG_P, LONG_PAD, LONG_B = 8192, 2.0 ** -6.25, 640, 45


def small_check(dev, seed: int, rows: int = CHECK_ROWS) -> dict:
    """The TPU probe's check (``correctness_check``), against the plain
    versions: bucket 1, so each key is one row's score."""
    cols, nnz = common.bernoulli_ell(rows, V, seed + 7, dev,
                                      p=CHECK_P, nnz_pad=448)
    words_t = probes.pack_bits_t(cols, nnz, V)
    vp = words_t.shape[0] * 32
    q = common.make_queries(CHECK_B, V, seed + 8, dev)
    qT = _prepare_bf16(q, vp)
    keys = probes.bucket_keys_t(words_t, qT, rows, bucket=1)
    got = common.key_scores(keys)
    dense = bitpack._unpack_rows(words_t.T.contiguous())[:, :V].float()
    ref = (dense @ qT[:V].float()).clamp_min(0.0)
    err = float(((got - ref).abs() / ref.clamp_min(1.0)).max())
    dy = common.dyadic_operand(vp, V, CHECK_B, seed + 9, dev)
    return {
        "check": "v3_vs_plain", "rows": rows, "b": CHECK_B,
        "ok": bool(torch.allclose(got, ref, rtol=3e-2, atol=1e-2)),
        "max_rel_err": err,
        "pack_t_bit_identical": bool(torch.equal(
            words_t, probes.pack_bits_t_plain(cols, nnz, V))),
        "keys_t_bit_identical_dyadic": bool(torch.equal(
            probes.bucket_keys_t(words_t, dy, rows, bucket=1),
            probes.bucket_keys_t_plain(words_t, dy, rows, bucket=1))),
    }


def long_check(dev, seed: int, rows: int = LONG_ROWS) -> dict:
    """P5 on rows longer than its lists (``probes.KEYS_T_CAP`` ids): keys
    equal to #3's gather form's on random weights, and to the plain keys
    on dyadic ones, at buckets 1 and 8; on the card the rows that took
    the long path, against those of more than ``KEYS_T_CAP`` ids."""
    cols, nnz = common.bernoulli_ell(rows, V, seed + 10, dev, p=LONG_P,
                                      nnz_pad=LONG_PAD)
    words = bitpack.pack_bits(cols, nnz, V)
    words_t = probes.pack_bits_t(cols, nnz, V)
    vp = words.shape[1] * 32
    n = rows - 5  # ragged: the last block's tail past num_rows
    qT = _prepare_bf16(common.make_queries(LONG_B, V, seed + 11, dev), vp)
    dyT = common.dyadic_operand(vp, V, LONG_B, seed + 12, dev)
    before = probes.keys_t_long_rows(dev) if dev.type == "cuda" else None
    out = {"rows": rows, "num_rows": n, "b": LONG_B,
           "max_ids": int(nnz.max()), "cap": probes.KEYS_T_CAP,
           "rows_past_cap": int((nnz[:n] > probes.KEYS_T_CAP).sum())}
    for bucket in (1, 8):
        got = probes.bucket_keys_t(words_t, qT, n, bucket)
        out[f"b{bucket}_equals_gather"] = bool(torch.equal(
            got, bitpack.bucket_keys(words, qT, n, bucket)))
        out[f"b{bucket}_bit_identical_dyadic"] = bool(torch.equal(
            probes.bucket_keys_t(words_t, dyT, n, bucket),
            probes.bucket_keys_t_plain(words_t, dyT, n, bucket)))
    # four launches, each counting every live row past the capacity once
    out["launches"] = 4
    out["long_rows_counted"] = (None if before is None else
                                probes.keys_t_long_rows(dev) - before)
    return out


def tflops(b: int, n_pad: int, vp: int, ms):
    return None if ms is None else 2.0 * b * n_pad * vp / (ms * 1e-3) / 1e12


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=N)
        ap.add_argument("--b", type=int, default=B)
        ap.add_argument("--dense-rows", type=int, default=DENSE_ROWS)
        ap.add_argument("--check-rows", type=int, default=CHECK_ROWS)
        ap.add_argument("--long-rows", type=int, default=LONG_ROWS)

    args, dev, out = common.start(__doc__, argv, add)
    out["small_check"] = small_check(dev, args.seed, args.check_rows)

    # -- the three layouts at the TPU probe's shape ---------------------------
    n, b = args.rows, args.b
    cols, nnz = common.bernoulli_ell(n, V, args.seed, dev)
    words = bitpack.pack_bits(cols, nnz, V)
    words_t = probes.pack_bits_t(cols, nnz, V)
    out["pack_checks"] = common.pack_checks(cols, nnz, V, words, words_t)
    n_bits = int(nnz.sum())
    del cols, nnz
    n_pad, nw = words.shape
    vp = nw * 32
    qT = _prepare_bf16(common.make_queries(b, V, args.seed + 1, dev), vp)
    dyT = common.dyadic_operand(vp, V, b, args.seed + 2, dev)
    runs = {
        "v0_current": lambda t: bitpack.bucket_keys(words, t, n, BUCKET),
        "plane": lambda t: bitpack.bucket_keys(words, t, n, BUCKET, V,
                                               _form="plane"),
        "v3_transpose": lambda t: probes.bucket_keys_t(words_t, t, n,
                                                       BUCKET),
    }
    long_before = (probes.keys_t_long_rows(dev) if dev.type == "cuda"
                   else None)
    keys = {name: fn(qT) for name, fn in runs.items()}
    long_rows = (None if long_before is None else
                 probes.keys_t_long_rows(dev) - long_before)
    plain = bitpack.bucket_keys_plain(words, qT, n, BUCKET)
    plain_dy = bitpack.bucket_keys_plain(words, dyT, n, BUCKET)
    nbytes = words.numel() * 4 + qT.numel() * 2 + plain.numel() * 4
    scale = float(common.key_scores(plain).max())
    plain_ms = common.time_ms(
        lambda: bitpack.bucket_keys_plain(words, qT, n, BUCKET), dev, 1,
        warm=False)
    geom = probes.keys_t_geometry(n_pad, BUCKET, b, nw)
    turns = common.in_turns(dict(
        {name: (lambda fn=fn: fn(qT)) for name, fn in runs.items()},
        v3_decode_only=lambda: probes.bucket_keys_t_decode_only(
            words_t, qT, n, BUCKET)), dev, TURN_ROUNDS,
        max(1, args.iters // 4))
    rows = []
    for name, fn in runs.items():
        ms = turns[name]
        dec = (common.key_scores(keys[name])
               - common.key_scores(plain)).abs().max()
        rows.append({
            "variant": name, "ms": ms, "rounds_ms": turns[f"{name}_rounds"],
            "plain_ms": plain_ms,
            "tflops_equiv": tflops(b, n_pad, vp, ms),
            "qps_equiv": None if ms is None else b / (ms * 1e-3),
            **common.bound(nbytes, n_bits * b),
            "max_abs_err": float(dec), "decoded_within": float(dec) <= 2.0
            ** -12 * scale,
            "bit_identical_dyadic": bool(torch.equal(fn(dyT), plain_dy))})
    out.update({
        "n": n, "b": b, "v": V, "bucket": BUCKET,
        "mean_ids": n_bits / n, "rows": rows,
        "v3_equals_v0": bool(torch.equal(keys["v3_transpose"],
                                         keys["v0_current"])),
        "v3_long_rows": long_rows,
        "v3_split": {"shipped_ms": turns["v3_transpose"],
                     "decode_only_ms": turns["v3_decode_only"],
                     "decode_only_rounds_ms": turns["v3_decode_only_rounds"],
                     "sweep_ms": None if turns["v3_decode_only"] is None
                     else turns["v3_transpose"] - turns["v3_decode_only"],
                     "geometry": {k: getattr(geom, k) for k in (
                         "grid", "tiles", "cap", "warps", "queries",
                         "smem")},
                     "qT_gather_bytes": n_bits * qT.shape[1] * 2}})
    del words, words_t, keys, plain, plain_dy, qT, dyT
    out["long_check"] = long_check(dev, args.seed, args.long_rows)

    # -- the plane form's two streams of work (768 ids, B = 32) --------------
    m = args.dense_rows
    cols, nnz, _ = common.alpha_rows(m, V_DENSE, DENSE_IDS, args.seed + 3,
                                      dev)
    words = bitpack.pack_bits(cols, nnz, V_DENSE)
    del cols, nnz
    vp = words.shape[1] * 32
    qT = _prepare_bf16(common.make_queries(DENSE_B, V_DENSE, args.seed + 4,
                                            dev), vp)
    dyT = common.dyadic_operand(vp, V_DENSE, DENSE_B, args.seed + 5, dev)
    shipped = bitpack.bucket_keys(words, dyT, m, BUCKET, V_DENSE,
                                  _form="plane")
    want = bitpack.bucket_keys_plain(words, dyT, m, BUCKET)
    split = {"rows": m, "ids": DENSE_IDS, "v": V_DENSE, "b": DENSE_B,
             "shipped_bit_identical_dyadic": bool(torch.equal(shipped,
                                                              want)),
             **common.bound(words.numel() * 4 + qT.numel() * 2
                             + want.numel() * 4, m * DENSE_IDS * DENSE_B),
             "plain_ms": common.time_ms(
                 lambda: bitpack.bucket_keys_plain(words, qT, m, BUCKET),
                 dev, 1, warm=False)}
    runs = {
        "shipped": lambda: bitpack.bucket_keys(words, qT, m, BUCKET, V_DENSE,
                                               _form="plane"),
        "operand_only": lambda: probes.plane_variant(
            "plane_operand_only", words, qT, m, BUCKET, V_DENSE),
        "fragments_only": lambda: probes.plane_variant(
            "plane_fragments_only", words, qT, m, BUCKET, V_DENSE)}
    # the three in turns, SPLIT_ROUNDS rounds of SPLIT_ITERS launches each:
    # ~1 ms a launch, so a few launches alone would read the clocks' ramp
    # as much as the kernels
    turns = common.in_turns(runs, dev, SPLIT_ROUNDS, SPLIT_ITERS)
    for name in runs:
        split[f"{name}_ms"] = turns[name]
        split[f"{name}_rounds_ms"] = turns[f"{name}_rounds"]
    out["plane_split"] = split
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
