"""The int8 selection kernel against the bf16 one at the block tier's
shape, and its candidate recall (counterpart of
``scripts/probe_int8_scorer.py``).

    python -m vsearch_tpu_torch.scripts.probe_int8_scorer
        [--rows 262144] [--b 1024] [--device cpu]

One 262,144-row block of the JAX probe's ELL (128 strata, 48-96 ids a
row, V = 30,522) packed by kernel #1; B = 1,024 random queries of 768
ids. Times kernel #3 (bf16 queries) at buckets 16 and 32 and kernel #4
(``prepare_queries_int8``: each query scaled to 127 and rounded) at the
same buckets, with the JAX probe's "TF/s equivalent", and holds each
against its plain version (#4 bit for bit; #3 bit for bit on dyadic
weights, decoded within 2^-12 of the largest score on the queries). Then
the recall of the exact top 100 (kernel #2's scores, the TPU probe's
reference) within #4's top C at bucket 16, C in {100, 200, 400}: the
evidence for S7 (ROADMAP).
"""
from __future__ import annotations

import torch

from ..ops import bitpack
from ..ops.bitpack import ROW_BLOCK, _prepare_bf16, prepare_queries_int8
from . import common

BLOCK, B, K = 1 << 18, 1024, 100
V = common.V_BERT
BUCKETS = (16, 32)
CANDIDATES = (100, 200, 400)


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=BLOCK)
        ap.add_argument("--b", type=int, default=B)

    args, dev, out = common.start(__doc__, argv, add)
    n, b = args.rows, args.b
    cols, nnz = common.stratified_ell(n, V, args.seed, dev)
    words = bitpack.pack_bits(cols, nnz, V)
    n_bits = int(nnz.sum())
    del cols, nnz
    n_pad, nw = words.shape
    vp = nw * 32
    q = common.make_queries(b, V, args.seed + 1, dev)
    qT = _prepare_bf16(q, vp)
    q8T = prepare_queries_int8(q, vp)
    dyT = common.dyadic_operand(vp, V, b, args.seed + 2, dev)
    out.update({"block_rows": n, "b": b, "v": V, "mean_ids": n_bits / n})
    flops = 2.0 * b * n_pad * vp
    int8_keys = {}
    for bucket in BUCKETS:
        for tag, fn, plain, qq, peak in (
                ("bf16", bitpack.bucket_keys, bitpack.bucket_keys_plain, qT,
                 common.H100_F32_FLOPS),
                ("int8", bitpack.int8_bucket_keys,
                 bitpack.int8_bucket_keys_plain, q8T,
                 common.H100_INT8_OPS)):
            key = f"{tag}_b{bucket}"
            got = fn(words, qq, n, bucket)
            want = plain(words, qq, n, bucket)
            if tag == "int8":
                int8_keys[bucket] = got
                check = common.compare(got, want)
            else:
                dec = float((common.key_scores(got)
                             - common.key_scores(want)).abs().max())
                check = {"bit_identical_dyadic": bool(torch.equal(
                    fn(words, dyT, n, bucket), plain(words, dyT, n,
                                                     bucket))),
                         "max_abs_err": dec,
                         "decoded_within": dec <= 2.0 ** -12 * float(
                             common.key_scores(want).max())}
            ms = common.time_ms(lambda: fn(words, qq, n, bucket), dev,
                                 args.iters)
            out[f"{key}_ms"] = ms
            out[f"{key}_tfs"] = (None if ms is None
                                 else flops / (ms * 1e-3) / 1e12)
            out[f"{key}_plain_ms"] = common.time_ms(
                lambda: plain(words, qq, n, bucket), dev, 1, warm=False)
            out[f"{key}_check"] = check
            nbytes = words.numel() * 4 + qq.numel() * qq.element_size() \
                + got.numel() * 4
            out[f"{key}_bound"] = common.bound(nbytes, n_bits * b, peak)
    # candidate recall: the exact top K (kernel #2) within #4's top C
    exact = bitpack.score_bits(words, qT)[:n].T  # [B, n]
    true_ids = exact.topk(K, dim=1).indices
    del exact
    keys = int8_keys[16]
    kb = ROW_BLOCK // 16
    for c in CANDIDATES:
        kt, pos = torch.topk(keys.T, min(c, keys.shape[0]), dim=1)
        cand = (pos // kb) * ROW_BLOCK + (kt & (ROW_BLOCK - 1))
        hit = [len(set(cand[i].tolist()) & set(true_ids[i].tolist()))
               for i in range(0, b, 31)]
        out[f"cand_recall_c{c}"] = sum(hit) / len(hit) / K
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
