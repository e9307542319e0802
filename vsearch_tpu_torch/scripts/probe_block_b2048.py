"""The block tier's batch and bucket at wiki21m's size, on the int8 path
(counterpart of ``scripts/probe_block_b2048.py``).

    python -m vsearch_tpu_torch.scripts.probe_block_b2048 [--rows N]
        [--device cpu]

``--rows`` (default wiki21m's 21,015,324) rows of the JAX probes' ELL
(128 strata, 48-96 ids, V = 30,522) are made on the device in
chunks as the compact ELL the block tier keeps there (uint16 ids as int16
bit patterns). ``bitpack_blockwise_topk(selection="bucketed_int8")``
sweeps them in blocks of ``BoTIndex.stream_block_rows`` for k = 100 at
B in {1,024, 2,048} and bucket in {16, 32}: queries/s and the sweep's
seconds of each (one untimed sweep first). The TPU probe asked whether
B = 2,048 amortises the per-block pack and bucket 32 halves the merge;
the bucket-32 run's recall is checked on 4 queries against exact scores
(tolerance 1e-2 of the k-th), as there.
"""
from __future__ import annotations

from ..index.sparse import BoTIndex
from ..ops.bitpack import bitpack_blockwise_topk
from . import common

WIKI21M, K = 21_015_324, 100
V = common.V_BERT
RUNS = (("b1024_bkt16", 1024, 16), ("b2048_bkt16", 2048, 16),
        ("b1024_bkt32", 1024, 32), ("b2048_bkt32", 2048, 32))


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=WIKI21M)
        ap.add_argument("--block-rows", type=int,
                        default=BoTIndex.stream_block_rows)
        ap.add_argument("--b-scale", type=int, default=1,
                        help="divide the batches by this (a CPU rehearsal)")

    args, dev, out = common.start(__doc__, argv, add)
    import torch

    cols, nnz = common.stratified_ell(args.rows, V, args.seed + 2, dev,
                                       dtype=torch.int16)
    out.update({"rows": args.rows, "block_rows": args.block_rows, "k": K,
                "ell_device_gb": (cols.numel() * 2 + nnz.numel() * 4)
                / 1e9})
    ids32 = None
    for tag, b, bucket in RUNS:
        b //= args.b_scale
        q = common.make_queries(b, V, args.seed + 3, dev)

        def sweep():
            return bitpack_blockwise_topk(q, cols, nnz, V, K,
                                          block_rows=args.block_rows,
                                          selection="bucketed_int8",
                                          bucket=bucket)

        sweep()
        secs, (ids, _) = common.wall_s(sweep, dev)
        out[f"{tag}_qps"] = common.per_s(b, secs)
        out[f"{tag}_sweep_s"] = secs
        if tag == "b1024_bkt32":
            ids32 = ids[:4]
    # the recall of bucket 32 on 4 queries (the prefix of the same seed's)
    exact = common.ell_scores(
        common.make_queries(len(ids32), V, args.seed + 3, dev), cols, nnz,
        V)
    out["b1024_bkt32_recall"] = common.recall_at(ids32, exact, K, 1e-2)
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
