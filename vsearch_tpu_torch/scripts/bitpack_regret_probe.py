"""Exact against bucketed selection across index sizes: time and recall
(counterpart of ``scripts/bitpack_regret_probe.py``).

    python -m vsearch_tpu_torch.scripts.bitpack_regret_probe
        [--sizes 100000,1000000,2000000] [--device cpu]

For each size N, a bit matrix whose bits are set with probability 2^-8
each over V' = 29,523 (~115 ids a row), B = 128 random queries of 768
ids, k = 100: ``exact`` (``bitpack_topk_search``: kernel #2 and a stable
top-k) and ``bucketed`` (``bitpack_bucketed_topk``: kernel #3 at bucket
8, its keys decoded and top-k'd), each with its device ms, queries/s and
recall against exact scores (8 queries; rows scoring at least the exact
k-th within 1e-3 of it). This is the table behind the JAX package's
``BoTIndex.bucketed_threshold`` = 131,072, which the port keeps until the
card says otherwise (ROADMAP). The TPU's ``approx`` variants
(``lax.approx_max_k``) have no PyTorch counterpart: "n/a". Kernel #3 is
held against its plain version at each size on dyadic weights.
"""
from __future__ import annotations

import torch

from ..ops import bitpack
from ..ops.bitpack import (ROW_BLOCK, BitMatrix, _round_up,
                           bitpack_bucketed_topk, bitpack_scores,
                           bitpack_topk_search)
from . import common

B, K, V = 128, 100, common.V_PACK
SIZES = "100000,1000000,2000000"
APPROX = ("approx", "bucketed_approx", "bucketed_approx99")


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--sizes", default=SIZES)
        ap.add_argument("--b", type=int, default=B)

    args, dev, out = common.start(__doc__, argv, add)
    b = args.b
    q = common.make_queries(b, V, args.seed + 1, dev)
    rows = []
    for n in (int(s) for s in args.sizes.split(",") if s):
        words = common.random_words(_round_up(n, ROW_BLOCK), V,
                                     args.seed + n, dev)
        bm = BitMatrix(words=words, num_rows=n, num_cols=V)
        exact = bitpack_scores(q[:8], bm)  # [8, n]
        dyT = common.dyadic_operand(words.shape[1] * 32, V, b,
                                     args.seed + 2, dev)
        held = bool(torch.equal(bitpack.bucket_keys(words, dyT, n),
                                bitpack.bucket_keys_plain(words, dyT, n)))
        for name, fn in (
                ("exact", lambda: bitpack_topk_search(q, bm, k=K)),
                ("bucketed", lambda: bitpack_bucketed_topk(q, bm, k=K))):
            ids, _ = fn()
            ms = common.time_ms(fn, dev, args.iters // 2 or 1)
            rows.append({"n": n, "variant": name, "ms": ms,
                         "qps": None if ms is None else b / (ms * 1e-3),
                         "recall": common.recall_at(ids[:8], exact, K,
                                                     1e-3),
                         **({"keys_bit_identical_dyadic": held}
                            if name == "bucketed" else {})})
        rows += [{"n": n, "variant": name, "ms": "n/a"} for name in APPROX]
        del words, bm, exact, dyT
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out.update({"b": b, "k": K, "v": V,
                "expected_ids": 2.0 ** -8 * V, "rows": rows})
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
