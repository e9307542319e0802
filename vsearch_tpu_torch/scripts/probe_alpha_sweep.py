"""Alpha search through the binary-support proxy: the candidate budget C
against recall and time (counterpart of ``scripts/probe_alpha_sweep.py``).

    python -m vsearch_tpu_torch.scripts.probe_alpha_sweep [--nnz 768]
        [--c-list 1024,1536,2048] [--rows 2000000] [--device cpu]

``bench.py``'s alpha-at-scale index: 2,000,000 real-valued rows of 64
distinct uniform ids over V' = 29,523, weights 0.5 + U[0, 1) in bf16
(``--nnz 768``: the support of VDR's passage rows, ROADMAP S1's "sweep C
before the rule changes"). Its support is packed by kernel #1 into the
proxy (``ops.bitpack.pack_ell``, whose form follows the rows' width: the
plane form at 768 ids). For each C: ``bitpack_bucketed_topk(k=C)`` (kernel
#3, bucket 8) selects candidates and ``exact_rerank`` re-scores them from
the weighted ELL, k = 100, B = 128: queries/s of the whole search, the
stage split (``stage1_ms`` the proxy with its selection, ``rerank_ms`` the
rest), and recall against exact scores of 32 queries (rows scoring at
least the exact k-th within 1e-3 of it). The TPU's ``approx`` selection
(``approx_final``) merges exactly here, as the JAX package does off the
TPU, so only ``sel: "exact"`` is run.
"""
from __future__ import annotations

from ..ops.bitpack import bitpack_bucketed_topk, pack_ell
from ..ops.ell import ELLMatrix
from ..ops.two_stage import exact_rerank
from . import common

N, V, NNZ, K, B, NRQ = 2_000_000, common.V_PACK, 64, 100, 128, 32


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=N)
        ap.add_argument("--nnz", type=int, default=NNZ)
        ap.add_argument("--c-list", default="1024,1536,2048")
        ap.add_argument("--b", type=int, default=B)

    args, dev, out = common.start(__doc__, argv, add)
    n, b = args.rows, args.b
    cols, nnz, vals = common.alpha_rows(n, V, args.nnz, args.seed + 3, dev)
    ell = ELLMatrix(cols=cols, nnz=nnz, vals=vals, num_cols=V)
    proxy = pack_ell(ELLMatrix(cols=cols, nnz=nnz, vals=None, num_cols=V))
    q = common.make_queries(b, V, args.seed + 1, dev)
    exact = common.ell_scores(q[:NRQ], cols, nnz, V, vals)
    out.update({"n": n, "v": V, "nnz": args.nnz, "k": K, "b": b,
                "proxy_form": proxy.form})
    rows = []
    for c in (int(x) for x in args.c_list.split(",") if x):
        def stage1(c=c):
            return bitpack_bucketed_topk(q, proxy, k=c)

        def full(c=c):
            return exact_rerank(q, ell, stage1(c)[0], K)

        ids, _ = full()
        t_full = common.time_ms(full, dev, args.iters)
        t_1 = common.time_ms(stage1, dev, args.iters)
        rows.append({
            "path": "bitproxy", "c": c, "sel": "exact",
            "qps": None if t_full is None else b / (t_full * 1e-3),
            "recall": common.recall_at(ids[:NRQ], exact, K, 1e-3),
            "stage1_ms": t_1,
            "rerank_ms": None if t_full is None else t_full - t_1})
    out["rows"] = rows
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
