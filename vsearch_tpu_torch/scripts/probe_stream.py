"""The stream tier: streamed against resident search, and a sweep at
wiki21m's size split into its parts (counterpart of
``scripts/probe_stream.py``).

    python -m vsearch_tpu_torch.scripts.probe_stream [--rows N]
        [--b-list 128,1024] [--device cpu]

Stage A: 2,000,000 rows of the JAX probes' ELL (128 strata, 48-96 ids,
V = 30,522) searched exactly (k = 100, B = 128) by the resident path
(kernel #1 once, then ``bitpack_topk_search``) and by
``StreamedBitpackSearcher`` (exact selection) over the same rows on the
host: the sorted scores must agree (rtol 1e-5), and both queries/s.

Stage B: ``--rows`` (default wiki21m's 21,015,324) rows made on the device
in chunks and kept on the host as uint16 ids; a sweep's seconds, queries/s
and host -> device GB/s for each batch of ``--b-list``, recall of 4
queries against exact scores (tolerance 1e-2 of the k-th), and the sweep
split into its parts, each timed alone (ROADMAP S6): ``staging_s``, the
host copies into the pinned staging buffer (host clock); ``transfer_s``,
the pinned -> device copies (CUDA events); ``card_s``, one block's pack,
selection and merge on the card times the blocks (CUDA events). The
sweep overlaps them; ``overlap`` is their sum over the sweep's seconds.
The TPU probe's stage C (the block tier) is ``probe_block_b2048``'s.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..index.streamed import StreamedBitpackSearcher
from ..ops.bitpack import TILE_BITS, _prepare_bf16, _round_up, pack_ell
from ..ops.bitpack import bitpack_topk_search
from ..ops.ell import ELLMatrix
from . import common

V, K, WIKI21M, ROWS_A = common.V_BERT, 100, 21_015_324, 2_000_000
BLOCK = 1 << 18


def stage_a(dev, rows: int, iters: int, seed: int) -> dict:
    cols, nnz = common.stratified_ell(rows, V, seed, dev)
    q = common.make_queries(128, V, seed + 1, dev)
    bm = pack_ell(ELLMatrix(cols=cols, nnz=nnz, vals=None, num_cols=V))
    _, s_res = bitpack_topk_search(q, bm, k=K)
    ms = common.time_ms(lambda: bitpack_topk_search(q, bm, k=K), dev,
                         iters)
    del bm
    streamer = StreamedBitpackSearcher(cols.cpu().numpy(), nnz.cpu().numpy(),
                                       V, block_rows=BLOCK, device=dev)
    del cols, nnz
    streamer.search(q, K)
    secs, (_, s_str) = common.wall_s(lambda: streamer.search(q, K), dev)
    return {"rows": rows,
            "resident_qps": None if ms is None else 128 / (ms * 1e-3),
            "stream_qps": common.per_s(128, secs),
            "stream_sweep_s": secs,
            "scores_match_resident": bool(np.allclose(
                np.sort(s_str, axis=1), np.sort(s_res.cpu().numpy(), axis=1),
                rtol=1e-5, atol=1e-4))}


def sweep_parts(s: StreamedBitpackSearcher, q: torch.Tensor, dev) -> dict:
    """The parts of one sweep of ``s`` for queries ``q``, each alone."""
    slot = s._cuda_slots()[0]
    t0 = time.perf_counter()
    for blk in range(s.n_blocks):
        a, e = s._host_block(blk)
        slot["h_cols"][: e - a].copy_(s._torch_cols[a:e])
        slot["h_nnz"][: e - a].copy_(s._torch_nnz[a:e])
    staging = time.perf_counter() - t0

    def transfer():
        for _ in range(s.n_blocks):
            slot["d_cols"].copy_(slot["h_cols"], non_blocking=True)
            slot["d_nnz"].copy_(slot["h_nnz"], non_blocking=True)

    qT = _prepare_bf16(q.to(dev), _round_up(s.num_cols, TILE_BITS))
    b, k = q.shape[0], min(K, s.num_rows)
    best = (torch.full((b, k), -1.0, device=dev),
            torch.zeros((b, k), dtype=torch.int64, device=dev))

    def card():
        for blk in range(s.n_blocks):
            s._step(*best, qT, slot["d_cols"], slot["d_nnz"],
                    blk * s.block_rows, k)

    t_transfer = common.time_ms(transfer, dev, 1) / 1e3
    t_card = common.time_ms(card, dev, 1) / 1e3
    return {"staging_s": staging, "transfer_s": t_transfer,
            "transfer_gbps": s.bytes_per_sweep / t_transfer / 1e9,
            "card_s": t_card}


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=WIKI21M)
        ap.add_argument("--rows-a", type=int, default=ROWS_A)
        ap.add_argument("--b-list", default="128,1024")

    args, dev, out = common.start(__doc__, argv, add)
    out["stage_a"] = stage_a(dev, args.rows_a, max(1, args.iters // 2),
                             args.seed)

    n = args.rows
    t0 = time.perf_counter()
    cols_d, nnz_d = common.stratified_ell(n, V, args.seed + 2, dev,
                                           dtype=torch.int16)
    q4 = common.make_queries(4, V, args.seed + 3, dev)
    exact = common.ell_scores(q4, cols_d, nnz_d, V)
    cols = cols_d.cpu().numpy().view(np.uint16)
    nnz = nnz_d.cpu().numpy()
    del cols_d, nnz_d
    gen_s = time.perf_counter() - t0
    s = StreamedBitpackSearcher(cols, nnz, V, block_rows=BLOCK, device=dev)
    stage_b = {"rows": n, "gen_s": gen_s if dev.type == "cuda" else None,
               "sweep_gb": s.bytes_per_sweep / 1e9, "blocks": s.n_blocks}
    for b in (int(x) for x in args.b_list.split(",") if x):
        qb = common.make_queries(b, V, args.seed + 3, dev)
        s.search(qb, K)
        secs, _ = common.wall_s(lambda: s.search(qb, K), dev)
        stage_b[f"qps_b{b}"] = common.per_s(b, secs)
        stage_b[f"sweep_s_b{b}"] = secs
        stage_b[f"transfer_gbps_b{b}"] = (
            None if secs is None else s.bytes_per_sweep / secs / 1e9)
        if dev.type == "cuda":
            parts = sweep_parts(s, qb, dev)
            parts["overlap"] = (parts["staging_s"] + parts["transfer_s"]
                                + parts["card_s"]) / secs
            stage_b[f"parts_b{b}"] = parts
    ids, _ = s.search(q4, K)
    stage_b["recall_vs_exact"] = common.recall_at(torch.from_numpy(ids),
                                                   exact, K, 1e-2)
    out["stage_b"] = stage_b
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
