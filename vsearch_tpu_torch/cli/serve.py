"""Serving CLI: load a checkpoint + index, expose HTTP search/embed
(counterpart of ``vsearch_tpu/cli/serve.py``).

Usage:
  python -m vsearch_tpu_torch.cli.serve --checkpoint ckpt \
      --index_file index.npz --data_file corpus.jsonl --port 8080

``--mesh_dp N`` shards the index (and the beta rerank's embeds) over
the first N cards of this machine (``Retriever.to_mesh``).

The JAX package's ``--compile_cache`` (XLA's persistent cache) and its
TPU-claim registry have no counterpart here: PyTorch compiles nothing at
serve time, the CUDA kernels are built once into the package's build
directory, and a CUDA context claims nothing that outlives its process.
One idea of the claim registry stays: SIGTERM (a process manager's stop)
is a clean exit, so ``server_close()`` ends the dispatcher thread.
"""
from __future__ import annotations

import argparse
import logging
import signal

from .common import add_device_arg, load_retriever, setup_logging

logger = logging.getLogger("vsearch_tpu_torch.cli.serve")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--index_file", default=None)
    ap.add_argument("--data_file", default=None)
    ap.add_argument("--index_type", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--default_k", type=int, default=10)
    ap.add_argument("--mesh_dp", type=int, default=0,
                    help="shard the index (and beta rerank) over this "
                         "many cards of this machine; 0 = one device")
    add_device_arg(ap)
    ap.add_argument("--search_mode", default=None,
                    choices=["auto", "exact", "bitpack", "bitproxy",
                             "block", "stream"],
                    help="sparse/BoT scoring path (index.SparseIndex, "
                         "index.BoTIndex). Default 'auto' picks by size "
                         "and device budget: the binary-support proxy "
                         "('bitproxy') for large real-valued indexes, and "
                         "for bag-of-token indexes larger than the card "
                         "the tiers: 'block' keeps the compact ELL on the "
                         "card and repacks row blocks there; 'stream' "
                         "streams host-resident blocks through the card")
    ap.add_argument("--selection", default=None,
                    choices=["auto", "exact", "approx", "bucketed",
                             "bucketed_approx"],
                    help="top-k selection policy of a bag-of-token "
                         "index (see index.BoTIndex.selection; default "
                         "'auto' = fused bucketed kernel)")
    ap.add_argument("--warmup", action="store_true",
                    help="run one search (+rerank on BoT indexes) "
                         "before accepting traffic, so the first "
                         "request doesn't pay the kernel build and the "
                         "packing of the index")
    ap.add_argument("--rerank_budget", type=int, default=None,
                    help="per-QUERY scalar-gather budget for the "
                         "sparse exact-rerank stage (candidates = "
                         "budget // nnz_pad); default 196608 = C=1536 "
                         "at nnz 128")
    ap.add_argument("--no_coalesce", action="store_true",
                    help="serialize requests with a lock instead of "
                         "merging concurrent /search calls into one "
                         "device batch")
    return ap


def prepare_retriever(args, ap):
    """Load checkpoint + index, apply the selection policy and warm up:
    everything main() does before binding the socket (split out so it is
    testable without a server loop)."""
    retriever = load_retriever(args.checkpoint, args.device)
    if args.index_file:
        retriever.load_index(index_file=args.index_file,
                             data_file=args.data_file,
                             index_type=args.index_type,
                             search_mode=args.search_mode)
        if args.selection:
            from ..index import BoTIndex, SparseIndex

            # NB: BoTIndex < SparseIndex < DenseIndex, so dispatch on
            # the most-derived type first — a bare isinstance check
            # against a base class would hijack every index type
            if not isinstance(retriever.index, BoTIndex):
                # real-valued sparse search is driven by
                # search_mode/rerank_budget, and dense search is exact
                # top-k (the JAX package's dense 'approx' is the TPU's
                # approx_max_k): neither reads a selection policy, so
                # accepting the flag would be a silent no-op
                kind = ("real-valued sparse"
                        if isinstance(retriever.index, SparseIndex)
                        else "dense")
                ap.error(f"--selection has no effect on {kind} indexes; "
                         "it applies to bag-of-token indexes only")
            retriever.index.selection = args.selection
            logger.info("top-k selection policy: %s", args.selection)
    elif args.selection:
        ap.error("--selection requires --index_file (no index loaded)")
    elif args.search_mode:
        ap.error("--search_mode requires --index_file (no index "
                 "loaded)")
    if args.rerank_budget is not None:
        from ..index import BoTIndex, SparseIndex

        if retriever.index is None:
            ap.error("--rerank_budget requires --index_file")
        if not isinstance(retriever.index, SparseIndex):
            # DenseIndex has no rerank stage: the attribute would be
            # set but never read — reject instead of silently ignoring
            ap.error("--rerank_budget applies to real-valued sparse "
                     "indexes only (dense search has no rerank stage)")
        # the budget is only read by candidate-based search paths
        # (bit-proxy). Resolve which path this index will
        # actually take and reject the flag when that path is exact
        # scoring with no candidate/rerank stage — a bit-packed BoT
        # scorer, an explicit search_mode='exact', or a small index in
        # 'auto' mode would all set the attribute and never read it
        # (the silent-no-op knob class this validation exists to stop)
        idx = retriever.index
        bitpacked = (isinstance(idx, BoTIndex) and idx._use_bitpack())
        uses_budget = not bitpacked and idx._use_bitproxy()
        if uses_budget and args.mesh_dp:
            # mesh-sharded sparse search scores each shard exactly and
            # merges the shards' top-k: no candidate stage reads it
            ap.error("--rerank_budget has no effect with --mesh_dp: "
                     "sharded sparse search scores each shard exactly "
                     "(per-shard scorer + top-k merge) with no "
                     "candidate/rerank stage")
        if not uses_budget:
            # an oversize BoT in 'auto' mode still answers True from
            # _use_bitpack() but actually searches through the
            # block/stream tier — name the tier search will take, not
            # the resident scorer it bypasses
            tier = (idx._oversize_tier()
                    if isinstance(idx, BoTIndex) else None)
            path = (f"the exact on-device '{tier}' tier (blockwise "
                    "bit-packed scoring)" if bitpacked and tier else
                    "the exact bit-packed scorer" if bitpacked else
                    f"exact scoring (search_mode={idx.search_mode!r}, "
                    f"{idx.ell.shape[0]} rows <= exact_threshold "
                    f"{idx.exact_threshold})"
                    if idx.search_mode in ("auto", "exact")
                    else f"search_mode={idx.search_mode!r}")
            ap.error("--rerank_budget has no effect here: this index "
                     f"resolves to {path}, which has no "
                     "candidate/rerank stage; the budget applies to "
                     "real-valued sparse indexes searched via "
                     "bit-proxy candidates")
        retriever.index.rerank_budget = args.rerank_budget
    if args.mesh_dp:
        from ..parallel.mesh import make_mesh

        try:  # the first N cards of this machine
            mesh = make_mesh(dp=args.mesh_dp, tp=1)
        except ValueError as exc:  # fewer than N: the mesh arithmetic
            ap.error(f"--mesh_dp {args.mesh_dp}: {exc}")
        retriever.to_mesh(mesh)
        logger.info("serving sharded over %d devices", args.mesh_dp)
    if args.warmup and retriever.index is not None:
        import time

        from ..index import IndexType

        t0 = time.time()
        # rerank needs passage texts; with --index_file but no
        # --data_file the index has vectors only, and warming the
        # rerank path would fail in index.get_sample()
        has_data = (getattr(retriever.index, "data", None) is not None
                    or getattr(retriever.index, "_lazy", None)
                    is not None)
        rerank = (retriever.index.index_type == IndexType.BAG_OF_TOKEN
                  and has_data)
        retriever.retrieve(["warmup"], k=min(args.default_k,
                                             len(retriever.index)),
                           rerank=rerank)
        logger.info("warmup done in %.1f s (search%s)",
                    time.time() - t0, "+rerank" if rerank else "")
    return retriever


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None):
    setup_logging()
    ap = make_parser()
    args = ap.parse_args(argv)

    from ..serve import serve

    retriever = prepare_retriever(args, ap)
    server = serve(retriever, host=args.host, port=args.port,
                   default_k=args.default_k,
                   coalesce=not args.no_coalesce)
    # SIGTERM leaves serve_forever as Ctrl-C does, through the finally
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
