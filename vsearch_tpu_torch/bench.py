"""The port's benchmark (counterpart of ``bench.py``): the JAX repo's
benchmark script, section by section, through the port's entry points.

    python -m vsearch_tpu_torch.bench [--device cpu] [--num-passages N]
        [--num-queries N] [--query-batch B] [--topk K] [--skip-embed-bench]
        [--scale-rows N] [--stream-rows N] [--train-steps N] [--seed S]

Prints ONE JSON line to stdout with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline`` first: the bag-of-token build rate
against the reference's 11,968 passages/s, a host figure of the reference);
progress goes to stderr. ``main(argv)`` also returns the dict.

Sections, in the order they run (each a function below, with explicit
sizes, a device and a seed):

- ``train_section``: BERT-base VDR train steps (Lq 32 / Lp 256, one hard
  negative, semi + symmetric loss) at B=32 and at B=64 with remat, first,
  so that the card's peak is the step's own;
- ``encode_rate``, ``build_section``: the tokenizer's padded encode rate
  and the bag-of-token build (16 chunks over 3 passes, the chunk minima
  summed), both on the host;
- ``resident_section``: kernel #1 packs the index on the device (cold, then
  steady), then ``--query-batch`` chunks of device queries go straight to
  the index's kernel (#3 above 131,072 rows, else #2), one synchronise at
  the end; recall of 8 queries against host-exact scores;
- ``beta_section``: beta search with rerank through ``Retriever`` (BERT-base
  VDR, bf16) over that index;
- ``scale_section``: ``--scale-rows`` rows of random bits (density 2^-8)
  made on the card, searched by #3, recall against #2's exact scores;
- ``alpha_section``: ``--scale-rows`` real-valued rows of 64 ids through the
  binary-support proxy (#1, then #3 for C = 1,536, then the exact rerank),
  recall against the exact chunked gather;
- ``oversize_section``: ``--stream-rows`` stratified rows of 48-96 ids in a
  compact ELL on the card, searched through ``BoTIndex.search`` at B=1,024
  (the block tier: #1 and #4 a block), recall of 2 queries against the
  plain gather's exact scores on the card;
- ``embed_section``: the VDR forward at 256 x 128 in bf16.

Off the card (``--device cpu``) the beta, scale, alpha, over-card and train
sections are skipped, as ``bench.py`` skips them off the TPU; their keys
read 0 or null. With ``--device cuda`` and no CUDA the line is
``bench.py``'s ``bench_error`` and the exit code 2. Where ``bench.py``'s
keys differ: ``compile_cache`` is gone (the port builds its kernels once
into ``vsearch_tpu_torch/_build``: ``kernel_build_s``, 0.0 when they were
built already), ``train_hbm_gb_b*`` is the runtime peak
(``torch.cuda.max_memory_allocated``), not a compiler's reservation, and
``--stream-rows`` defaults to wiki21m's 21,015,324 rows (86 GB packed),
since 4,000,000 rows pack to 16.4 GB, under an H100's budget.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .device import resolve_device
from .examples.synthetic_vocab import build_wordpiece_vocab, make_corpus
from .scripts import common

SHIFT = 999  # BERT's [unused] ids and specials: V' = 30,522 - 999
# the reference's wiki21m build, excluding I/O (bench.py:701)
BASELINE_RATE = 21_015_324 / 1_756.0
WIKI21M_ROWS = 21_015_324
ALPHA_C = 1536  # bench.py:564: the proxy's candidates a query
ALPHA_NNZ = 64  # ~wiki21m's ids a passage
RECALL_QUERIES = 8
OVERSIZE_B = 1024
OVERSIZE_RECALL_QUERIES = 2
ENCODE_PASSAGES = 50_000
BUILD_CHUNKS, BUILD_PASSES = 16, 3
TRAIN_LQ, TRAIN_LP = 32, 256
TRAIN_SHAPES = ((32, False), (64, True))  # (B, remat)
BETA_QUERIES, BETA_REPS = 32, 2
EMBED_B, EMBED_L, EMBED_ITERS = 256, 128, 12


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def get_bench_tokenizer():
    """The C++ tokenizer over the synthetic vocabulary, else the Python
    one: (tokenizer, which)."""
    vocab = build_wordpiece_vocab()
    try:
        from .tokenization.native import NativeWordPieceTokenizer
        return NativeWordPieceTokenizer(vocab), "native-c++"
    except (OSError, subprocess.CalledProcessError):
        from .tokenization.wordpiece import WordPieceTokenizer
        return WordPieceTokenizer(vocab), "python"


def _analytic_train_flops(n_q: int, l_q: int, n_p: int, l_p: int,
                          h: int, layers: int, inter: int, v_out: int,
                          remat: bool) -> float:
    """Matmul FLOPs of one VDR train step (fwd+bwd, both towers), as
    ``bench.py`` counts them: QKVO projections (8h^2/token), FFN
    (4*h*inter/token), attention score+context matmuls (4*L*h/token) and
    the vocab head (2*h*V'/token, V' padded to 128). Backward doubles the
    forward; ``remat`` recomputes the encoder forward once more. The loss,
    embeddings, layernorms and softmax are left out."""
    v_pad = -(-v_out // 128) * 128

    def fwd(n, l):
        per_tok = layers * (8 * h * h + 4 * h * inter + 4 * l * h) \
            + 2 * h * v_pad
        return n * l * per_tok

    mult = 4.0 if remat else 3.0
    return mult * (fwd(n_q, l_q) + fwd(n_p, l_p))


def _require_on(dev: torch.device, *tensors: torch.Tensor) -> None:
    """A timed section on the card must not run the plain versions on the
    host: every index tensor lies on ``dev``'s kind of device."""
    for t in tensors:
        if t.device.type != dev.type:
            raise RuntimeError(f"an index tensor lies on {t.device}, not "
                               f"on {dev}: the section would time the "
                               "host")


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def timed(fn: Callable, dev: torch.device) -> Tuple[float, object]:
    """(host seconds, result) of ``fn``, synchronised before and after."""
    common.sync(dev)
    t0 = time.perf_counter()
    r = fn()
    common.sync(dev)
    return time.perf_counter() - t0, r


def query_chunks(q: torch.Tensor, b: int) -> List[torch.Tensor]:
    """The whole chunks of ``b`` queries of ``q``, as ``bench.py`` sends
    them (a ragged tail is dropped)."""
    return [q[s:s + b] for s in range(0, q.shape[0] - b + 1, b)]


# -- train --------------------------------------------------------------------
def train_section(dev: torch.device, steps: int, seed: int, bert=None,
                  shapes: Sequence[Tuple[int, bool]] = TRAIN_SHAPES,
                  l_q: int = TRAIN_LQ, l_p: int = TRAIN_LP) -> Dict:
    """``steps`` timed train steps of a VDR bi-encoder (one shared module,
    f32 weights computing in ``bert.dtype``, BERT-base in bf16 by default)
    for each (B, remat) of ``shapes``: B queries of ``l_q`` tokens, 2B
    passages of ``l_p`` (one hard negative each), AdamW (lr 2e-5, weight
    decay 0.01), after one warm-up step. Each shape starts from the same
    weights. Returns ``train_steps_per_s_b{B}``, ``train_tflops_b{B}``
    (``_analytic_train_flops``), ``train_hbm_gb_b{B}`` (the card's peak
    GiB over the warm-up step, None off the card) and
    ``train_last_loss_b{B}``."""
    from .models.bert import BertConfig, init_bert_weights
    from .models.encoder_base import build_module
    from .models.vdr import VDREncoderConfig, VDRModule
    from .train.loss import VDRLossConfig
    from .train.optim import get_optimizer
    from .train.step import (TrainBatch, TrainState, TrainStepConfig,
                             make_encoder_apply, make_train_step)

    bert = bert or BertConfig(dtype=torch.bfloat16)
    vcfg = VDREncoderConfig(bert=bert, max_len=l_p, shift_vocab_num=SHIFT,
                            topk=768)
    scfg = TrainStepConfig(
        encoder_type="vdr", vocab_size=bert.vocab_size,
        shift_vocab_num=SHIFT,
        loss=VDRLossConfig(semi=True, sym_loss=True, topk=768))
    gen = common.generator(dev, seed + 11)
    card = dev.type == "cuda"
    out: Dict = {}
    for b, remat in shapes:
        module = build_module(VDRModule, vcfg, init_bert_weights, seed, dev,
                              torch.float32)
        tx = get_optimizer([module], learning_rate=2e-5, weight_decay=0.01)
        apply = make_encoder_apply(module, deterministic=False, remat=remat)
        step = make_train_step(apply, apply, scfg, shared_params=True)
        state = TrainState.create(module, tx)
        batch = TrainBatch(
            q_ids=torch.randint(SHIFT, bert.vocab_size, (b, l_q),
                                generator=gen, device=dev),
            p_ids=torch.randint(SHIFT, bert.vocab_size, (2 * b, l_p),
                                generator=gen, device=dev))
        common.sync(dev)
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        state, m = step(state, batch, 0)  # warm-up
        float(m["loss"])
        peak = torch.cuda.max_memory_allocated(dev) if card else None
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = step(state, batch, i + 1)
        loss = float(m["loss"])  # one synchronise at the end
        sps = steps / (time.perf_counter() - t0)
        flops = _analytic_train_flops(
            b, l_q, 2 * b, l_p, bert.hidden_size, bert.num_hidden_layers,
            bert.intermediate_size, bert.vocab_size - SHIFT, remat)
        out[f"train_hbm_gb_b{b}"] = None if peak is None else peak / 2 ** 30
        out[f"train_steps_per_s_b{b}"] = sps
        out[f"train_tflops_b{b}"] = flops * sps / 1e12
        out[f"train_last_loss_b{b}"] = loss
        log(f"train B={b} remat={remat}: {sps} steps/s, loss {loss}, peak "
            f"{out[f'train_hbm_gb_b{b}']} GiB")
        del module, tx, apply, step, state, batch, m
        _free(dev)
    return out


# -- host: tokenizer and build ------------------------------------------------
def encode_rate(tokenizer, texts: Sequence[str]) -> float:
    """Passages a second of the padded encode (128 tokens), best of two;
    0.0 for a tokenizer without it."""
    rate = 0.0
    if hasattr(tokenizer, "encode_batch_padded"):
        for _ in range(2):  # best of two: the host's cores are shared
            t0 = time.perf_counter()
            tokenizer.encode_batch_padded(texts, max_length=128)
            rate = max(rate, len(texts) / (time.perf_counter() - t0))
    return rate


def build_section(tokenizer, corpus: Sequence[str], batch_size: int,
                  chunks: int = BUILD_CHUNKS, passes: int = BUILD_PASSES
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """The bag-of-token build on the host (``build_bot_ell(...,
    return_host=True, device=False)``) in ``chunks`` chunks over
    ``passes`` passes: (the sum of each chunk's least seconds, cols, nnz).
    A spike on the shared host then costs only the chunks it overlaps."""
    from .index.bot_build import build_bot_ell

    bounds = np.linspace(0, len(corpus), chunks + 1, dtype=int)
    best = np.full(chunks, np.inf)
    parts = []
    for _ in range(passes):
        parts = []
        for ci in range(chunks):
            t0 = time.perf_counter()
            _, cols, nnz = build_bot_ell(
                tokenizer, corpus[bounds[ci]:bounds[ci + 1]], max_len=128,
                shift=SHIFT, batch_size=batch_size, return_host=True,
                device=False)
            best[ci] = min(best[ci], time.perf_counter() - t0)
            parts.append((cols, nnz))
    return (float(best.sum()), np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


# -- the resident index -------------------------------------------------------
def host_recall(q: np.ndarray, ids: np.ndarray, cols: np.ndarray,
                k: int) -> float:
    """``bench.py``'s recall (:423-435): the share of returned rows whose
    host-exact score reaches the exact k-th within 1e-2 of it (relative,
    at least 1). ``cols`` is sentinel-padded (V), ``q`` [B, V]."""
    qpad = np.concatenate([q, np.zeros((len(q), 1), np.float32)], axis=1)
    recalls = []
    for i in range(len(q)):
        exact = qpad[i][cols].sum(axis=1)
        kth = -np.partition(-exact, k - 1)[k - 1]
        tol = 1e-2 * max(abs(kth), 1.0)
        recalls.append(float(np.mean(exact[ids[i]] >= kth - tol)))
    return float(np.mean(recalls))


def _resident_search(index, q: torch.Tensor, k: int):
    """The device (ids, scores) of ``index.search`` without the host copy:
    the kernel the index would run, on the queries as they lie."""
    from .ops.bitpack import bitpack_bucketed_topk, bitpack_topk_search
    from .ops.two_stage import exact_search

    if not index._use_bitpack():
        return exact_search(q, index.ell, k=k)
    if index._resolved_selection().startswith("bucketed"):
        return bitpack_bucketed_topk(q, index.bitmat, k=k)
    return bitpack_topk_search(q, index.bitmat, k=k)


def resident_section(index, q: torch.Tensor, query_batch: int, k: int,
                     cols: np.ndarray) -> Dict:
    """Pack (kernel #1, cold then steady) and search ``index`` (a
    ``BoTIndex`` whose ELL lies on its device): the queries ``q`` in whole
    chunks of ``query_batch`` straight to the index's kernel, one
    synchronise at the end; then ``index.search`` of the first 8 against
    host-exact scores over ``cols`` (``host_recall``). Returns the
    section's keys, and ``ids``/``scores`` of those 8."""
    dev = index.ell.cols.device
    bitpack = index._use_bitpack()
    pack_s = pack_steady_s = 0.0
    if bitpack:
        pack_s, _ = timed(index.build_bitpack, dev)
        # the first call at a shape may load the kernel's library
        pack_steady_s, _ = timed(index.build_bitpack, dev)
        _require_on(dev, index.bitmat.words)
    index.search(q[:query_batch], k=k)  # warm-up
    chunks = query_chunks(q, query_batch)
    secs, _ = timed(lambda: [_resident_search(index, qd, k)
                             for qd in chunks], dev)
    nr = min(RECALL_QUERIES, query_batch)
    got = index.search(q[:nr], k=k)
    return {"search_qps": len(chunks) * query_batch / secs,
            "search_recall_vs_exact": host_recall(
                q[:nr].cpu().numpy(), got.ids, cols, k),
            "search_mode": "bitpack" if bitpack else "exact",
            "selection": index._resolved_selection() if bitpack
            else "exact",
            "pack_build_s": pack_s, "pack_steady_s": pack_steady_s,
            "ids": got.ids, "scores": got.scores}


def beta_section(tokenizer, index, corpus: Sequence[str], k: int,
                 dev: torch.device, seed: int) -> float:
    """Queries a second of beta search (``Retriever.retrieve(rerank=True,
    batch_size=256)``, BERT-base VDR, bf16, random weights from ``seed``)
    over ``index``, whose rows are ``corpus``: 32 queries of the first 12
    words of the first 32 passages, one warm-up call, 2 timed."""
    from .retriever import Retriever, RetrieverConfig

    enc = {"type": "vdr", "max_len": 128, "topk": 768,
           "shift_vocab_num": SHIFT, "vocab_size": tokenizer.vocab_size,
           "hidden_size": 768, "num_hidden_layers": 12,
           "num_attention_heads": 12, "intermediate_size": 3072,
           "max_position_embeddings": 512, "dtype": "bfloat16"}
    retriever = Retriever(RetrieverConfig(encoder_q=dict(enc),
                                          encoder_p=dict(enc),
                                          shared_encoder=True),
                          tokenizer=tokenizer, seed=seed, device=dev)
    index.data = corpus
    retriever.index = index
    queries = [" ".join(c.split()[:12]) for c in corpus[:BETA_QUERIES]]
    try:
        retriever.retrieve(queries, k=k, rerank=True, batch_size=256)
        t0 = time.perf_counter()
        for _ in range(BETA_REPS):
            retriever.retrieve(queries, k=k, rerank=True, batch_size=256)
        return BETA_QUERIES * BETA_REPS / (time.perf_counter() - t0)
    finally:
        index.data = None


# -- at scale, on the card ----------------------------------------------------
def scale_section(chunks: List[torch.Tensor], v: int, rows: int, k: int,
                  dev: torch.device, seed: int) -> Dict:
    """``rows`` rows of random bits (each set with probability 2^-8, the
    columns >= ``v`` clear) made on ``dev``, searched by kernel #3 for
    each query chunk (one synchronise at the end); recall of 8 queries
    against the top-k of kernel #2's exact scores, within 1e-3 of the
    k-th (``common.recall_at``, ``bench.py``:541-548)."""
    from .ops.bitpack import (ROW_BLOCK, BitMatrix, _round_up,
                              bitpack_bucketed_topk, bitpack_scores)

    words = common.random_words(_round_up(rows, ROW_BLOCK), v, seed, dev)
    _require_on(dev, words)
    bm = BitMatrix(words=words, num_rows=rows, num_cols=v,
                   mean_bits=v * 2.0 ** -8)
    timed(lambda: bitpack_bucketed_topk(chunks[0], bm, k=k), dev)
    secs, _ = timed(lambda: [bitpack_bucketed_topk(qd, bm, k=k)
                             for qd in chunks], dev)
    ids = bitpack_bucketed_topk(chunks[0], bm, k=k)[0][:RECALL_QUERIES]
    exact = bitpack_scores(chunks[0][:RECALL_QUERIES], bm)
    return {"scale_search_qps": len(chunks) * chunks[0].shape[0] / secs,
            "scale_search_recall": common.recall_at(ids, exact, k, 1e-3)}


def alpha_section(chunks: List[torch.Tensor], v: int, rows: int, k: int,
                  dev: torch.device, seed: int, c: int = ALPHA_C,
                  nnz: int = ALPHA_NNZ) -> Dict:
    """``rows`` real-valued rows of ``nnz`` distinct ids (weights 0.5 +
    U[0, 1) in bf16, ``common.alpha_rows``) made on ``dev``; their support
    packed by kernel #1 and searched through ``binary_proxy_search`` (#3
    for ``c`` candidates, then the exact rerank) for each query chunk;
    recall of 8 queries against the exact chunked gather
    (``ell_matvec_chunked``, 65,536 rows a chunk) within 1e-3 of the k-th.
    Distinct ids a row: ``bench.py``'s ``randint`` may repeat one, which
    doubles a weight in the exact scores but sets one bit in the proxy."""
    from .ops.bitpack import pack_ell_device
    from .ops.ell import ELLMatrix, ell_matvec_chunked
    from .ops.two_stage import binary_proxy_search

    cols, nnz_t, vals = common.alpha_rows(rows, v, nnz, seed, dev)
    ell = ELLMatrix(cols=cols, nnz=nnz_t, vals=vals, num_cols=v)
    proxy = pack_ell_device(ell)
    _require_on(dev, cols, vals, proxy.words)

    def search(qd):
        return binary_proxy_search(qd, ell, proxy, k=k, num_candidates=c)

    timed(lambda: search(chunks[0]), dev)
    secs, _ = timed(lambda: [search(qd) for qd in chunks], dev)
    ids = search(chunks[0])[0][:RECALL_QUERIES]
    exact = ell_matvec_chunked(chunks[0][:RECALL_QUERIES], ell,
                               chunk_rows=65536)
    return {"alpha_scale_qps": len(chunks) * chunks[0].shape[0] / secs,
            "alpha_scale_recall": common.recall_at(ids, exact, k, 1e-3),
            "alpha_rerank_candidates": c}


def oversize_section(q: torch.Tensor, v: int, rows: int, k: int,
                     dev: torch.device, seed: int,
                     search_mode: str = "auto") -> Dict:
    """``rows`` stratified rows of 48-96 distinct ids
    (``common.stratified_ell``, int16 ids) in an ELL made on ``dev`` and
    searched through ``BoTIndex(search_mode=...).search`` for the first
    1,024 queries of ``q`` (one warm-up call, one timed, the result's host
    copy included); at wiki21m's rows 'auto' sends the index to the block
    tier. Recall of 2 queries against exact scores from the plain gather
    on ``dev`` (``common.ell_scores``, independent of the kernels), within
    1e-2 of the k-th."""
    from .index import BoTIndex
    from .ops.ell import ELLMatrix

    cols, nnz = common.stratified_ell(rows, v, seed, dev, dtype=torch.int16)
    _require_on(dev, cols, nnz)
    index = BoTIndex(search_mode=search_mode, device=dev)
    index.set_ell(ELLMatrix(cols=cols, nnz=nnz, vals=None, num_cols=v))
    tier, sel = index._oversize_tier(), index._block_selection()
    qs = q[:OVERSIZE_B]
    index.search(qs, k=k)  # the compact copy, the kernels' first calls
    if tier == "block":
        _require_on(dev, *index._get_block_ell())
    t0 = time.perf_counter()
    res = index.search(qs, k=k)
    qps = qs.shape[0] / (time.perf_counter() - t0)
    nr = OVERSIZE_RECALL_QUERIES
    exact = common.ell_scores(q[:nr].to(dev), cols, nnz, v)
    return {"oversize_tier": tier, "oversize_selection": sel,
            "oversize_qps": qps,
            "oversize_recall_vs_exact": common.recall_at(
                torch.from_numpy(res.ids[:nr]), exact, k, 1e-2)}


def embed_section(dev: torch.device, seed: int, bert=None, b: int = EMBED_B,
                  l: int = EMBED_L, iters: int = EMBED_ITERS) -> float:
    """Passages a second of the VDR forward (BERT-base in bf16 by default,
    random weights and ids from ``seed``) on [b, l] tokens: ``iters``
    calls after a warm-up, one synchronise at the end."""
    from .models.bert import BertConfig, init_bert_weights
    from .models.encoder_base import build_module
    from .models.vdr import VDREncoderConfig, VDRModule

    bert = bert or BertConfig(dtype=torch.bfloat16)
    module = build_module(
        VDRModule, VDREncoderConfig(bert=bert, max_len=l,
                                    shift_vocab_num=SHIFT, topk=768),
        init_bert_weights, seed, dev, bert.dtype)
    ids = torch.randint(SHIFT, bert.vocab_size, (b, l),
                        generator=common.generator(dev, seed + 1),
                        device=dev)
    ttype, mask = torch.zeros_like(ids), torch.ones_like(ids)
    with torch.no_grad():
        module(ids, ttype, mask)
        common.sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            r = module(ids, ttype, mask)
        float(r.sum())
    return b * iters / (time.perf_counter() - t0)


# -- main ---------------------------------------------------------------------
def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-passages", type=int, default=200_000)
    ap.add_argument("--num-queries", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--query-batch", type=int, default=128)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--skip-embed-bench", action="store_true")
    ap.add_argument("--scale-rows", type=int, default=2_000_000,
                    help="rows of the synthetic bits and of the alpha "
                         "index made on the card (0 disables)")
    ap.add_argument("--stream-rows", type=int, default=WIKI21M_ROWS,
                    help="rows of the over-card index (0 disables): "
                         "wiki21m's, 86 GB packed, past the card's budget")
    ap.add_argument("--train-steps", type=int, default=30,
                    help="timed train steps at B=32 and B=64 (0 disables)")
    ap.add_argument("--device", default="cuda",
                    help="default cuda; 'cpu' runs the host sections with "
                         "the kernels' plain versions")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _device_line(dev: torch.device) -> Dict:
    info = common.device_info(dev)
    if dev.type == "cuda":
        limit = info["nvidia_smi"].split(", ")[-1]
        info["device"] = f"{info['device']} (power limit {limit})"
    return info


def main(argv=None) -> Dict:
    args = parse(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print(json.dumps({
            "metric": "bench_error", "value": 0.0, "unit": "error",
            "vs_baseline": 0.0,
            "error": "torch.cuda.is_available() is False: no card to "
                     "bench (pass --device cpu for the host sections)"}),
            flush=True)
        sys.exit(2)
    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    t_start = time.perf_counter()
    kernel_build_s = None
    if card:
        from .ops import cuda_build
        kernel_build_s = cuda_build.build_all()
        log(f"kernels built in {kernel_build_s} s")

    train = {f"train_{key}_b{b}": None for b, _ in TRAIN_SHAPES
             for key in ("hbm_gb", "steps_per_s", "tflops", "last_loss")}
    if args.train_steps and card:
        train.update(train_section(dev, args.train_steps, args.seed))

    from .index import BoTIndex
    from .ops.ell import ELLMatrix

    corpus = make_corpus(args.num_passages, seed=args.seed)
    tokenizer, tok_kind = get_bench_tokenizer()
    tok_rate = encode_rate(tokenizer, corpus[:ENCODE_PASSAGES])
    build_s, cols, nnz = build_section(tokenizer, corpus, args.batch_size)
    build_rate = args.num_passages / build_s
    log(f"build {build_rate} passages/s ({tok_kind}), encode {tok_rate}")
    v = tokenizer.vocab_size - SHIFT
    ell = ELLMatrix.from_arrays(cols, nnz, None, v, sentinel_padded=True,
                                device=dev)
    _require_on(dev, ell.cols, ell.nnz)
    index = BoTIndex(device=dev)
    index.set_ell(ell, host_cache=(cols, nnz))
    q = common.make_queries(args.num_queries, v, args.seed + 1, dev)
    res = resident_section(index, q, args.query_batch, args.topk, cols)
    log(f"resident: {res['search_qps']} queries/s ({res['search_mode']}, "
        f"{res['selection']}), recall {res['search_recall_vs_exact']}")

    beta_qps = 0.0
    if card and not args.skip_embed_bench:
        beta_qps = beta_section(tokenizer, index, corpus, args.topk, dev,
                                args.seed)
        log(f"beta search {beta_qps} queries/s")
    index.bitmat = None
    _free(dev)

    chunks = query_chunks(q, args.query_batch)
    scale = {"scale_search_qps": 0.0, "scale_search_recall": None}
    alpha = {"alpha_scale_qps": 0.0, "alpha_scale_recall": None,
             "alpha_rerank_candidates": None}
    if card and args.scale_rows:
        scale = scale_section(chunks, v, args.scale_rows, args.topk, dev,
                              args.seed + 2)
        log(f"scale: {scale}")
        _free(dev)
        alpha = alpha_section(chunks, v, args.scale_rows, args.topk, dev,
                              args.seed + 3)
        log(f"alpha: {alpha}")
        _free(dev)
    over = {"oversize_tier": None, "oversize_selection": None,
            "oversize_qps": 0.0, "oversize_recall_vs_exact": None}
    if card and args.stream_rows:
        over = oversize_section(q, v, args.stream_rows, args.topk, dev,
                                args.seed + 7)
        log(f"over the card: {over}")
        _free(dev)
    embed_ps = 0.0
    if not args.skip_embed_bench:
        embed_ps = embed_section(dev, args.seed)
        log(f"embed {embed_ps} passages/s")

    out = {
        "metric": "bot_build_passages_per_s",
        "value": build_rate,
        "unit": "passages/s",
        "vs_baseline": build_rate / BASELINE_RATE,
        "build_seconds": build_s,
        "num_passages": args.num_passages,
        "tokenizer": tok_kind,
        "tok_encode_passages_per_s": tok_rate,
        "search_qps": res["search_qps"],
        "search_recall_vs_exact": res["search_recall_vs_exact"],
        "search_mode": res["search_mode"],
        "selection": res["selection"],
        "pack_build_s": res["pack_build_s"],
        "pack_steady_s": res["pack_steady_s"],
        "kernel_build_s": kernel_build_s,
        "search_batch": args.query_batch,
        "search_k": args.topk,
        "index_rows": int(ell.shape[0]),
        "index_nnz_pad": int(ell.nnz_pad),
        "embed_passages_per_s": embed_ps,
        "beta_search_qps": beta_qps,
        "scale_rows": args.scale_rows,
        **scale,
        **alpha,
        "oversize_rows": args.stream_rows,
        **over,
        **_device_line(dev),
        "seed": args.seed,
        "seconds": time.perf_counter() - t_start,
        **train,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
