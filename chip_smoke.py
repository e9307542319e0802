#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vsearch_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # full size, as the release check runs it

Phases (each prints its lines; any failure raises and exits non-zero):
  1. card, power limit and versions;
  2. build of the CUDA kernels from ``vsearch_tpu_torch/ops/csrc``;
  3. kernels #1-#3 against their plain PyTorch versions at a ragged
     small shape;
  4. the main path: SVDR beta search through ``Retriever`` at BERT-base
     widths (random weights from ``--seed``, bf16 compute), over a
     bag-of-token index of ``--rows`` synthetic Zipf passages built by the
     C++ tokenizer, ``retrieve(rerank=True, k=100)`` on ``--batches``
     batches of 32 queries; launch counts are zeroed just before and read
     just after;
  5. the same over a second index of 65,536 rows, where the exact
     scorer (kernel #2) serves the first stage;
  6. kernels #1-#3 against their plain versions on the main path's own
     inputs, with times, bounds and the library yardstick;
  7. output checks: shapes, finite sorted scores, first-stage recall
     against exact scores, rerank scores against a dense re-embed, and a
     tiny f32 retriever on the card against the same on the CPU.

The second-to-last line of output is one JSON object describing every
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
B = 32  # queries per batch, as the beta-search CLI sends them
K = 100
SMALL_ROWS = 1 << 16  # below BoTIndex.bucketed_threshold: exact selection
LAYERS = 12
# the card; a CPU rehearsal of the control flow patches this to "cpu"
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("check failed: " + msg)


def time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches after a
    warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- synthetic data -----------------------------------------------------------
def make_vocab(rng: np.random.Generator, size: int = 30522,
               shift: int = 999) -> dict:
    """BERT-shaped vocabulary: specials and [unused*] below ``shift``,
    then unique lowercase whole words."""
    vocab = {"[PAD]": 0}
    vocab.update({f"[unused{i}]": 1 + i for i in range(99)})
    vocab.update({"[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103})
    for i in range(104, shift):
        vocab[f"[unused{i - 5}]"] = i
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < size - shift:
        for n in rng.integers(3, 10, size=size):
            words.add("".join(rng.choice(letters, size=int(n))))
    for i, w in enumerate(sorted(words)[: size - shift]):
        vocab[w] = shift + i
    return vocab


def make_corpus(rng, words, n: int, mean_len: int = 100):
    """``n`` passages of 80-120 words, Zipf(1) over ``words``."""
    p = 1.0 / np.arange(1, len(words) + 1)
    cdf = np.cumsum(p / p.sum())
    texts = []
    chunk = 1 << 16
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        idx = np.searchsorted(cdf, rng.random((m, mean_len + 20)))
        idx = np.minimum(idx, len(words) - 1)
        lens = rng.integers(mean_len - 20, mean_len + 21, size=m)
        for row, ln in zip(idx.tolist(), lens.tolist()):
            texts.append(" ".join([words[j] for j in row[:ln]]))
    return texts


def make_queries(rng, texts, n: int):
    """Queries of 4-8 words drawn from random passages, so there are
    hits."""
    out = []
    for i in rng.integers(0, len(texts), size=n):
        ws = texts[int(i)].split()
        pick = rng.choice(len(ws), size=int(rng.integers(4, 9)),
                          replace=False)
        out.append(" ".join(ws[j] for j in sorted(pick)))
    return out


# -- checks ---------------------------------------------------------------------
def same_topk(ids_a, s_a, ids_b, s_b, rtol: float) -> bool:
    """Two (ids, scores) top-k lists agree: scores within ``rtol`` and ids
    equal wherever the score is not tied with a neighbour."""
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    scale = np.maximum(np.abs(s_a).max(initial=0.0), 1e-6)
    if not np.allclose(s_a, s_b, rtol=rtol, atol=rtol * scale):
        return False
    for q in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[q] != ids_b[q])[0]:
            near = np.abs(s_a[q] - s_a[q, j]) <= rtol * scale
            if not near.sum() > 1:
                return False
    return True


def kernel_checks_small(torch, bp, dev) -> None:
    """Ragged shapes: n not a multiple of 1024, short rows, sentinel and
    negative columns, B not a multiple of 32, two k-tiles."""
    rng = np.random.default_rng(1)
    n, v, nnz_pad, b = 2500, 5000, 128, 7
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[3, :5] = -1
    nnz[7] = nnz_pad + 50
    ct, zt = torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev)
    words = bp.pack_bits(ct, zt, v)
    torch.cuda.synchronize()
    require(torch.equal(words, bp.pack_bits_plain(ct, zt, v)),
            "pack kernel != plain at the ragged shape")
    dy = torch.from_numpy((rng.integers(0, 129, size=(words.shape[1] * 32, b))
                           / 16.0).astype(np.float32)).to(dev)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    s_k, s_p = bp.score_bits(words, qT), bp.score_bits_plain(words, qT)
    require(torch.equal(s_k, s_p), "scores kernel != plain (dyadic)")
    k_k = bp.bucket_keys(words, qT, n)
    require(torch.equal(k_k, bp.bucket_keys_plain(words, qT, n)),
            "bucketed kernel != plain (dyadic)")
    qr = torch.rand((words.shape[1] * 32, b), device=dev)
    qr[v:] = 0
    qT = qr.to(torch.bfloat16)
    s_k, s_p = bp.score_bits(words, qT), bp.score_bits_plain(words, qT)
    require(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-5),
            "scores kernel != plain (random)")
    torch.cuda.synchronize()
    log("kernels at ragged shape (n=2500, V=5000, B=7): pack, scores, "
        "bucketed agree with plain")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from vsearch_tpu_torch.device import set_f32_parity
    from vsearch_tpu_torch.ops import bitpack as bp
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.tokenization.native import \
        NativeWordPieceTokenizer

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    set_f32_parity()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 1: device {name!r} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # -- phase 2: kernel build ------------------------------------------------
    build_s = cuda_build.build_all(verbose=True, force=True)
    for src, out in cuda_build.last_build["logs"].items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")
    log(f"phase 2: built {len(cuda_build.SOURCES)} kernel libraries in "
        f"{build_s:.2f} s (parallel nvcc, sm_90a)")

    # -- phase 3: ragged small shapes ------------------------------------------
    kernel_checks_small(torch, bp, dev)

    # -- set-up: vocabulary, tokenizer, corpus, model ---------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    vocab = make_vocab(rng)
    tok = NativeWordPieceTokenizer(vocab)
    words = [w for w, i in sorted(vocab.items(), key=lambda kv: kv[1])
             if i >= 999]
    texts = make_corpus(rng, words, args.rows)
    queries = make_queries(rng, texts, B * args.batches)
    log(f"set-up: vocab {len(vocab)}, {len(texts)} passages, "
        f"{len(queries)} queries in {time.perf_counter() - t0:.1f} s")
    enc = {"type": "vdr", "model_id": "synthetic", "norm": False,
           "shift_vocab_num": 999, "topk": 768, "pooling": "max",
           "vocab_size": 30522, "hidden_size": 768,
           "num_hidden_layers": LAYERS, "num_attention_heads": 12,
           "intermediate_size": 3072, "dtype": "bfloat16"}
    cfg = RetrieverConfig(encoder_q=dict(enc, max_len=128),
                          encoder_p=dict(enc, max_len=256),
                          shared_encoder=False)
    t0 = time.perf_counter()
    retriever = Retriever(cfg, tokenizer=tok, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    log(f"set-up: BERT-base VDR q+p encoders ({LAYERS} layers, "
        f"hidden 768, V'=29523, compute dtype "
        f"{retriever.encoder_q.config.bert.dtype}) in "
        f"{time.perf_counter() - t0:.1f} s")

    def drive(label, corpus):
        """Build, pack and beta-search one index; counts zeroed before."""
        torch.cuda.synchronize()
        bp.reset_launch_counts()
        t0 = time.perf_counter()
        index = retriever.build_index(corpus, index_type="bag_of_token")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        index.build_bitpack()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        results, stages = [], []
        for i in range(args.batches):
            res = retriever.retrieve(queries[i * B:(i + 1) * B], k=K,
                                     rerank=True)
            results.append(res)
            stages.append(dict(retriever.last_timings))
        launches = dict(bp.LAUNCHES)
        total = sum(sum(s.values()) for s in stages)
        log(f"phase {label}: {index.ell.shape[0]} rows "
            f"(selection {index._resolved_selection()}); build "
            f"{t1 - t0:.2f} s, pack {t2 - t1:.3f} s")
        for i, s in enumerate(stages):
            log(f"  batch {i}: " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" for k, v in s.items()))
        log(f"  {B * args.batches / total:.2f} queries/s over "
            f"{args.batches} batches; launches {launches}")
        return index, results, launches

    # -- phase 4: main path at full size ------------------------------------------
    if args.rows < 1 << 20:
        log(f"phase 4: rows cut to {args.rows} (from 1048576)")
    idx_big, res_big, launch_big = drive("4 (main path)", texts)
    require(launch_big["pack"] >= 1 and launch_big["bucketed"] >= args.batches,
            f"main path skipped kernels: {launch_big}")
    # -- phase 5: small index, exact scorer ---------------------------------------
    idx_small, res_small, launch_small = drive(
        "5 (small index)", texts[:SMALL_ROWS])
    require(launch_small["pack"] >= 1
            and launch_small["scores"] >= args.batches,
            f"small-index path skipped kernels: {launch_small}")

    # -- phase 6: kernels on the main path's inputs ---------------------------------
    q_emb = retriever.process_query(queries[:B])
    q = torch.from_numpy(q_emb).to(dev)
    kernels = []

    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
              flops, library_ms):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vsearch_tpu_torch/ops/csrc/{source}",
            "replaces": f"vsearch_tpu/ops/bitpack.py:{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms})
        log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.3f} ms, library {library_ms}), "
            f"max_abs_err {err}")

    def valid_bits(ell):
        j = torch.arange(ell.nnz_pad, device=dev)[None, :]
        return int(((j < ell.nnz[:, None]) & (ell.cols >= 0)
                    & (ell.cols < ell.num_cols)).sum())

    log("phase 6: kernels vs plain at main-path shapes")
    ell = idx_big.ell
    n, nnz_pad = ell.cols.shape
    words = idx_big.bitmat.words
    w_plain = bp.pack_bits_plain(ell.cols, ell.nnz, ell.num_cols)
    require(torch.equal(bp.pack_bits(ell.cols, ell.nnz, ell.num_cols),
                        w_plain), "pack kernel != plain at main shape")
    require(torch.equal(words, w_plain), "index words != plain pack")
    del w_plain
    entry("pack_ell", "pack.cu", 189,
          launch_big["pack"] + launch_small["pack"], 0,
          time_ms(lambda: bp.pack_bits(ell.cols, ell.nnz, ell.num_cols), 5),
          time_ms(lambda: bp.pack_bits_plain(ell.cols, ell.nnz,
                                             ell.num_cols), 2),
          n * nnz_pad * 4 + n * 4 + words.numel() * 4, 0, None)

    nbits = valid_bits(ell)
    qT = bp.prepare_queries(q, idx_big.bitmat)
    keys_k = bp.bucket_keys(words, qT, n)
    keys_p = bp.bucket_keys_plain(words, qT, n)
    dec = lambda kk: (kk & ~1023).view(torch.float32).clamp_min(0)
    err_keys = float((dec(keys_k) - dec(keys_p)).abs().max())
    scale = float(dec(keys_p).max())
    require(err_keys <= 2.0 ** -12 * scale, f"bucketed keys differ by "
            f"{err_keys} (scale {scale})")
    dy = torch.from_numpy((rng.integers(0, 129, size=qT.shape) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[ell.num_cols:] = 0
    dyT = dy.to(torch.bfloat16)
    require(torch.equal(bp.bucket_keys(words, dyT, n),
                        bp.bucket_keys_plain(words, dyT, n)),
            "bucketed keys not bit-identical under dyadic queries")
    entry("bucketed_keys", "bucketed.cu", 412,
          launch_big["bucketed"] + launch_small["bucketed"], err_keys,
          time_ms(lambda: bp.bucket_keys(words, qT, n), 5),
          time_ms(lambda: bp.bucket_keys_plain(words, qT, n), 1),
          words.numel() * 4 + qT.numel() * 2 + keys_k.numel() * 4,
          nbits * B, None)
    del keys_k, keys_p

    ell_s, words_s = idx_small.ell, idx_small.bitmat.words
    qT_s = bp.prepare_queries(q, idx_small.bitmat)
    s_k = bp.score_bits(words_s, qT_s)
    s_p = bp.score_bits_plain(words_s, qT_s)
    err_s = float((s_k - s_p).abs().max())
    require(err_s <= 1e-5 * max(float(s_p.abs().max()), 1.0),
            f"scores kernel differs from plain by {err_s}")
    # library yardstick: one bf16 matmul over the same rows as dense 0/1
    v = ell_s.num_cols
    n_s = ell_s.cols.shape[0]
    dense = bp._unpack_rows(words_s[:n_s])[:, :v].to(torch.bfloat16)
    q_bf = q.to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(q_bf, dense.T), 5)
    lib_err = float((torch.matmul(q_bf, dense.T).float()
                     - s_p[:n_s].T).abs().max())
    log(f"  library matmul [32, {v}] x [{v}, {n_s}] bf16: max_abs_err "
        f"vs plain {lib_err} (bf16 output)")
    del dense
    entry("bitpack_scores", "scores.cu", 325,
          launch_big["scores"] + launch_small["scores"], err_s,
          time_ms(lambda: bp.score_bits(words_s, qT_s), 10),
          time_ms(lambda: bp.score_bits_plain(words_s, qT_s), 2),
          words_s.numel() * 4 + qT_s.numel() * 2 + s_k.numel() * 4,
          valid_bits(ell_s) * B, lib_ms)

    # -- phase 7: outputs --------------------------------------------------------
    for res in res_big:
        require(res.ids.shape == (B, K) and res.scores.shape == (B, K),
                f"result shape {res.ids.shape}")
        require(np.isfinite(res.scores).all(), "non-finite scores")
        require((np.diff(res.scores, axis=1) <= 1e-6).all(),
                "rerank scores not sorted")
        require(res.ids.min() >= 0 and res.ids.max() < args.rows,
                "bad ids")
    # first-stage recall of the bucketed selection against exact scores
    first = idx_big.search(q_emb, k=K)
    exact = bp.score_bits_plain(words, qT)[:n].T.cpu().numpy()
    recall = []
    for i in range(B):
        kth = np.sort(exact[i])[::-1][K - 1]
        recall.append(np.mean(exact[i, first.ids[i]]
                              >= kth - 1e-3 * max(kth, 1.0)))
    log(f"phase 7: bucketed first-stage recall vs exact {np.mean(recall):.4f}")
    require(np.mean(recall) >= 0.99, f"recall {np.mean(recall)}")
    # rerank scores against a dense re-embed of the top passages
    top = res_big[0].ids[0, :5]
    dense_p = retriever.encoder_p.embed([texts[int(i)] for i in top],
                                        batch_size=B)
    expect = dense_p @ q_emb[0]
    got = res_big[0].scores[0, :5]
    log(f"  rerank scores {got.tolist()} vs dense re-embed "
        f"{expect.tolist()}")
    require(np.allclose(got, expect, rtol=2e-2, atol=1e-2 * abs(expect).max()),
            "rerank scores disagree with a dense re-embed")
    check_tiny_cpu_vs_gpu(torch, tok, texts, queries, Retriever,
                          RetrieverConfig, dev)

    del idx_big, idx_small
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def check_tiny_cpu_vs_gpu(torch, tok, texts, queries, Retriever,
                          RetrieverConfig, dev) -> None:
    """A tiny f32 retriever gives the same beta search on the card
    (kernels) as on the CPU (plain versions), exact and bucketed."""
    enc = {"type": "vdr", "shift_vocab_num": 999, "topk": 64,
           "max_len": 64, "vocab_size": 30522, "hidden_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 128}
    cfg = RetrieverConfig(encoder_q=enc, encoder_p=enc, shared_encoder=True)
    corpus = [" ".join(t.split()[:30]) for t in texts[:2048]]
    qs = queries[:8]
    cpu = Retriever(cfg, tokenizer=tok, seed=3, device="cpu")
    gpu = Retriever(cfg, tokenizer=tok, seed=3, device=dev)
    gpu.encoder_q.module.load_state_dict(cpu.encoder_q.module.state_dict())
    for sel in ("exact", "bucketed"):
        out = []
        for r in (cpu, gpu):
            r.build_index(corpus, index_type="bag_of_token")
            r.index.search_mode, r.index.selection = "bitpack", sel
            out.append((r.retrieve(qs, k=20), r.retrieve(qs, k=20,
                                                          rerank=True)))
        (f_c, r_c), (f_g, r_g) = out
        require(same_topk(f_c.ids, f_c.scores, f_g.ids, f_g.scores, 1e-5),
                f"tiny first stage ({sel}) differs between CPU and GPU")
        require(same_topk(r_c.ids, r_c.scores, r_g.ids, r_g.scores, 1e-4),
                f"tiny beta search ({sel}) differs between CPU and GPU")
    log("  tiny f32 retriever: GPU (kernels) == CPU (plain) for exact and "
        "bucketed beta search")


if __name__ == "__main__":
    sys.exit(main())
