#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vsearch_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # full size, as the release check runs it

Phases (each prints its lines; any failure raises and exits non-zero):
  1. card, power limit and versions;
  2. build of the CUDA kernels from ``vsearch_tpu_torch/ops/csrc``, with
     each kernel function's registers, spills and static shared memory
     from ``nvcc -Xptxas -v``;
  3. kernels #1-#4 against their plain PyTorch versions at a ragged
     small shape, and #2's scores, spliced and folded, against #3's keys;
     #2 and #3 in both forms (gather and plane, ``bitpack.FORMS``);
  4. the main path: SVDR beta search through ``Retriever`` at BERT-base
     widths (random weights from ``--seed``, bf16 compute), over a
     bag-of-token index of ``--rows`` synthetic Zipf passages built by the
     C++ tokenizer, ``retrieve(rerank=True, k=100)`` on ``--batches``
     batches of 32 queries; launch counts are zeroed just before and read
     just after;
  5. the same over a second index of 65,536 rows, where the exact
     scorer (kernel #2) serves the first stage;
  6. kernels #1-#3 against their plain versions on the main path's own
     inputs, with times, bounds, the library yardstick and the launch
     geometry of #2 and #3, and the plane forms of #2 and #3 on the same
     inputs (rows below the crossover: timed beside the gather forms);
  7. output checks: shapes, finite sorted scores, first-stage recall
     against exact scores, rerank scores against a dense re-embed, and a
     tiny f32 retriever on the card against the same on the CPU;
  8. once the indexes of phases 4-5 are freed, an index larger than the
     card: ``--wiki-rows`` (wiki21m's 21,015,324) bag-of-token rows made
     on the card from the seed, each row's text made on demand. ``'auto'``
     must send it to the block tier with int8 selection (kernel #4);
     ``retrieve(rerank=True, k=100)`` runs on ``--batches`` batches, then
     the same rows on the host go through the stream tier. Both first
     stages are held against the exact blockwise sweep (kernel #2, its
     launches counted as a path of its own); one block-tier first stage
     and one exact sweep are profiled by kernel; kernels #4, #3 (buckets
     16 and 8: the block and stream tiers' folds) and #2 are held against
     their plain versions on one full 262,144-row block and timed there
     with their launch geometry;
  9. alpha search at scale: ``--alpha-rows`` (2,000,000) real-valued rows
     of 64 distinct ids (weights 0.5 + U[0, 1) in bf16) made on the card;
     ``'auto'`` must route the ``SparseIndex`` to the binary-support proxy,
     ``retrieve(k=100)`` runs on ``--batches`` batches (kernels #1 and #3;
     the first search packs the support), with recall against exact
     search; #1 and #3 held bit for bit against
     their plain versions at this shape and timed; #3 and #2 in both forms
     on a 262,144-row block of 768 ids a row, and the forms' crossover
     table (262,144 rows at 64-768 ids, and 4,096-65,536 rows at 768 ids,
     B=32); the same alpha path at
     VDR's density, ``--alpha-rows`` rows of exactly 768 ids, where #3
     must run in the plane form (queries/s, stage times, launches, recall
     at C=256 against exact search, not gated, and the plane form's
     candidates against the gather form's on the same rows), and its
     fallback below k (#2) on 4,096 of its rows (the gather form) and on
     8,192 (the plane form) against the CPU; the fallback below
     k candidates (kernel #2) on 4,096 rows of 64 ids against the same
     search on the CPU;
 10. checkpoints, CLIs and the server at BERT-base width: the phase-4
     retriever saved and reloaded bit for bit; ``--served-rows`` passages
     through the build and search CLIs, each result file against
     in-process ``retrieve``, the CLI-built alpha index (up to 768 ids a
     row) through the proxy; a beta server made by ``cli.serve`` and an
     alpha server over phase 9's index, each under 16 concurrent clients,
     every answer against a serial ``retrieve`` (with the largest score
     gap and the differing ids printed), and the next request's answer
     failing the same comparison as a control;
 11. (f) DPR at BERT-base width: ``cli.build_index.dense_index`` over the
     first ``--served-rows`` passages, the rest of ``--dpr-rows``
     (wiki21m's 21,015,324) x 768 bf16 rows made on the card, chunked
     exact search through ``Retriever`` held against a float64 reference
     (with a control), ``cli.search.search_dense_index`` against
     in-process search on the CLI's file; (g) cross-modal text <-> image
     at full width (BERT-base text encoder over 27,623 valid ids, ViT-B/32
     in f32): ``--images`` (32,768) synthetic images made on the card
     batch by batch (and 4 through PNG files), ``build_index("sparse")``
     to rows of 768 ids, text -> image and image -> text retrieval, then
     the same image index through the binary-support proxy (kernels #1
     and #3, in the plane form, at V=27,623 held against their plain
     versions, #3 timed in both forms, its recall at C=256 printed); (h)
     ``cli.score.eval_wiki21m`` on (f)'s result file and
     ``cli.score.eval_beir`` on a BEIR folder with the phase-4 VDR and
     the DPR checkpoints;
 12. training: (a) a 2-layer f32 VDR trains 3 steps on the card and on
     the CPU from equal weights and batches (dropout 0), losses and global
     norms held to 1e-4 on equal weights and 1e-3 after an update; (b)
     svdr_nq at BERT-base width through ``cli.train`` on
     ``conf/train_ir_cfg.yaml`` (the phase-4 model's random weights as
     ``model_path``, bf16 compute on f32 weights, 32 queries of 128 tokens
     + 64 passages of 256) over ``--train-samples`` (2,048) synthetic
     samples made from the phase-4 corpus, one epoch cut to
     ``--train-steps`` (32) batches with a mid-epoch train-state save:
     step ms, samples/s, tokens/s, FLOP share of the bf16 peak, card peak;
     the learning gate (2 fixed batches x 12 at lr 1e-4: the mean loss of
     the last 5 steps below that of the first 5); card peak with and
     without remat; (c) one step profiled by kernel, and two backward
     passes on equal inputs compared bit for bit; (d)
     ``--mining-steps`` steps with ``ret_negatives=1`` mined over the
     phase-4 1,048,576-row bag-of-token index (kernel #1 packs it, #3 runs
     each batch's first stage; counts zeroed before, read after), mining
     ms against step ms, no mined negative holding its answer unless the
     pool was padded; (e) a fresh ``cli.train`` resumes (b)'s mid-epoch
     state and replays its next step's loss within ``RESUME_RTOL`` (a
     second resume is printed against the first as a control, with the
     sums of gradients and weights after each step); (f)
     ``--dpr-steps`` steps of dpr_nq with a BERT-base DPR bi-encoder;
 13. more than one device, over a mesh of ``MESH_SHARDS`` (4) virtual
     shards of the card (``make_mesh(devices=[cuda:0] * 4)``); launch
     counts zeroed before each sharded run and read after it, the
     one-device references run outside: (a) the phase-4 1,048,576-row
     index, its shards packed by kernel #1 a shard, searched with
     bucketed (#3) and exact (#2) selection, equal to one device bit for
     bit under dyadic weights, recall against exact >= 0.99; (d) beta
     search with rerank through ``Retriever.to_mesh`` (index and rerank
     embeds sharded) against one device; (b) phase 8's 21,015,324 rows
     remade on the card, the block tier sharded as views of the compact
     ELL (#1 and #4 a block), held against phase 8's one-device first
     stage and exact scores, with both first-stage times; (c) a dense
     index of phase 11's size sharded as views, against one device; (e)
     ``cli.serve --mesh_dp 1`` against the unsharded server over HTTP,
     and ``--mesh_dp 2`` refused with the mesh arithmetic; (f)
     ``cli.train`` as rank 0 of a one-rank NCCL group (``WORLD_SIZE=1``,
     in a process of its own) against one process: step 1's loss to 1e-6,
     later steps within ``DIST_RTOL``. No multi-card speed is measured;
 14. training on the mesh's tp axis: phase 12's svdr_nq configuration
     (BERT-base VDR, V'=29,523, q 128 / p 256, B=32 + 1 hard negative,
     bf16 autocast on f32 weights) through the trainer API from one
     checkpoint and seed, ``TP_STEPS`` (4) steps at tp=1 and at tp=4
     (``make_mesh(dp=1, tp=4, devices=[cuda:0] * 4)``: the VDR head's
     vocabulary in 4 slices, each pooled on its virtual shard; every
     step's q and p forwards are seen to split), losses held to
     ``TP_RTOL`` at step 1 and ``DIST_RTOL`` after, step 1's global norm
     and f64 sum of the clipped gradients to ``TP_NORM_RTOL`` and
     ``TP_GRAD_SUM_RTOL``, with step ms, card peak and the widest slice's logits bytes at both
     widths; then one step at tp=2 as rank 0 of a one-rank NCCL group, in
     a process of its own, held to the tp=1 run's first step the same
     way;
 15. the repo's own tools on the card (``vsearch_tpu_torch.examples``):
     (a) the quick start, tiny (its output checked for shape and
     finiteness), then from the tiny model's checkpoint and the phase-4
     retriever's BERT-base checkpoint computed in f32, each held against
     the same ``main`` on the CPU (alpha and beta ids and ``explain``'s
     top 5 tokens equal, scores within ``QUICK_RTOL``), then the
     BERT-base checkpoint as saved (bf16) on the card, its gap to the f32
     run printed; (b) the three wiki21m scripts through
     ``bash`` over phase 10's ``--served-rows`` passages and that
     checkpoint, ``beta_search.sh``'s result file held against the
     ``beta_search`` CLI's in this process (the same ids, scores within
     ``SERVED_RTOL``), any script exiting non-zero failing the phase; (c)
     the convergence demo at 4 layers of 256 over the 30,522-id
     vocabulary, ``--demo-topics`` (128) topics for ``--demo-epochs`` (90)
     epochs at B=32 (360 steps): top-1 before <= 0.2 and after >= 0.9 by
     alpha and by beta search with rerank (gated at the full size only),
     with steps/s, train seconds and card peak. Launch counts are zeroed
     before (a) and read after (c); kernels #1 and #2 must have run;
 16. the repo's probes on the card (``vsearch_tpu_torch/scripts``, the
     counterparts of ``scripts/probe_*.py``), each ``main`` in this
     process at the JAX probes' widths (``PROBE_RUNS``; stream stage B and
     the B=2,048 block sweep cut to 2,097,152 rows, the serve load, whose
     server is a child, to 2 client counts for 3 s), the plane form's two
     timing-only variants timed beside it. Launch counts are zeroed before
     each probe and read after it; every launch must have been recorded at
     its wrapper (``recorded_kernel_calls``), and after each probe every
     shape at which it first called a kernel (P1, P2 and P5 of
     ``ops/probes.py``, #1-#4 in either form) is held against the plain
     version on the same inputs (``hold_recorded_calls``);
 17. the port's bench (``python -m vsearch_tpu_torch.bench``, the
     counterpart of ``bench.py``) in this process at its defaults, its
     JSON line logged, after its resident section over 8,192 of its
     passages on the card and on the CPU (the same ids). Launch counts
     are zeroed before each and read after it, every launch recorded and
     every shape at which it called a kernel held against the plain
     version; #1, #3 and #4 must launch, the four recalls reach 0.99 and
     the over-card index (21,015,324 rows) take the block tier.

 18. the granite trunk's Mamba-2 chunk scan (``ops/ssd.py``, kernel
     ``ssd_chunk``) at granite-4.0-h-micro's widths (64 heads of 64,
     d_state 128, a 4-tap conv, bf16) on 32 sequences of 32, 64, 128 and
     256 positions, each call recorded at its wrapper and held against the
     plain twin on the same inputs (``hold_recorded_calls``), timed beside
     its bound and the twin. ``--only-ssd`` runs phases 1, 2 and 18 alone.
 19. kernel #4 at the block tier's shapes: one 262,144-row block of Zipf
     passages (``synth_bot_rows``), bucket 16, B = 32, 224, 256 and 1,024
     (``INT8_BATCHES``): each call's keys equal the plain version's bit
     for bit, in one launch that counts one read of the block's words in
     the open call record (``int8_word_passes``); then timed beside its
     bound (``score_bounds`` at that B: the words, the int8 operand and
     the keys at 3.35 TB/s) and the plain version. ``--only-int8`` runs
     phases 1, 2 and 19 alone.

The second-to-last line of output is one JSON object describing every
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import resource
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_INT8_OPS = 1979e12  # int8, dense
B = 32  # queries per batch, as the beta-search CLI sends them
K = 100
SMALL_ROWS = 1 << 16  # below BoTIndex.bucketed_threshold: exact selection
ALPHA_ROWS = 2_000_000  # the JAX package's alpha-at-scale index (bench.py)
ALPHA_NNZ = 64
DENSE_NNZ = 768  # a VDR passage row at BERT width: embed_sparse's topk
# phase 9's fallbacks below k on rows of 768 ids, (rows, k) with k above
# the rows' bucket capacity rows // 8: an index below
# bitpack.PLANE_MIN_ROWS (#2 in the gather form) and one at it (the plane
# form; k just past the top-1000 of passage-ranking evaluations)
DENSE_FALLBACKS = ((4096, 600), (8192, 1100))
# row widths of the forms' crossover table (phase 9)
CROSSOVER_IDS = (64, 128, 160, 192, 224, 256, 320, 384, 512, 768)
# ... and its row counts at 768 ids a row
CROSSOVER_ROWS = (4096, 8192, 16_384, 32_768, 65_536)
SERVED_ROWS = 8192  # passages of phase 10's CLI and server corpus
# served against serial answers: on the H100 both servers' scores came
# out bit-equal to a serial retrieve (largest gap 0.0, no id differing);
# 1e-6 of a request's top score leaves room for f32 summation order only,
# far below one bf16 step (~4e-3) or another request's answer
SERVED_RTOL = 1e-6
WIKI21M_ROWS = 21_015_324  # passages of wiki21m (docs/ARCHITECTURE.md)
DPR_DIM = 768  # DPR's [CLS] vectors at BERT-base width
# phase 11's image index: the scale of Flickr30k's 31,783 images
CROSSMODAL_IMAGES = 32_768
BLOCK_ROWS = 1 << 18  # BoTIndex.stream_block_rows: the tiers' block
LAYERS = 12
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
TRAIN_SAMPLES = 2048  # phase 12's training file
# the BERT-base shape of phase 12's bi-encoders; a CPU rehearsal of the
# control flow patches it smaller
BERT_BASE = {"vocab_size": 30522, "hidden_size": 768,
             "num_hidden_layers": LAYERS, "num_attention_heads": 12,
             "intermediate_size": 3072}
# a phase-12 step: 32 queries of 128 tokens, 64 passages of 256 (one hard
# negative each)
TRAIN_B, TRAIN_LQ, TRAIN_LP = 32, 128, 256
# (e) the resumed run's next loss against the uninterrupted run's: the same
# weights, batch and dropout masks through a forward pass whose kernels
# PyTorch runs deterministically (it came out equal on the H100); later
# steps also carry the backward pass's nondeterministic reductions
RESUME_RTOL = 1e-6
# the card; a CPU rehearsal of the control flow patches this to "cpu"
DEVICE = "cuda"
MESH_SHARDS = 4  # phase 13's virtual shards of the card
# phase 13 (d) sharded beta search against one device: the rerank embeds
# pieces of 8 passages where one device embeds 32, and bf16 GEMMs of
# other shapes may round otherwise; phase 7's rerank tolerance
RERANK_RTOL = 2e-2
DIST_STEPS = 4  # phase 13 (f): steps of cli.train as a one-rank group
# (f)'s later steps against one process's: phase 12 (e) saw two runs of
# one state drift 0.1-4% in loss after the first step (nondeterministic
# backward reductions on the card)
DIST_RTOL = 5e-2
TP_SHARDS = 4  # phase 14's virtual shards of the card along tp
TP_STEPS = 4
# phase 14's step-1 loss at tp=4 (and 2) against tp=1: equal weights and
# batch, but the bf16 head GEMM runs at another width and may take another
# cuBLAS algorithm
TP_RTOL = 1e-4
# phase 14's step 1 at tp=4 (and 2) against tp=1, past the loss: the
# unclipped global norm (gaps 1.2e-4 at tp=4 and 4.5e-5 at the NCCL tp=2
# in the first chip run that read them) and the f64 sum of the clipped
# gradients (gaps 7.8e-3 and 2.3e-2: signed terms that mostly cancel, so
# the sum is small against them). The weights after step 1 are only
# logged: svdr_nq's warmup makes the first lr 0, so they are the start's
TP_NORM_RTOL = 1e-3
TP_GRAD_SUM_RTOL = 1e-1
# phase 15: the quick start from an f32 checkpoint on the card against the
# CPU (phase 7's tolerance for an f32 retriever's beta search)
QUICK_RTOL = 1e-4
# phase 15 (a): the BERT-base checkpoint as saved (bf16) against its f32
# run on the same device. bf16 moves a few of each text's 768 top-k ids at
# the boundary, and one id that query and passage both hold moves a score
# by a few per cent of the largest, so the gap is a few per cent. On the
# ids both runs match, the scores move by bf16's rounding alone. Read on
# one checkpoint (the card an NVIDIA H100 80GB HBM3 at 700 W, the CPU its
# host's), card / CPU: largest change 0.0444 / 0.0421, on the kept ids
# 5.5e-4 / 6.8e-4, ids kept 0.978 / 0.982; the limits leave 2x, 7x, 0.03
BF16_GAP = 0.10  # largest score change, share of the largest score
BF16_KEPT = 5e-3  # the change on the matched ids both runs keep
BF16_OVERLAP = 0.95  # least share of a text's top-k ids both runs keep
# phase 15 (c): the convergence demo's configuration whose TPU run the
# README records (128 topics at B=32: 4 steps an epoch, 360 steps)
DEMO_TOPICS = 128
DEMO_EPOCHS = 90


# phase 16: the port's probes (vsearch_tpu_torch/scripts), each run in
# this process at the JAX probes' widths (the serve load's server in a
# child); only stream stage B and the b2048 sweep are cut, to 8 blocks of
# 262,144 rows, and the serve load to 2 client counts for 3 s each
PROBE_ROWS = 8 * BLOCK_ROWS
PROBE_RUNS = (  # (key of the result, probe, arguments)
    ("bitcast", "probe_bitcast_layout", []),
    ("pack", "probe_pack", []),
    ("scorer", "probe_scorer_variants", []),
    ("int8", "probe_int8_scorer", []),
    ("parts", "probe_block_parts", []),
    ("parts_b32", "probe_block_parts", ["--b", "32"]),
    ("b2048", "probe_block_b2048", ["--rows", str(PROBE_ROWS)]),
    ("regret", "bitpack_regret_probe", []),
    ("alpha", "probe_alpha_sweep", []),
    ("alpha_768", "probe_alpha_sweep", ["--nnz", "768"]),
    ("stream", "probe_stream", ["--rows", str(PROBE_ROWS)]),
    ("embed", "probe_embed_mfu", []),
    ("serve", "probe_serve_load", ["--duration", "3", "--phases", "1x1,8x1"]),
)
# phase 17: the port's bench (vsearch_tpu_torch.bench) at its defaults; its
# resident section first at this many passages on the card and on the CPU
BENCH_CHECK_PASSAGES = 8192
BENCH_RECALL_MIN = 0.99  # the first stage's recall gate (PERF.md section 2)
# the resident section's scores, card against CPU: the same bf16 queries
# over the same 0/1 rows, summed in f32 in another order
BENCH_RTOL = 1e-5

# phase 18: the chunk scan's shapes (granite-4.0-h-micro's widths), the
# sequences a call and their lengths (the rerank's length buckets)
SSD_HEADS, SSD_D_HEAD, SSD_D_STATE = 64, 64, 128
SSD_BATCH = 32
SSD_LENGTHS = (32, 64, 128, 256)
# the kernel against its twin: both compute in f32 from the same bf16 inputs
# and round to bf16 once, so they differ by the f32 sums' order and at most
# one bf16 step of the largest values
SSD_TOL = 2.0 ** -8

# phase 19: kernel #4's batches at the block tier's block (wiki21m's calls
# carry ~200 queries, padded to 224 or 256; P6 runs 1,024)
INT8_BATCHES = (32, 224, 256, 1024)

# the launch counter (cuda_build.LAUNCHES) of each kernel of the kernels line
COUNTERS = {"pack_ell": "pack", "bitpack_scores": "scores",
            "bucketed_keys": "bucketed",
            "int8_bucketed_keys": "int8_bucketed",
            "bitpack_scores_plane": "scores_plane",
            "bucketed_keys_plane": "bucketed_plane",
            # the probe kernels (ops/probes.py, phase 16)
            "bitcast_rows": "bitcast_rows", "pack_ell_t": "pack_t",
            "bucketed_keys_t": "bucketed_t",
            "bucketed_keys_t_decode_only": "bucketed_t_decode_only",
            "plane_operand_only": "plane_operand_only",
            "plane_fragments_only": "plane_fragments_only",
            "ssd_chunk": "ssd_chunk"}


def log(msg: str) -> None:
    print(msg, flush=True)


def stage_times(retriever) -> dict:
    """The stages of a retriever's last call (``query_embed``,
    ``first_stage``, ``rerank``), without the spans under them."""
    return {k: t for k, t in retriever.last_timings.items() if "/" not in k}


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


def ptxas_report(logs: dict) -> dict:
    """Per kernel function, what ``nvcc -Xptxas -v`` printed: registers a
    thread, spill stores and loads (bytes a thread) and static shared
    memory (bytes a CTA)."""
    out = {}
    for text in logs.values():
        for part in text.split("Compiling entry function '")[1:]:
            def num(pat):
                m = re.search(pat, part)
                return int(m.group(1)) if m else 0
            out[part.split("'", 1)[0]] = {
                "registers": num(r"Used (\d+) registers"),
                "spill_stores": num(r"(\d+) bytes spill stores"),
                "spill_loads": num(r"(\d+) bytes spill loads"),
                "smem": num(r"(\d+) bytes smem")}
    return out


def geometry_line(ptx: dict, name: str, geom, ms: float, nbytes: int
                  ) -> str:
    """Launch geometry, resources and achieved rate of one call of ``ms``
    of kernel #2 (``scores``, geometry from ``score_geometry``), #3
    (``bucketed``, from ``fold_geometry``) or #4 (``int8_bucketed``, from
    ``int8_fold_geometry``);
    the warps an SM holds are the CUDA runtime's occupancy figure."""
    from vsearch_tpu_torch.ops import cuda_build

    fn = f"{name}_kernel"
    r, occ_of = ptx.get(fn, {}), ""
    if hasattr(geom, "lane_queries"):  # #4 is a template: its instantiation
        tag = f"{fn}ILi{geom.lane_queries}ELb{int(geom.passes > 1)}E"
        r = next((v for k, v in ptx.items() if tag in k), {})
        occ_of = " of its 16-queries-a-lane form"
    ctas = cuda_build.occupancy(name)
    return (f"{fn}: grid {geom.grid} CTAs of {geom.warps} warps = "
            f"{geom.grid[0] * geom.grid[1]} CTAs, {geom.total_warps} warps; "
            f"{r.get('registers', 0)} registers, spills "
            f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)} B "
            f"(stores/loads), shared memory {r.get('smem', 0)} B a CTA; "
            f"{ctas * geom.warps} warps resident an SM (runtime occupancy"
            f"{occ_of}); "
            f"{nbytes / ms / 1e6:.1f} GB/s")


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


def make_corpus(rng, words, n: int, mean_len: int = 100, spread: int = 20):
    """``n`` passages of ``mean_len`` +- ``spread`` words (80-120 by
    default), Zipf(1) over ``words``."""
    p = 1.0 / np.arange(1, len(words) + 1)
    cdf = np.cumsum(p / p.sum())
    texts = []
    chunk = 1 << 16
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        idx = np.searchsorted(cdf, rng.random((m, mean_len + spread)))
        idx = np.minimum(idx, len(words) - 1)
        lens = rng.integers(mean_len - spread, mean_len + spread + 1, size=m)
        for row, ln in zip(idx.tolist(), lens.tolist()):
            texts.append(" ".join([words[j] for j in row[:ln]]))
    return texts


def make_queries(rng, texts, n: int, sources: bool = False):
    """Queries of 4-8 words drawn from random passages, so there are
    hits; with ``sources`` also each query's passage id."""
    out, src = [], rng.integers(0, len(texts), size=n)
    for i in src:
        ws = texts[int(i)].split()
        pick = rng.choice(len(ws), size=int(rng.integers(4, 9)),
                          replace=False)
        out.append(" ".join(ws[j] for j in sorted(pick)))
    return (out, src) if sources else out


def synth_bot_rows(torch, dev, n: int, seed: int, num_words: int,
                   nnz_pad: int = 128, mean_len: int = 100):
    """``n`` bag-of-token rows made on the card in chunks of 1M rows:
    80-120 Zipf(1) draws over the ``num_words`` non-special words (the
    law of ``make_corpus``), unique ids ascending, padded with the
    sentinel ``num_words`` to ``nnz_pad`` as ``build_bot_ell`` pads.
    Returns (cols [n, nnz_pad] int32, nnz [n] int32) on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = 1.0 / torch.arange(1, num_words + 1, dtype=torch.float64,
                           device=dev)
    cdf = torch.cumsum(p / p.sum(), 0)
    width = mean_len + 20
    pos = torch.arange(width, device=dev)
    cols = torch.empty((n, nnz_pad), dtype=torch.int32, device=dev)
    nnz = torch.empty(n, dtype=torch.int32, device=dev)
    for s in range(0, n, 1 << 20):
        m = min(1 << 20, n - s)
        u = torch.rand((m, width), generator=gen, device=dev,
                       dtype=torch.float64)
        ids = torch.searchsorted(cdf, u).clamp_max(num_words - 1)
        lens = torch.randint(mean_len - 20, mean_len + 21, (m, 1),
                             generator=gen, device=dev)
        ids = torch.where(pos < lens, ids, num_words).sort(dim=1).values
        dup = torch.zeros_like(ids, dtype=torch.bool)
        dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
        ids = torch.where(dup, num_words, ids).sort(dim=1).values
        cols[s:s + m, :width] = ids.to(torch.int32)
        cols[s:s + m, width:] = num_words
        nnz[s:s + m] = (ids < num_words).sum(dim=1).to(torch.int32)
    return cols, nnz


class RowTexts:
    """The passage texts of bag-of-token rows, made on access: item i
    joins the words of row i's ids (a sequence, as ``index.data``)."""

    def __init__(self, cols, nnz, words):
        self.cols, self.nnz, self.words = cols, nnz, words

    def __len__(self) -> int:
        return len(self.nnz)

    def __getitem__(self, i) -> str:
        i = int(i)
        return " ".join(self.words[j]
                        for j in self.cols[i, : self.nnz[i]].tolist())


# -- checks -------------------------------------------------------------------
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
    require(torch.equal(bp.bucket_keys(words, qT, n, 16),
                        bp.bucket_keys_plain(words, qT, n, 16)),
            "bucketed kernel (bucket 16) != plain (dyadic)")
    qr = torch.rand((words.shape[1] * 32, b), device=dev)
    qr[v:] = 0
    qT = qr.to(torch.bfloat16)
    s_k, s_p = bp.score_bits(words, qT), bp.score_bits_plain(words, qT)
    require(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-5),
            "scores kernel != plain (random)")
    for bucket in (8, 16):
        require(torch.equal(bp.splice_keys(s_k, n, bucket),
                            bp.bucket_keys(words, qT, n, bucket)),
                f"scores kernel, spliced and folded, != bucketed kernel "
                f"(bucket {bucket}, random)")
    # the plane forms (tensor cores) of #2 and #3 at the same shape
    for bb in (b, 40):  # one query tile and two
        dyp = torch.from_numpy((rng.integers(0, 129, size=(
            words.shape[1] * 32, bb)) / 16.0).astype(np.float32)).to(dev)
        dyp[v:] = 0
        dyp = dyp.to(torch.bfloat16)
        require(torch.equal(bp.score_bits(words, dyp, v, _form="plane"),
                            bp.score_bits_plain(words, dyp)),
                f"scores plane form != plain (dyadic, B={bb})")
        for bucket in (8, 16):
            require(torch.equal(
                bp.bucket_keys(words, dyp, n, bucket, v, _form="plane"),
                bp.bucket_keys_plain(words, dyp, n, bucket)),
                f"bucketed plane form (bucket {bucket}) != plain (dyadic, "
                f"B={bb})")
    s_pl = bp.score_bits(words, qT, v, _form="plane")
    require(torch.allclose(s_pl, s_p, rtol=1e-5, atol=1e-5),
            "scores plane form != plain (random)")
    for bucket in (8, 16):
        require(torch.equal(bp.splice_keys(s_pl, n, bucket),
                            bp.bucket_keys(words, qT, n, bucket, v,
                                           _form="plane")),
                f"scores plane form, spliced and folded, != bucketed plane "
                f"form (bucket {bucket}, random)")
    q8T = bp.prepare_queries_int8(
        torch.from_numpy(np.abs(rng.normal(size=(b, v)))
                         .astype(np.float32)).to(dev), words.shape[1] * 32)
    for bucket in (8, 16):
        require(torch.equal(bp.int8_bucket_keys(words, q8T, n, bucket),
                            bp.int8_bucket_keys_plain(words, q8T, n,
                                                      bucket)),
                f"int8 bucketed kernel (bucket {bucket}) != plain")
    torch.cuda.synchronize()
    log("kernels at ragged shape (n=2500, V=5000, B=7): pack, scores, "
        "bucketed (buckets 8, 16), int8 bucketed (buckets 8, 16) agree "
        "with plain; scores spliced and folded == bucketed keys (random "
        "weights); the plane forms of scores and bucketed (B=7 and 40) "
        "agree with plain, and their spliced scores == their keys")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wiki-rows", type=int, default=WIKI21M_ROWS)
    ap.add_argument("--alpha-rows", type=int, default=ALPHA_ROWS)
    ap.add_argument("--served-rows", type=int, default=SERVED_ROWS)
    ap.add_argument("--dpr-rows", type=int, default=WIKI21M_ROWS)
    ap.add_argument("--images", type=int, default=CROSSMODAL_IMAGES)
    ap.add_argument("--train-samples", type=int, default=TRAIN_SAMPLES)
    ap.add_argument("--train-steps", type=int, default=32)
    ap.add_argument("--mining-steps", type=int, default=6)
    ap.add_argument("--dpr-steps", type=int, default=4)
    ap.add_argument("--demo-topics", type=int, default=DEMO_TOPICS)
    ap.add_argument("--demo-epochs", type=int, default=DEMO_EPOCHS)
    ap.add_argument("--probe-out", default=None,
                    help="a directory for phase 16's probes' JSON files")
    ap.add_argument("--only-ssd", action="store_true",
                    help="phases 1, 2 and 18 alone (the chunk scan)")
    ap.add_argument("--only-int8", action="store_true",
                    help="phases 1, 2 and 19 alone (kernel #4)")
    args = ap.parse_args()
    # the run needs no network: a tokenizer named by a hub id must fail
    # here, not be fetched (read before ``transformers`` is imported)
    os.environ["HF_HUB_OFFLINE"] = "1"

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
    ptx = ptxas_report(cuda_build.last_build["logs"])
    for fn, r in sorted(ptx.items()):
        log(f"  ptxas {fn}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, spill loads {r['spill_loads']} B, "
            f"static shared memory {r['smem']} B")
    log(f"phase 2: built {len(cuda_build.KERNELS)} kernel libraries in "
        f"{build_s:.2f} s (parallel nvcc, sm_90a)")

    if args.only_ssd or args.only_int8:
        kernels = (phase_ssd(torch, dev) if args.only_ssd else
                   [{"name": "int8_bucketed_keys", "route": "cuda",
                     "source": "vsearch_tpu_torch/ops/csrc/int8_bucketed.cu",
                     "block_b16": phase_int8(torch, bp, dev, ptx)}])
        log(smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- phase 3: ragged small shapes -----------------------------------------
    kernel_checks_small(torch, bp, dev)

    # -- set-up: vocabulary, tokenizer, corpus, model -------------------------
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
        cuda_build.reset_launch_counts()
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
            stages.append(stage_times(retriever))
        launches = dict(cuda_build.LAUNCHES)
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

    # -- phase 4: main path at full size --------------------------------------
    if args.rows < 1 << 20:
        log(f"phase 4: rows cut to {args.rows} (from 1048576)")
    idx_big, res_big, launch_big = drive("4 (main path)", texts)
    require(launch_big["pack"] >= 1 and launch_big["bucketed"] >= args.batches,
            f"main path skipped kernels: {launch_big}")
    # -- phase 5: small index, exact scorer -----------------------------------
    idx_small, res_small, launch_small = drive(
        "5 (small index)", texts[:SMALL_ROWS])
    require(launch_small["pack"] >= 1
            and launch_small["scores"] >= args.batches,
            f"small-index path skipped kernels: {launch_small}")

    # -- phase 6: kernels on the main path's inputs ---------------------------
    q_emb = retriever.process_query(queries[:B])
    q = torch.from_numpy(q_emb).to(dev)
    kernels = []

    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
              flops, library_ms, peak=H100_F32_FLOPS):
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
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
    bits = idx_big.bitmat.words
    w_plain = bp.pack_bits_plain(ell.cols, ell.nnz, ell.num_cols)
    require(torch.equal(bp.pack_bits(ell.cols, ell.nnz, ell.num_cols),
                        w_plain), "pack kernel != plain at main shape")
    require(torch.equal(bits, w_plain), "index words != plain pack")
    del w_plain
    entry("pack_ell", "pack.cu", 189,
          launch_big["pack"] + launch_small["pack"], 0,
          time_ms(lambda: bp.pack_bits(ell.cols, ell.nnz, ell.num_cols), 5),
          time_ms(lambda: bp.pack_bits_plain(ell.cols, ell.nnz,
                                             ell.num_cols), 2),
          n * nnz_pad * 4 + n * 4 + bits.numel() * 4, 0, None)

    nbits = valid_bits(ell)
    qT = bp.prepare_queries(q, idx_big.bitmat)
    keys_k = bp.bucket_keys(bits, qT, n)
    keys_p = bp.bucket_keys_plain(bits, qT, n)
    dec = lambda kk: (kk & ~1023).view(torch.float32).clamp_min(0)
    err_keys = float((dec(keys_k) - dec(keys_p)).abs().max())
    scale = float(dec(keys_p).max())
    require(err_keys <= 2.0 ** -12 * scale, f"bucketed keys differ by "
            f"{err_keys} (scale {scale})")
    dy = torch.from_numpy((rng.integers(0, 129, size=qT.shape) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[ell.num_cols:] = 0
    dyT = dy.to(torch.bfloat16)
    keys_dy = bp.bucket_keys_plain(bits, dyT, n)
    require(torch.equal(bp.bucket_keys(bits, dyT, n), keys_dy),
            "bucketed keys not bit-identical under dyadic queries")
    ms3 = time_ms(lambda: bp.bucket_keys(bits, qT, n), 10)
    bytes3 = bits.numel() * 4 + qT.numel() * 2 + keys_k.numel() * 4
    entry("bucketed_keys", "bucketed.cu", 412,
          launch_big["bucketed"] + launch_small["bucketed"], err_keys, ms3,
          time_ms(lambda: bp.bucket_keys_plain(bits, qT, n), 1), bytes3,
          nbits * B, None)
    log("    " + geometry_line(
        ptx, "bucketed", bp.fold_geometry(bits.shape[0], bp.BUCKET, B,
                                          bits.shape[1]), ms3, bytes3))
    # the plane forms on the same inputs: rows of ~78 ids lie below the
    # crossover, so the main path does not take them (their entries come
    # from phase 9's rows of 768 ids)
    v_main = ell.num_cols
    plane = lambda w, t: bp.bucket_keys(w, t, n, bp.BUCKET, v_main,
                                        _form="plane")
    require(torch.equal(plane(bits, dyT), keys_dy),
            "bucketed plane form not bit-identical under dyadic queries")
    err_pl = float((dec(plane(bits, qT)) - dec(keys_p)).abs().max())
    require(err_pl <= 2.0 ** -12 * scale,
            f"bucketed plane form keys differ by {err_pl} (scale {scale})")
    ms3p = time_ms(lambda: plane(bits, qT), 5)
    log(f"  bucketed_keys, plane form, at these rows ({nbits / n:.1f} ids "
        f"a row, below the crossover of {bp.PLANE_MIN_BITS}): bit-identical"
        f" to plain (dyadic), max_abs_err {err_pl} (query); {ms3p:.3f} ms "
        f"against the gather form's {ms3:.3f} ms")
    main_fields = {"bucketed_keys_plane": dict(bot_ms=ms3p,
                                               bot_max_abs_err=err_pl)}
    del keys_k, keys_p, keys_dy

    ell_s, words_s = idx_small.ell, idx_small.bitmat.words
    qT_s = bp.prepare_queries(q, idx_small.bitmat)
    s_k = bp.score_bits(words_s, qT_s)
    s_p = bp.score_bits_plain(words_s, qT_s)
    err_s = float((s_k - s_p).abs().max())
    require(err_s <= 1e-5 * max(float(s_p.abs().max()), 1.0),
            f"scores kernel differs from plain by {err_s}")
    require(torch.equal(bp.score_bits(words_s, dyT),
                        bp.score_bits_plain(words_s, dyT)),
            "scores kernel not bit-identical under dyadic queries")
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
    ms2 = time_ms(lambda: bp.score_bits(words_s, qT_s), 10)
    bytes2 = words_s.numel() * 4 + qT_s.numel() * 2 + s_k.numel() * 4
    entry("bitpack_scores", "scores.cu", 325,
          launch_big["scores"] + launch_small["scores"], err_s, ms2,
          time_ms(lambda: bp.score_bits_plain(words_s, qT_s), 2), bytes2,
          valid_bits(ell_s) * B, lib_ms)
    log("    " + geometry_line(
        ptx, "scores", bp.score_geometry(words_s.shape[0], B,
                                         words_s.shape[1]), ms2, bytes2))
    v_s = ell_s.num_cols
    require(torch.equal(bp.score_bits(words_s, dyT, v_s, _form="plane"),
                        bp.score_bits_plain(words_s, dyT)),
            "scores plane form not bit-identical under dyadic queries")
    err_sp = float((bp.score_bits(words_s, qT_s, v_s, _form="plane")
                    - s_p).abs().max())
    require(err_sp <= 1e-5 * max(float(s_p.abs().max()), 1.0),
            f"scores plane form differs from plain by {err_sp}")
    ms2p = time_ms(lambda: bp.score_bits(words_s, qT_s, v_s,
                                         _form="plane"), 10)
    log(f"  bitpack_scores, plane form, at these rows: bit-identical to "
        f"plain (dyadic), max_abs_err {err_sp} (query); {ms2p:.3f} ms "
        f"against the gather form's {ms2:.3f} ms")
    main_fields["bitpack_scores_plane"] = dict(bot_ms=ms2p,
                                               bot_max_abs_err=err_sp)

    # -- phase 7: outputs -----------------------------------------------------
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
    exact = bp.score_bits_plain(bits, qT)[:n].T.cpu().numpy()
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

    # -- phase 8: an index larger than the card -------------------------------
    served_texts = texts[:args.served_rows]
    # phase 12 mines negatives over the phase-4 index: its ELL waits on
    # the host, its texts stay
    bot_ell = dataclasses.replace(ell, cols=ell.cols.cpu(),
                                  nnz=ell.nnz.cpu())
    del idx_big, idx_small, ell, bits, ell_s, words_s, qT, qT_s, s_k, s_p
    del dy, dyT
    retriever.index = None
    gc.collect()
    torch.cuda.empty_cache()
    large = phase_large(torch, bp, dev, args, retriever, tok, words, rng,
                        ptx)
    lb, ls = large["launch_block"], large["launch_stream"]
    lx = large["launch_sweep"]
    for e in kernels:  # the launches of phase 8's three paths
        e["launches"] += {"pack_ell": lb["pack"] + lx["pack"] + ls["pack"],
                          "bitpack_scores": lx["scores"],
                          "bucketed_keys": ls["bucketed"]}.get(e["name"], 0)
        if e["name"] == "bucketed_keys":  # at the stream tier's own shape
            e.update(block_b8_ms=large["b8_ms"],
                     block_b8_bound_ms=large["b8_bound_ms"])
        if e["name"] == "bitpack_scores":  # at the exact sweep's own shape
            e.update({f"block_{k}": large["scores"][k] for k in
                      ("ms", "plain_ms", "library_ms", "bound_ms",
                       "max_abs_err")})
    entry("int8_bucketed_keys", "int8_bucketed.cu", 512,
          lb["int8_bucketed"], 0, large["ms"], large["plain_ms"],
          large["nbytes"], large["ops"], None, peak=H100_INT8_OPS)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 9 and 10: alpha at scale; checkpoints, CLIs and serving -------
    t_910 = time.perf_counter()
    alpha = phase_alpha(torch, bp, dev, args, retriever, queries, ptx)
    served = phase_serving(torch, bp, dev, args, retriever, queries,
                           served_texts, alpha["index"])
    log(f"phases 9 and 10 took {time.perf_counter() - t_910:.1f} s")
    # the plane forms: their main path is phase 9's rows of 768 ids (and
    # its fallback on 8,192 of them); phase 6's rows lie below the
    # crossover width
    for kname, source, replaces in (
            ("bitpack_scores_plane", "scores_plane.cu", 325),
            ("bucketed_keys_plane", "bucketed_plane.cu", 412)):
        f = alpha["plane"]["fields"][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"vsearch_tpu_torch/ops/csrc/{source}",
            "replaces": f"vsearch_tpu/ops/bitpack.py:{replaces}",
            "launches": 0,
            "max_abs_err": f.pop("max_abs_err"), "ms": f.pop("ms"),
            "plain_ms": f.pop("plain_ms"), "bound_ms": f.pop("bound_ms"),
            "bound_by": f.pop("bound_by"),
            "library_ms": f.pop("library_ms", None)})
        kernels[-1].update(f, **main_fields[kname])
        log(f"  {kname}: {kernels[-1]['ms']:.3f} ms (plain "
            f"{kernels[-1]['plain_ms']:.3f} ms, bound "
            f"{kernels[-1]['bound_ms']:.3f} ms, library "
            f"{kernels[-1]['library_ms']})")
    for e in kernels:  # the launches of phases 9 and 10's paths
        for counts in (alpha["launch_alpha"], alpha["launch_fallback"],
                       *alpha["plane"]["launches"], *served["launches"]):
            e["launches"] += counts[COUNTERS[e["name"]]]
        e.update(alpha["fields"].get(e["name"], {}))
    del alpha, served
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 11: DPR at wiki21m size, cross-modal retrieval, scoring CLIs --
    t_11 = time.perf_counter()
    p11 = phase_eleven(torch, bp, dev, args, retriever, tok, words,
                       served_texts, ptx)
    log(f"phase 11 took {time.perf_counter() - t_11:.1f} s")
    for e in kernels:  # the launches of phase 11's bitproxy path
        e["launches"] += p11["launches"][COUNTERS[e["name"]]]
        e.update(p11["fields"].get(e["name"], {}))
    del p11
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 12: training at BERT-base width, mining over the phase-4 index
    t_12 = time.perf_counter()
    launch_12 = phase_train(torch, dev, args, retriever, tok, words,
                            texts, bot_ell)
    log(f"phase 12 took {time.perf_counter() - t_12:.1f} s")
    for e in kernels:  # the launches of phase 12's mining path
        e["launches"] += launch_12[COUNTERS[e["name"]]]
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 13: more than one device (virtual shards of the card) ---------
    launch_13 = phase_mesh(torch, bp, dev, args, retriever, tok, words,
                           texts, queries, bot_ell, large, smi)
    for e in kernels:  # the launches of phase 13's sharded paths
        e["launches"] += launch_13[COUNTERS[e["name"]]]
    # the plane forms serve dense rows, which phase 13's paths do not hold
    require(all(launch_13[c] for c in ("pack", "scores", "bucketed",
                                       "int8_bucketed")),
            f"phase 13's sharded paths skipped a kernel: {launch_13}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 14: training on the mesh's tp axis (virtual shards) ----------
    phase_tp(torch, dev, args, retriever, tok, words, texts, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 15: the repo's own tools on the card -------------------------
    launch_15 = phase_tools(torch, dev, args, retriever, queries,
                            served_texts)
    for e in kernels:  # the launches of phase 15's paths in this process
        e["launches"] += launch_15[COUNTERS[e["name"]]]
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 16: the repo's probes on the card -----------------------------
    p16 = phase_probes(torch, args)
    for e in kernels:  # the launches of the probes' paths
        e["launches"] += p16["launches"][COUNTERS[e["name"]]]
        e.update(p16["fields"].get(e["name"], {}))
    kernels += p16["entries"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 17: the port's bench on the card ------------------------------
    launch_17 = phase_bench(torch, args)
    for e in kernels:  # the launches of the bench's main path
        e["launches"] += launch_17[COUNTERS[e["name"]]]

    # -- phase 18: the granite trunk's chunk scan -----------------------------
    kernels += phase_ssd(torch, dev)

    # -- phase 19: kernel #4 at the block tier's shapes ----------------------
    block_b16 = phase_int8(torch, bp, dev, ptx)
    for e in kernels:
        if e["name"] == "int8_bucketed_keys":
            e["block_b16"] = block_b16
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def host_scores(q_rows, ids, cols, nnz, v: int):
    """Each query's weights summed over its rows' ids on the host (f32
    weights, f64 sum, f32 result): q_rows [B, V], ids [B, k] -> [B, k]."""
    rows = np.minimum(cols[ids], v)  # [B, k, nnz_pad]; sentinels -> v
    valid = np.arange(cols.shape[1]) < nnz[ids][..., None]
    qpad = np.concatenate([q_rows, np.zeros((len(q_rows), 1), np.float32)],
                          axis=1)
    g = qpad[np.arange(len(q_rows))[:, None, None], rows]
    return np.where(valid, g, 0.0).sum(axis=-1, dtype=np.float64) \
        .astype(np.float32)


def recall_by_threshold(torch, q_emb, ids, ref_scores, cols, nnz, v):
    """First-stage recall against exact top-k scores ``ref_scores`` (the
    queries rounded to bf16, as the kernels take them): the share of
    returned rows that score at least the exact k-th, as phase 7."""
    qb = torch.from_numpy(q_emb).to(torch.bfloat16).float().numpy()
    got = host_scores(qb, ids, cols, nnz, v)
    kth = ref_scores[:, -1:]
    return float(np.mean(got >= kth - 1e-3 * np.maximum(kth, 1.0)))


def profile_by_kernel(torch, label: str, fn, parts: dict) -> None:
    """Where one run of ``fn`` spends the card's time: ``torch.profiler``
    device time by kernel, the share of the host clock in which the card
    was busy, and the share of the busy time of each of ``parts`` (name ->
    regular expression searched in the kernel's name, case ignored)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events (kernels, copies); a CPU op's device time
    # counts its kernels again
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    if not rows:
        log(f"  profile of one {label}: the profiler saw no device time "
            "(not measured)")
        return
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    rows.sort(key=lambda e: -e.self_device_time_total)
    log(f"  profile of one {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy * 1e3:.1f} ms ({busy / wall:.1%}); by kernel: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
            f"x{e.count}" for e in rows[:6]))
    for name, pat in parts.items():
        hit = [e for e in rows if re.search(pat, e.key, re.IGNORECASE)]
        secs = sum(e.self_device_time_total for e in hit) / 1e6
        log(f"  {name} in that profile: {secs * 1e3:.1f} ms "
            f"x{sum(e.count for e in hit)}, {secs / busy:.1%} of the busy "
            "time")


def scores_at_block(torch, bp, blk, qT, dyT, rows: int, v: int,
                    n_bits: int, form: str = "gather",
                    plain_ms=None, library_ms=None) -> dict:
    """Kernel #2 in ``form`` on one packed block ``blk`` ([n_pad, W], its
    first ``rows`` rows valid, ``v`` columns, ``n_bits`` set bits):
    bit-identical to its plain version under the dyadic operand ``dyT``;
    under the query operand ``qT`` within f32 rounding of it and, spliced
    and folded, equal to kernel #3's keys in the same form; timed under
    ``qT`` beside its bounds, its plain version and the library yardstick
    (a bf16 matmul over the dense 0/1 rows, 65,536 rows at a time, so the
    dense operand stays ~4 GB), each timed unless given."""
    scores = lambda t: bp.score_bits(blk, t, v, _form=form)
    require(torch.equal(scores(dyT), bp.score_bits_plain(blk, dyT)),
            f"scores kernel ({form}) != plain at the block shape (dyadic)")
    got, want = scores(qT), bp.score_bits_plain(blk, qT)
    err = float((got - want).abs().max())
    require(err <= 1e-5 * max(float(want.abs().max()), 1.0),
            f"scores kernel ({form}) differs from plain by {err} at the "
            "block shape")
    require(torch.equal(bp.splice_keys(got, rows, bp.BUCKET),
                        bp.bucket_keys(blk, qT, rows, bp.BUCKET, v,
                                       _form=form)),
            f"scores kernel ({form}), spliced and folded, != bucketed "
            "kernel at the block shape")
    del want
    ms = time_ms(lambda: scores(qT), 20)
    if plain_ms is None:
        plain_ms = time_ms(lambda: bp.score_bits_plain(blk, qT), 1)
    if library_ms is None:
        q_bf = qT[:v].T.contiguous()
        library_ms = 0.0
        for r0 in range(0, rows, SMALL_ROWS):
            dense = bp._unpack_rows(blk[r0:min(r0 + SMALL_ROWS, rows)]) \
                [:, :v].to(torch.bfloat16)
            library_ms += time_ms(lambda: torch.matmul(q_bf, dense.T), 3)
            del dense
    nbytes = blk.numel() * 4 + qT.numel() * 2 + got.numel() * 4
    bd = score_bounds(nbytes, n_bits, rows, v)
    log(f"  kernel #2, {form} form, on the block ({n_bits / rows:.0f} ids "
        f"a row): bit-identical to plain (dyadic), max_abs_err {err} "
        f"(query), spliced == kernel #3's keys; {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms by "
        f"{bd['bound_by']}; {ms / bd['bound_ms']:.2f}x it; the plane form's "
        f"tensor-core work {bd['tensor_bound_ms']:.3f} ms; library "
        f"{library_ms:.3f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                max_abs_err=err, nbytes=nbytes, **bd)


def phase_large(torch, bp, dev, args, retriever, tok, words, rng,
                ptx) -> dict:
    """Phase 8: ``--wiki-rows`` rows through the block tier (Retriever,
    auto mode) and the stream tier, held against the exact blockwise
    sweep; kernels #4, #3 (buckets 16 and 8) and #2 on one full block.
    Returns the launch counts of the three paths (block tier, exact sweep,
    stream tier), kernel #4's measurements, kernel #3's at bucket 8 and
    kernel #2's at the block, and for phase 13 the query embeddings of the
    checked batches, their exact k-th scores and block-tier first stages
    with its milliseconds."""
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.index.bot_build import build_bot_ell
    from vsearch_tpu_torch.ops.ell import ELLMatrix, widen_cols

    n, v = args.wiki_rows, len(words)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    cols_d, nnz_d = synth_bot_rows(torch, dev, n, args.seed, v)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cols_h, nnz_h = cols_d.cpu().numpy(), nnz_d.cpu().numpy()
    texts = RowTexts(cols_h, nnz_h, words)
    log(f"phase 8 (index larger than the card): {n} rows made on the card "
        f"in {t1 - t0:.2f} s (nnz mean {nnz_h.mean():.1f}, max "
        f"{nnz_h.max()}), copied to the host in "
        f"{time.perf_counter() - t1:.2f} s")
    sample = rng.choice(n, size=min(1000, n), replace=False)
    built = build_bot_ell(tok, [texts[i] for i in sample], max_len=128,
                          shift=999, device="cpu")
    require(built.num_cols == v, f"tokenizer columns {built.num_cols}")
    b_cols, b_nnz = built.cols.numpy(), built.nnz.numpy()
    for r, i in enumerate(sample):
        require(b_nnz[r] == nnz_h[i] and np.array_equal(
            np.sort(b_cols[r, :b_nnz[r]]), cols_h[i, :nnz_h[i]]),
            f"row {i}: the tokenizer gives back another set of ids")
    log(f"  build_bot_ell (C++ tokenizer) gives {len(sample)} random rows "
        "back as sets")

    # -- the block tier, chosen by 'auto', through the Retriever --------------
    idx = BoTIndex(device=dev)
    idx.set_ell(ELLMatrix(cols=cols_d, nnz=nnz_d, vals=None, num_cols=v,
                          sentinel_padded=True))
    idx.data = texts
    del cols_d, nnz_d
    tier, sel = idx._oversize_tier(), idx._block_selection()
    log(f"  auto: budget {idx._budget()} B (3/4 of the card), packed "
        f"{idx._packed_bytes()} B, compact ELL {idx._ell_device_bytes()} B "
        f"-> tier {tier}, selection {sel}")
    require(tier == "block" and sel == "bucketed_int8",
            f"'auto' chose tier {tier} with {sel}")
    t0 = time.perf_counter()
    cols_b, nnz_b = idx._get_block_ell()
    torch.cuda.synchronize()
    log(f"  compact ELL on the card: {tuple(cols_b.shape)} {cols_b.dtype} "
        f"in {time.perf_counter() - t0:.2f} s")
    n_blocks = -(-n // idx.stream_block_rows)
    qtexts = make_queries(rng, texts, B * args.batches)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    results, stages = [], []
    for i in range(args.batches):
        results.append(retriever.retrieve(qtexts[i * B:(i + 1) * B], k=K,
                                          rerank=True, index=idx))
        stages.append(stage_times(retriever))
    launch_block = dict(cuda_build.LAUNCHES)
    for i, st in enumerate(stages):
        log(f"  batch {i}: " + ", ".join(
            f"{k} {t * 1e3:.1f} ms" for k, t in st.items()))
    total = sum(sum(st.values()) for st in stages)
    log(f"  block tier: {B * args.batches / total:.2f} queries/s over "
        f"{args.batches} batches of {n_blocks} blocks; launches "
        f"{launch_block}")
    need = n_blocks * args.batches
    require(launch_block["int8_bucketed"] >= need
            and launch_block["pack"] >= need,
            f"block tier skipped kernels: {launch_block}, need {need}")

    # -- the exact blockwise sweep (kernel #2), the tiers' recall reference --
    q_embs = [retriever.process_query(qtexts[i * B:(i + 1) * B])
              for i in range(min(2, args.batches))]

    def exact_sweep(qe):
        return bp.bitpack_blockwise_topk(
            torch.from_numpy(qe).to(dev), cols_b, nnz_b, v, K,
            block_rows=idx.stream_block_rows, selection="exact")

    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    refs, sweep_ms = [], []
    for qe in q_embs:
        t0 = time.perf_counter()
        refs.append(exact_sweep(qe)[1].cpu().numpy())
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
    launch_sweep = dict(cuda_build.LAUNCHES)
    log("  exact blockwise sweep: " + ", ".join(
        f"batch {i} {t:.1f} ms" for i, t in enumerate(sweep_ms))
        + f"; launches {launch_sweep}")
    need = n_blocks * len(q_embs)
    require(launch_sweep["scores"] >= need and launch_sweep["pack"] >= need,
            f"exact sweep skipped kernels: {launch_sweep}, need {need}")
    firsts, first_ms = [], []
    for i, qe in enumerate(q_embs):
        t0 = time.perf_counter()
        firsts.append(idx.search(qe, k=K))
        secs = time.perf_counter() - t0
        first_ms.append(secs * 1e3)
        rec = recall_by_threshold(torch, qe, firsts[-1].ids, refs[i],
                                  cols_h, nnz_h, v)
        log(f"  batch {i}: block-tier first stage {secs * 1e3:.1f} ms; "
            f"recall vs exact {rec:.4f}")
        require(rec >= 0.99, f"block tier recall {rec}")
    profile_by_kernel(torch, "block-tier first stage",
                      lambda: idx.search(q_embs[0], k=K),
                      {"kernel #4": r"\bint8_bucketed_kernel\b"})
    profile_by_kernel(torch, "exact blockwise sweep",
                      lambda: exact_sweep(q_embs[0]),
                      {"kernel #2": r"^scores_kernel", "pack": r"pack_kernel",
                       "top_k (sort)": r"sort"})
    first = firsts[0]
    pairs = [(qi, j) for qi in range(5) for j in (0,)]
    for qi, j in pairs:
        want = host_scores(q_embs[0][qi:qi + 1], first.ids[qi:qi + 1, j:j + 1],
                           cols_h, nnz_h, v)[0, 0]
        require(np.allclose(first.scores[qi, j], want, rtol=1e-6, atol=0),
                f"first-stage score {first.scores[qi, j]} != host {want}")
    log(f"  first-stage scores of {len(pairs)} (query, id) pairs equal host "
        "f32 sums (rtol 1e-6)")
    for res in results:
        require(res.ids.shape == (B, K) and res.scores.shape == (B, K),
                f"result shape {res.ids.shape}")
        require(np.isfinite(res.scores).all(), "non-finite scores")
        require((np.diff(res.scores, axis=1) <= 1e-6).all(),
                "rerank scores not sorted")
        require(res.ids.min() >= 0 and res.ids.max() < n, "bad ids")
    top = results[0].ids[0, :5]
    dense_p = retriever.encoder_p.embed([texts[int(i)] for i in top],
                                        batch_size=B)
    expect = dense_p @ q_embs[0][0]
    got = results[0].scores[0, :5]
    log(f"  rerank scores {got.tolist()} vs dense re-embed "
        f"{expect.tolist()}")
    require(np.allclose(got, expect, rtol=2e-2,
                        atol=1e-2 * abs(expect).max()),
            "rerank scores disagree with a dense re-embed")

    # -- kernels #4 and #3 (buckets 16 and 8) on one full block -------------
    rows = min(BLOCK_ROWS, n)
    blk = bp.pack_bits(widen_cols(cols_b[:rows]), nnz_b[:rows].contiguous(),
                       v)
    n_pad, w = blk.shape
    vp = w * 32
    q8T = bp.prepare_queries_int8(torch.from_numpy(q_embs[0]).to(dev), vp)
    keys_k = bp.int8_bucket_keys(blk, q8T, rows)
    want4 = bp.int8_bucket_keys_plain(blk, q8T, rows)
    require(torch.equal(keys_k, want4),
            "int8 bucketed kernel != plain at the block shape")
    out = dict(
        ms=time_ms(lambda: bp.int8_bucket_keys(blk, q8T, rows), 20),
        plain_ms=time_ms(lambda: bp.int8_bucket_keys_plain(blk, q8T, rows),
                         1),
        nbytes=blk.numel() * 4 + q8T.numel() + keys_k.numel() * 4,
        ops=int(nnz_b[:rows].sum()) * B)
    log(f"  kernel #4 on one {rows}-row block, B={B}: bit-identical to "
        f"plain, {out['ms']:.3f} ms")
    log("    " + geometry_line(
        ptx, "int8_bucketed", bp.int8_fold_geometry(n_pad, bp.BLOCK_BUCKET, B,
                                                    w),
        out["ms"], out["nbytes"]))
    dyT = torch.from_numpy((rng.integers(0, 129, size=(vp, B)) / 16.0)
                           .astype(np.float32)).to(dev)
    dyT[v:] = 0
    dyT = dyT.to(torch.bfloat16)
    for bucket in (bp.BLOCK_BUCKET, bp.BUCKET):  # block tier, stream tier
        keys = bp.bucket_keys(blk, dyT, rows, bucket)
        require(torch.equal(keys, bp.bucket_keys_plain(blk, dyT, rows,
                                                       bucket)),
                f"bucketed kernel (bucket {bucket}) != plain at the block "
                "shape")
        ms = time_ms(lambda: bp.bucket_keys(blk, dyT, rows, bucket), 20)
        plain = time_ms(lambda: bp.bucket_keys_plain(blk, dyT, rows, bucket),
                        1)
        nbytes = blk.numel() * 4 + dyT.numel() * 2 + keys.numel() * 4
        bound = nbytes / H100_BYTES_PER_S * 1e3
        log(f"  kernel #3 at bucket {bucket}, same block, dyadic weights: "
            f"bit-identical, {ms:.3f} ms (plain {plain:.3f} ms, bound "
            f"{bound:.3f} ms)")
        log("    " + geometry_line(
            ptx, "bucketed", bp.fold_geometry(n_pad, bucket, B, w), ms,
            nbytes))
        if bucket == bp.BUCKET:
            out.update(b8_ms=ms, b8_bound_ms=bound)
    qT = bp._prepare_bf16(torch.from_numpy(q_embs[0]).to(dev), vp)
    out["scores"] = scores_at_block(torch, bp, blk, qT, dyT, rows, v,
                                    int(nnz_b[:rows].sum()))
    log("    " + geometry_line(ptx, "scores", bp.score_geometry(n_pad, B, w),
                               out["scores"]["ms"],
                               out["scores"]["nbytes"]))
    del blk, q8T, keys_k, want4, dyT, keys, qT

    # -- the stream tier over the same rows on the host -----------------------
    sidx = BoTIndex(search_mode="stream", device=dev)
    sidx.set_ell(ELLMatrix.from_arrays(cols_h, nnz_h, None, v, True, "cpu"))
    sidx.data = texts
    t0 = time.perf_counter()
    streamer = sidx._get_streamer()
    log(f"  stream tier: host ELL trimmed to {streamer.cols.shape} "
        f"{streamer.cols.dtype} in {time.perf_counter() - t0:.2f} s, "
        f"selection {streamer.selection}")
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    for i, qe in enumerate(q_embs):
        t0 = time.perf_counter()
        res = sidx.search(qe, k=K)
        secs = time.perf_counter() - t0
        rec = recall_by_threshold(torch, qe, res.ids, refs[i], cols_h,
                                  nnz_h, v)
        log(f"  batch {i}: stream sweep {secs * 1e3:.1f} ms, "
            f"{streamer.bytes_per_sweep / secs / 1e9:.2f} GB/s host->device"
            f"; recall vs exact {rec:.4f}")
        require(rec >= 0.99, f"stream tier recall {rec}")
    launch_stream = dict(cuda_build.LAUNCHES)
    log(f"  stream tier launches {launch_stream}")
    need = n_blocks * len(q_embs)
    require(launch_stream["pack"] >= need
            and launch_stream["bucketed"] >= need,
            f"stream tier skipped kernels: {launch_stream}, need {need}")
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s; device "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host "
        "peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
        "GiB")
    out.update(launch_block=launch_block, launch_sweep=launch_sweep,
               launch_stream=launch_stream, q_embs=q_embs, refs=refs,
               firsts=firsts, first_ms=first_ms)
    return out


def synth_alpha_rows(torch, dev, n: int, seed: int, v: int,
                     nnz: int = ALPHA_NNZ):
    """``n`` real-valued rows made on the card, as the JAX package's
    alpha-at-scale index (``bench.py``), by the probes' generator
    (``vsearch_tpu_torch.scripts.common.alpha_rows``): ``nnz`` distinct
    uniform ids a row, ascending, weights 0.5 + U[0, 1) in bf16, every
    slot valid. At ``nnz=768`` the rows have the support of
    ``embed_sparse``'s rows at BERT width. Returns (cols [n, nnz] int32,
    nnz [n] int32, vals [n, nnz] bf16) on the card."""
    from vsearch_tpu_torch.scripts.common import alpha_rows

    return alpha_rows(n, v, nnz, seed, dev)


def dyadic_operand(torch, rng, dev, vp: int, v: int, b: int = B):
    """A [vp, b] bf16 query operand of multiples of 1/16 in [0, 8] (zero
    past ``v``): every sum of up to 2^17 of them is exact in f32, in any
    order, so kernels and plain versions agree bit for bit."""
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[v:] = 0
    return dy.to(torch.bfloat16)


def plane_flops(rows: int, num_cols: int, b: int = B) -> float:
    """Tensor-core operations of the plane form over ``rows`` rows: each
    bit plane below ``num_cols`` is a [rows, 128] x [128, b] product."""
    return rows * (-(-num_cols // 128)) * 128 * 2 * b


def score_bounds(nbytes: int, n_bits: int, rows: int, num_cols: int,
                 b: int = B) -> dict:
    """The bounds of kernel #2, #3 or #4 on ``rows`` rows of ``n_bits``
    set bits for ``b`` queries, in either form: the function's bound is
    the larger of its bytes over the memory rate and its work, one f32 add
    a set bit and query, over the f32 rate. ``tensor_bound_ms`` is the
    plane form's own work (every bit plane below ``num_cols`` multiplied
    in bf16) and bounds no form: most of its products multiply zeros."""
    byte_bound = nbytes / H100_BYTES_PER_S * 1e3
    ops_bound = n_bits * b / H100_F32_FLOPS * 1e3
    return dict(bound_ms=max(byte_bound, ops_bound), byte_bound_ms=byte_bound,
                tensor_bound_ms=plane_flops(rows, num_cols, b)
                / H100_BF16_FLOPS * 1e3,
                bound_by="bytes" if byte_bound >= ops_bound else "operations")


def keys_at(torch, bp, ptx, label: str, words, qT, dyT, rows: int,
            n_bits: int, num_cols: int, reps: int = 10,
            form: str = "gather", plain_ms=None) -> dict:
    """Kernel #3 at bucket 8 in ``form`` on ``words`` (``rows`` valid rows,
    ``n_bits`` set bits): bit-identical to its plain version under the
    dyadic operand ``dyT``, within 2^-12 of the keys' scale under the
    query operand ``qT``; timed under ``qT`` beside its bounds
    (``score_bounds``: the function's, the same for both forms, and the
    plane form's tensor-core work) and its plain version (timed unless
    ``plain_ms`` is given), with its launch geometry and, for the plane
    form, the CTAs the runtime fits on an SM (at least 1)."""
    keys = lambda t: bp.bucket_keys(words, t, rows, bp.BUCKET, num_cols,
                                    _form=form)
    require(torch.equal(keys(dyT), bp.bucket_keys_plain(words, dyT, rows)),
            f"bucketed kernel ({form}) != plain ({label}, dyadic)")
    got = keys(qT)
    want = bp.bucket_keys_plain(words, qT, rows)
    dec = lambda kk: (kk & ~1023).view(torch.float32).clamp_min(0)
    err = float((dec(got) - dec(want)).abs().max())
    scale = float(dec(want).max())
    require(err <= 2.0 ** -12 * scale,
            f"bucketed keys ({form}) differ by {err} ({label}, scale "
            f"{scale})")
    del want
    ms = time_ms(lambda: keys(qT), reps)
    if plain_ms is None:
        plain_ms = time_ms(lambda: bp.bucket_keys_plain(words, qT, rows), 1)
    nbytes = words.numel() * 4 + qT.numel() * 2 + got.numel() * 4
    bd = score_bounds(nbytes, n_bits, rows, num_cols)
    log(f"  kernel #3, {form} form ({label}): bit-identical to plain "
        f"(dyadic), max_abs_err {err} (query); {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms by "
        f"{bd['bound_by']}; {ms / bd['bound_ms']:.2f}x it; the plane form's "
        f"tensor-core work {bd['tensor_bound_ms']:.3f} ms)")
    if form == "plane":
        from vsearch_tpu_torch.ops import cuda_build
        require(cuda_build.occupancy("bucketed_plane") >= 1,
                "the plane form of #3 does not fit an SM")
        geom = bp.plane_geometry(words.shape[0], B, words.shape[1], num_cols,
                                 bp.BUCKET)
    else:
        geom = bp.fold_geometry(words.shape[0], bp.BUCKET, B, words.shape[1])
    log("    " + geometry_line(
        ptx, "bucketed" if form == "gather" else "bucketed_plane", geom, ms,
        nbytes))
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **bd)


def crossover_table(torch, bp, dev, seed: int, v: int, qT) -> dict:
    """Both forms of kernels #3 (bucket 8) and #2, B=32: on one
    262,144-row block at each width of ``CROSSOVER_IDS`` ids a row, and at
    768 ids a row on each row count of ``CROSSOVER_ROWS``; the times that
    set ``bitpack.PLANE_MIN_BITS`` and ``bitpack.PLANE_MIN_ROWS``."""
    def timed(n, ids):
        c, z, _ = synth_alpha_rows(torch, dev, n, seed + ids + n, v, ids)
        w = bp.pack_bits(c, z, v)
        del c, z
        t = {}
        for form in bp.FORMS:
            t[f"keys_{form}_ms"] = time_ms(lambda: bp.bucket_keys(
                w, qT, n, bp.BUCKET, v, _form=form), 5)
            t[f"scores_{form}_ms"] = time_ms(lambda: bp.score_bits(
                w, qT, v, _form=form), 5)
        return t

    def line(r):
        return (f"{r['keys_gather_ms']:.3f}/{r['keys_plane_ms']:.3f}, "
                f"{r['scores_gather_ms']:.3f}/{r['scores_plane_ms']:.3f}")

    def first(rows, key):
        return min((r[key] for r in rows
                    if r["keys_plane_ms"] < r["keys_gather_ms"]
                    and r["scores_plane_ms"] < r["scores_gather_ms"]),
                   default=None)

    widths = [dict(ids=ids, **timed(BLOCK_ROWS, ids))
              for ids in CROSSOVER_IDS]
    counts = [dict(rows=n, **timed(n, DENSE_NNZ)) for n in CROSSOVER_ROWS]
    log(f"  crossover of the forms on {BLOCK_ROWS} rows, B={B} (ms; ids a "
        "row: #3 gather/plane, #2 gather/plane): " + "; ".join(
            f"{r['ids']}: {line(r)}" for r in widths))
    log(f"  crossover of the forms at {DENSE_NNZ} ids a row, B={B} (ms; "
        "rows: #3 gather/plane, #2 gather/plane): " + "; ".join(
            f"{r['rows']}: {line(r)}" for r in counts))
    log(f"  the plane forms of #3 and #2 are both faster from "
        f"{first(widths, 'ids')} ids a row and from {first(counts, 'rows')} "
        f"rows in these tables; the rule takes them from "
        f"bitpack.PLANE_MIN_BITS = {bp.PLANE_MIN_BITS} and PLANE_MIN_ROWS = "
        f"{bp.PLANE_MIN_ROWS}")
    return dict(widths=widths, rows=counts)


def dense_alpha(torch, bp, dev, args, retriever, queries, ptx, dyT
                ) -> dict:
    """Phase 9's run at VDR's real density: ``--alpha-rows`` rows of
    exactly 768 distinct ids (``embed_sparse``'s ``topk``) through
    'auto' -> the binary-support proxy and ``Retriever.retrieve``, whose
    kernel #3 must run in the plane form (counts zeroed before, read
    after); recall at C = 196,608 // 768 against exact search (reported,
    not gated); the plane form's candidates against the gather form's on
    the same rows; #3 in the plane form at this shape; the fallback below
    k (kernel #2 in the form ``row_form`` picks) on 4,096 and on 8,192 of
    the rows against the CPU, both forms timed. The rows are freed before
    it returns."""
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch.index import SparseIndex
    from vsearch_tpu_torch.ops.ell import ELLMatrix, ell_matvec_chunked
    from vsearch_tpu_torch.ops.search import top_k

    n, v = args.alpha_rows, retriever.encoder_q.config.out_dim
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols, nnz, vals = synth_alpha_rows(torch, dev, n, args.seed + 2, v,
                                       DENSE_NNZ)
    idx = SparseIndex(device=dev)
    idx.set_ell(ELLMatrix(cols=cols, nnz=nnz, vals=vals, num_cols=v,
                          sentinel_padded=False))
    ell = idx.ell
    cand = idx.rerank_budget // ell.nnz_pad
    torch.cuda.synchronize()
    log(f"phase 9, VDR's density: {n} rows x {DENSE_NNZ} distinct ids made "
        f"on the card in {time.perf_counter() - t0:.2f} s (cols "
        f"{cols.numel() * 4 / 1e9:.2f} GB, values {vals.numel() * 2 / 1e9:.2f}"
        f" GB); auto -> {'bitproxy' if idx._use_bitproxy() else 'exact'}, "
        f"C = {idx.rerank_budget} // {ell.nnz_pad} = {cand}")
    require(idx._use_bitproxy(), "'auto' did not route to the proxy")
    cuda_build.reset_launch_counts()
    results, stages = [], []
    for i in range(args.batches):
        results.append(retriever.retrieve(queries[i * B:(i + 1) * B], k=K,
                                          index=idx))
        stages.append(stage_times(retriever))
    launches = dict(cuda_build.LAUNCHES)
    for i, st in enumerate(stages):
        log(f"  batch {i}{' (packs the support)' if i == 0 else ''}: "
            + ", ".join(f"{k} {t * 1e3:.1f} ms" for k, t in st.items()))
    warm = stages[1:] or stages
    total = sum(sum(st.values()) for st in warm)
    bm = idx.bitproxy
    log(f"  {B * len(warm) / total:.2f} queries/s over the {len(warm)} "
        f"batches after the first (k={K}); rows of {bm.mean_bits:.1f} ids "
        f"take kernel #3's {bm.form} form; launches {launches}")
    require(bm.form == "plane" and launches["pack"] == 1
            and launches["bucketed_plane"] >= args.batches
            and launches["bucketed"] == 0,
            f"the 768-id alpha path skipped the plane form: {launches}")
    for res in results:
        require(res.ids.shape == (B, K) and np.isfinite(res.scores).all()
                and (np.diff(res.scores, axis=1) <= 1e-6).all()
                and res.ids.min() >= 0 and res.ids.max() < n,
                "768-id alpha results malformed")

    q_emb = retriever.process_query(queries[:B])
    q = torch.from_numpy(q_emb).to(dev)
    t0 = time.perf_counter()
    exact = ell_matvec_chunked(q, ell)
    kth = top_k(exact, K)[0][:, K - 1:]
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    got = torch.gather(exact, 1, torch.from_numpy(results[0].ids).to(dev))
    recall = float((got >= kth - 1e-3 * kth.clamp_min(1.0)).float().mean())
    log(f"  recall at C={cand} vs exact search {recall:.4f} (not gated; "
        f"exact search {exact_s * 1e3:.1f} ms a batch)")
    del exact, got

    # -- the two forms' candidates on the same rows ---------------------------
    gather_bm = dataclasses.replace(bm, mean_bits=0.0)
    ids_p, s_p = bp.bitpack_bucketed_topk(q, bm, k=cand)
    ids_g, s_g = bp.bitpack_bucketed_topk(q, gather_bm, k=cand)
    scale = float(s_g.max())
    tol = 2.0 ** -12 * scale
    gap = float((s_p - s_g).abs().max())
    differ = untied = 0
    for r, j in torch.nonzero(ids_p != ids_g).cpu().numpy():
        differ += 1
        near = (s_g[r] - s_g[r, j]).abs() <= tol
        untied += not (int(near.sum()) > 1
                       or float(s_g[r, j] - s_g[r, -1]) <= tol)
    sel_p = time_ms(lambda: bp.bitpack_bucketed_topk(q, bm, k=cand), 5)
    sel_g = time_ms(lambda: bp.bitpack_bucketed_topk(q, gather_bm, k=cand),
                    3)
    log(f"  plane-form candidates vs gather-form on the same rows: "
        f"{differ} of {ids_p.numel()} ids differ, {untied} of them where "
        f"keys are not tied (2^-12 of scale); largest score gap {gap} "
        f"(scale {scale}); #3 + candidate top-{cand}: plane {sel_p:.3f} ms,"
        f" gather {sel_g:.3f} ms")
    require(untied == 0 and gap <= tol,
            "the forms pick other candidates where keys are not tied")
    qT = bp.prepare_queries(q, bm)
    k3p = keys_at(torch, bp, ptx, f"{n} rows, {DENSE_NNZ} ids a row",
                  bm.words, qT, dyT, n, n * DENSE_NNZ, v, reps=5,
                  form="plane")
    del results, ids_p, ids_g, s_p, s_g, gather_bm

    # -- the fallback below k on these rows: kernel #2 in the rule's form ----
    q_bf = q.to(torch.bfloat16)
    fb_launches, fb_fields = [], {}
    for fb, fb_k in DENSE_FALLBACKS:
        outs = []
        for d in (dev, "cpu"):
            sidx = SparseIndex(search_mode="bitproxy", device=d)
            sidx.set_ell(ELLMatrix(
                cols=cols[:fb].to(d).contiguous(),
                nnz=nnz[:fb].to(d).contiguous(),
                vals=vals[:fb].to(d).contiguous(), num_cols=v,
                sentinel_padded=False))
            if d == dev:
                torch.cuda.synchronize()
                cuda_build.reset_launch_counts()
            outs.append(sidx.search(q_emb, k=fb_k))
            if d == dev:
                launch_fb = dict(cuda_build.LAUNCHES)
                fb_bits = sidx.bitproxy
        form = fb_bits.form
        other = "gather" if form == "plane" else "plane"
        name = {"gather": "scores", "plane": "scores_plane"}
        require(launch_fb[name[form]] >= 1 and launch_fb[name[other]] == 0,
                f"the {fb}-row 768-id fallback skipped #2's {form} form: "
                f"{launch_fb}")
        fb_launches.append(launch_fb)
        g, c = outs
        require(same_topk(c.ids, c.scores, g.ids, g.scores, 1e-5),
                f"{fb}-row 768-id bitproxy fallback on the card != on the "
                "CPU")
        words = fb_bits.words
        qT_s = bp.prepare_queries(q, fb_bits)
        s_pl = bp.score_bits_plain(words, qT_s)
        t, errs = {}, {}
        for f in bp.FORMS:
            s_k = bp.score_bits(words, qT_s, v, _form=f)
            errs[f] = float((s_k - s_pl).abs().max())
            require(errs[f] <= 1e-5 * max(float(s_pl.abs().max()), 1.0),
                    f"scores {f} form differs from plain by {errs[f]} "
                    f"({fb}-row fallback)")
            require(torch.equal(bp.score_bits(words, dyT, v, _form=f),
                                bp.score_bits_plain(words, dyT)),
                    f"scores {f} form != plain on the {fb}-row fallback's "
                    "rows (dyadic)")
            t[f] = time_ms(lambda: bp.score_bits(words, qT_s, v, _form=f),
                           20)
        plain_ms = time_ms(lambda: bp.score_bits_plain(words, qT_s), 2)
        dense = bp._unpack_rows(words[:fb])[:, :v].to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(q_bf, dense.T), 20)
        del dense
        nbytes = words.numel() * 4 + qT_s.numel() * 2 + s_pl.numel() * 4
        bd = score_bounds(nbytes, fb * DENSE_NNZ, fb, v)
        log(f"  fallback ({fb} rows of {DENSE_NNZ} ids, k={fb_k} > capped "
            f"{min(cand, words.shape[0] // 8)}): card == CPU (rtol 1e-5); "
            f"launches {launch_fb}; kernel #2 takes the {form} form; both "
            f"forms bit-identical to plain (dyadic), max_abs_err "
            f"{errs[form]} (query); {t[form]:.4f} ms ({other} form "
            f"{t[other]:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, the plane form's "
            f"tensor-core work {bd['tensor_bound_ms']:.4f} ms, library "
            f"{lib_ms:.4f} ms)")
        fb_fields[fb] = dict(form=form, ms=t[form], other_ms=t[other],
                             plain_ms=plain_ms, library_ms=lib_ms,
                             max_abs_err=errs[form], **bd)
        del sidx, fb_bits, words, s_pl, outs, g, c
    del idx, ell, cols, nnz, vals, bm, qT
    gc.collect()
    torch.cuda.empty_cache()
    small, large = (fb_fields[fb] for fb, _ in DENSE_FALLBACKS)
    require(small["form"] == "gather" and large["form"] == "plane",
            f"the fallbacks took the forms {small['form']}, {large['form']}")
    (rows_s, _), (rows_l, _) = DENSE_FALLBACKS
    fields = {
        "bucketed_keys_plane": dict(
            alpha768_recall_c256=recall,
            alpha768_queries_per_s=B * len(warm) / total,
            alpha768_candidate_ids_differ=differ,
            alpha768_select_ms=sel_p, alpha768_select_gather_ms=sel_g,
            **k3p),
        # the plane form of #2 at its main path's shape: the fallback on
        # 8,192 rows of 768 ids
        "bitpack_scores_plane": dict(
            {k: x for k, x in large.items() if k not in ("form", "other_ms")},
            fallback_rows=rows_l, gather_ms=large["other_ms"]),
        # the 4,096-row fallback of 768 ids stays in the gather form
        "bitpack_scores": {f"fallback{rows_s}x768_{k}": x
                           for k, x in small.items() if k != "form"}}
    return dict(launches=(launches, *fb_launches), fields=fields)


def phase_alpha(torch, bp, dev, args, retriever, queries, ptx) -> dict:
    """Phase 9: ``--alpha-rows`` real-valued rows through the
    binary-support proxy, chosen by 'auto', through the Retriever; recall
    against exact search; kernels #1 and #3 at this shape (and #3 at 768
    ids a row); the fallback to kernel #2 on 4,096 rows against the CPU.
    Returns the index (served in phase 10), the launch counts of the
    proxy path and of the fallback, and the kernels' extra fields."""
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch.index import SparseIndex
    from vsearch_tpu_torch.ops import two_stage as ts
    from vsearch_tpu_torch.ops.ell import ELLMatrix, ell_matvec_chunked
    from vsearch_tpu_torch.ops.search import top_k

    n, v = args.alpha_rows, retriever.encoder_q.config.out_dim
    rng = np.random.default_rng(args.seed + 9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols, nnz, vals = synth_alpha_rows(torch, dev, n, args.seed, v)
    torch.cuda.synchronize()
    idx = SparseIndex(device=dev)
    idx.set_ell(ELLMatrix(cols=cols, nnz=nnz, vals=vals, num_cols=v,
                          sentinel_padded=False))
    ell = idx.ell
    cand = idx.rerank_budget // ell.nnz_pad
    log(f"phase 9 (alpha at scale): {n} rows x {ALPHA_NNZ} distinct ids "
        f"(V'={v}, weights 0.5 + U[0, 1) bf16) made on the card in "
        f"{time.perf_counter() - t0:.2f} s; auto -> "
        f"{'bitproxy' if idx._use_bitproxy() else 'exact'}, candidates "
        f"C = {idx.rerank_budget} // {ell.nnz_pad} = {cand}")
    require(idx._use_bitproxy(), "'auto' did not route to the proxy")
    require(idx.bitproxy is None, "set_ell kept a packed support")
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    results, stages = [], []
    for i in range(args.batches):
        # the first search packs the support itself, as a user's first
        # request does
        results.append(retriever.retrieve(queries[i * B:(i + 1) * B], k=K,
                                          index=idx))
        stages.append(stage_times(retriever))
    launch_alpha = dict(cuda_build.LAUNCHES)
    for i, st in enumerate(stages):
        log(f"  batch {i}{' (packs the support)' if i == 0 else ''}: "
            + ", ".join(f"{k} {t * 1e3:.1f} ms" for k, t in st.items()))
    warm = stages[1:] or stages
    total = sum(sum(st.values()) for st in warm)
    log(f"  {B * len(warm) / total:.2f} queries/s over the {len(warm)} "
        f"batches after the first (k={K}); launches {launch_alpha}")
    require(idx.bitproxy is not None and launch_alpha["pack"] == 1
            and launch_alpha["bucketed"] >= args.batches,
            f"alpha path skipped kernels or packed twice: {launch_alpha}")
    for res in results:
        require(res.ids.shape == (B, K) and np.isfinite(res.scores).all()
                and (np.diff(res.scores, axis=1) <= 1e-6).all()
                and res.ids.min() >= 0 and res.ids.max() < n,
                "alpha results malformed")

    # -- recall of one batch against exact search over the same ELL ---------
    q_emb = retriever.process_query(queries[:B])
    q = torch.from_numpy(q_emb).to(dev)
    t0 = time.perf_counter()
    exact = ell_matvec_chunked(q, ell)
    kth = top_k(exact, K)[0][:, K - 1:]
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    ids = torch.from_numpy(results[0].ids).to(dev)
    got = torch.gather(exact, 1, ids)
    recall = float((got >= kth - 1e-3 * kth.clamp_min(1.0)).float().mean())
    serr = float((got - torch.from_numpy(results[0].scores).to(dev)).abs()
                 .max())
    log(f"  recall vs exact search {recall:.4f} (exact search "
        f"{exact_s * 1e3:.1f} ms a batch); returned scores vs exact "
        f"max_abs_err {serr}")
    require(recall >= 0.99, f"alpha recall {recall}")
    require(serr <= 1e-4 * float(got.abs().max()),
            f"returned scores differ from exact by {serr}")
    del exact, got

    # -- kernels #1 and #3 at this shape ------------------------------------
    fields = {}
    words = idx.bitproxy.words
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, n)
        require(torch.equal(words[r0:r0 + bp._round_up(r1 - r0, 1024)],
                            bp.pack_bits_plain(cols[r0:r1], nnz[r0:r1], v)),
                f"pack kernel != plain at rows {r0}-{r1}")
    pack_ms = time_ms(lambda: bp.pack_bits(cols, nnz, v), 5)
    pack_plain = time_ms(lambda: bp.pack_bits_plain(cols, nnz, v), 1)
    pack_bytes = cols.numel() * 4 + nnz.numel() * 4 + words.numel() * 4
    pack_bound = pack_bytes / H100_BYTES_PER_S * 1e3
    log(f"  kernel #1 at {n} x {ALPHA_NNZ}: bit-identical to plain (in "
        f"{BLOCK_ROWS}-row slices); {pack_ms:.3f} ms (plain {pack_plain:.3f}"
        f" ms, bound {pack_bound:.3f} ms, "
        f"{pack_bytes / pack_ms / 1e6:.1f} GB/s)")
    fields["pack_ell"] = dict(alpha_ms=pack_ms, alpha_plain_ms=pack_plain,
                              alpha_bound_ms=pack_bound)
    vp = words.shape[1] * 32
    qT = bp.prepare_queries(q, idx.bitproxy)
    dyT = dyadic_operand(torch, rng, dev, vp, v)
    n_bits = n * ALPHA_NNZ
    k3 = keys_at(torch, bp, ptx, f"{n} rows, {ALPHA_NNZ} ids a row", words,
                 qT, dyT, n, n_bits, v)
    blk = words[:BLOCK_ROWS]
    k3b = keys_at(torch, bp, ptx, f"{BLOCK_ROWS}-row block, {ALPHA_NNZ} ids "
                  "a row", blk, qT, dyT, BLOCK_ROWS, BLOCK_ROWS * ALPHA_NNZ,
                  v)
    cand_ids, _ = bp.bitpack_bucketed_topk(q, idx.bitproxy, k=cand)
    rr_ms = time_ms(lambda: ts.exact_rerank(q, ell, cand_ids, K), 10)
    sel_ms = time_ms(lambda: bp.bitpack_bucketed_topk(q, idx.bitproxy,
                                                      k=cand), 5)
    log(f"  first stage split: #3 + candidate top-{cand} {sel_ms:.3f} ms, "
        f"exact_rerank [{B}, {cand}] x {ell.nnz_pad} {rr_ms:.3f} ms")

    # -- kernels #3 and #2 at 768 ids a row (embed_sparse's rows at BERT
    # width), in both forms --------------------------------------------------
    c768, z768, _ = synth_alpha_rows(torch, dev, BLOCK_ROWS, args.seed + 1,
                                     v, 768)
    w768 = bp.pack_bits(c768, z768, v)
    require(torch.equal(w768, bp.pack_bits_plain(c768, z768, v)),
            "pack kernel != plain at 768 ids a row")
    del c768, z768
    lab = f"{BLOCK_ROWS}-row block, 768 ids a row"
    k768 = keys_at(torch, bp, ptx, lab, w768, qT, dyT, BLOCK_ROWS,
                   BLOCK_ROWS * 768, v)
    k768p = keys_at(torch, bp, ptx, lab, w768, qT, dyT, BLOCK_ROWS,
                    BLOCK_ROWS * 768, v, form="plane",
                    plain_ms=k768["plain_ms"])
    s768 = scores_at_block(torch, bp, w768, qT, dyT, BLOCK_ROWS, v,
                           BLOCK_ROWS * 768)
    s768p = scores_at_block(torch, bp, w768, qT, dyT, BLOCK_ROWS, v,
                            BLOCK_ROWS * 768, form="plane",
                            plain_ms=s768["plain_ms"],
                            library_ms=s768["library_ms"])
    del w768
    cross = crossover_table(torch, bp, dev, args.seed, v, qT)
    fields["bucketed_keys"] = {
        **{f"alpha_{k}": x for k, x in k3.items()},
        **{f"alpha_block_{k}": x for k, x in k3b.items()},
        **{f"ids768_{k}": x for k, x in k768.items()}}
    fields["bitpack_scores"] = {f"ids768_{k}": x for k, x in s768.items()
                                if k != "nbytes"}
    plane = dense_alpha(torch, bp, dev, args, retriever, queries, ptx, dyT)
    plane["fields"]["bucketed_keys_plane"].update(
        {f"block768_{k}": x for k, x in k768p.items()},
        crossover=cross)
    plane["fields"]["bitpack_scores_plane"].update(
        {f"block768_{k}": x for k, x in s768p.items() if k != "nbytes"})
    fields["bitpack_scores"].update(plane["fields"].pop("bitpack_scores"))

    # -- the fallback below k candidates: kernel #2, against the CPU --------
    small = ELLMatrix(cols=cols[:4096].contiguous(),
                      nnz=nnz[:4096].contiguous(),
                      vals=vals[:4096].contiguous(), num_cols=v,
                      sentinel_padded=False)
    outs = []
    for d in (dev, "cpu"):
        sidx = SparseIndex(search_mode="bitproxy", device=d)
        sidx.set_ell(small if d == dev else ELLMatrix(
            cols=small.cols.cpu(), nnz=small.nnz.cpu(),
            vals=small.vals.cpu(), num_cols=v, sentinel_padded=False))
        if d == dev:
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
        outs.append(sidx.search(q_emb, k=600))
        if d == dev:
            launch_fallback = dict(cuda_build.LAUNCHES)
            fb_bits = sidx.bitproxy
    require(launch_fallback["scores"] >= 1 and launch_fallback["pack"] >= 1
            and launch_fallback["bucketed"] == 0,
            f"fallback skipped kernel #2: {launch_fallback}")
    (g, c) = outs
    require(same_topk(c.ids, c.scores, g.ids, g.scores, 1e-5),
            "bitproxy fallback on the card != on the CPU")
    fb_words = fb_bits.words
    qT_s = bp.prepare_queries(q, fb_bits)
    s_k, s_p = bp.score_bits(fb_words, qT_s), bp.score_bits_plain(fb_words,
                                                                  qT_s)
    fb_err = float((s_k - s_p).abs().max())
    require(torch.equal(bp.score_bits(fb_words, dyT),
                        bp.score_bits_plain(fb_words, dyT)),
            "scores kernel != plain on the fallback's rows (dyadic)")
    fb_ms = time_ms(lambda: bp.score_bits(fb_words, qT_s), 20)
    fb_plain = time_ms(lambda: bp.score_bits_plain(fb_words, qT_s), 2)
    fb_bytes = fb_words.numel() * 4 + qT_s.numel() * 2 + s_k.numel() * 4
    fb_bound = max(fb_bytes / H100_BYTES_PER_S,
                   4096 * ALPHA_NNZ * B / H100_F32_FLOPS) * 1e3
    # library yardstick: one bf16 matmul over the same rows as dense 0/1
    dense = bp._unpack_rows(fb_words[:4096])[:, :v].to(torch.bfloat16)
    q_bf = q.to(torch.bfloat16)
    fb_lib = time_ms(lambda: torch.matmul(q_bf, dense.T), 20)
    del dense
    log(f"  fallback (4,096 rows, k=600 > capped "
        f"{min(idx.rerank_budget // ALPHA_NNZ, fb_words.shape[0] // 8)}): "
        f"card == CPU (rtol 1e-5); launches {launch_fallback}; kernel #2 "
        f"bit-identical to plain (dyadic), max_abs_err {fb_err} (query), "
        f"{fb_ms:.4f} ms (plain {fb_plain:.3f} ms, bound {fb_bound:.4f} ms, "
        f"library {fb_lib:.4f} ms)")
    fields["bitpack_scores"].update(fallback_ms=fb_ms,
                                    fallback_plain_ms=fb_plain,
                                    fallback_bound_ms=fb_bound,
                                    fallback_library_ms=fb_lib,
                                    fallback_max_abs_err=fb_err)
    return dict(index=idx, launch_alpha=launch_alpha,
                launch_fallback=launch_fallback, fields=fields, plane=plane)


def http(url: str, payload=None):
    """GET (no payload) or POST a JSON payload; returns the decoded
    answer."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def load_test(torch, label: str, server, reqs, rerank: bool,
              rtol: float) -> dict:
    """Serve ``server`` on a thread and send it ``reqs`` (lists of
    queries) from 16 concurrent clients, 4 requests each, ``k=100``, with
    one /embed, /healthz and /stats alongside. Every answer is held
    against a serial ``retrieve`` of its queries (``same_topk`` within
    ``rtol``), and the coalescer must have made fewer device calls than
    it got requests. Returns the launch counts of the run."""
    from vsearch_tpu_torch.ops import cuda_build
    import threading

    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service = server.service
    try:
        require(http(url + "/healthz") == {"status": "ok"}, "healthz")
        calls0 = service._coalescer.device_calls
        answers, lat, side = {}, {}, {}

        def client(c):
            for j in range(4):
                i = c * 4 + j
                t0 = time.perf_counter()
                answers[i] = http(url + "/search", {
                    "queries": reqs[i], "k": K, "rerank": rerank})
                lat[i] = time.perf_counter() - t0

        def extras():
            side["embed"] = http(url + "/embed", {"texts": reqs[0]})
            side["healthz"] = http(url + "/healthz")
            side["stats"] = http(url + "/stats")

        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)] + [threading.Thread(target=extras)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        stats = http(url + "/stats")
    finally:
        server.shutdown()
        server.server_close()
    require(len(answers) == len(reqs) and side["healthz"]["status"] == "ok"
            and len(side["embed"]["dims"]) == len(reqs[0])
            and "search" in side["stats"], f"{label}: lost answers")
    calls = stats["coalesced_device_calls"] - calls0
    require(calls < len(reqs), f"{label}: {calls} device calls for "
            f"{len(reqs)} requests")
    retriever = service.retriever
    serial = [retriever.retrieve(qs, k=K, rerank=rerank) for qs in reqs]
    got = [(np.asarray(a["ids"]), np.asarray(a["scores"], np.float32))
           for a in (answers[i] for i in range(len(reqs)))]
    # readings that set rtol: the largest score gap relative to the
    # request's largest score, and the ids that differ at all
    gap, n_diff = 0.0, 0
    for want, (ids, scores) in zip(serial, got):
        scale = max(float(np.abs(want.scores).max()), 1e-6)
        gap = max(gap, float(np.abs(scores - want.scores).max()) / scale)
        n_diff += int((ids != want.ids).sum())
    # control: the next request's answer (other queries) must fail the
    # same comparison, or the tolerance cannot tell answers apart
    swapped = sum(same_topk(want.ids, want.scores, *got[(i + 1) % len(got)],
                            rtol) for i, want in enumerate(serial))
    log(f"  {label}: served vs serial: largest relative score gap {gap}, "
        f"{n_diff} of {len(reqs) * len(reqs[0]) * K} ids differ; control: "
        f"{swapped} of {len(reqs)} requests pass with the next request's "
        f"answer (rtol {rtol})")
    for i, (want, (ids, scores)) in enumerate(zip(serial, got)):
        require(same_topk(want.ids, want.scores, ids, scores, rtol),
                f"{label}: request {i} differs from a serial retrieve")
    require(swapped == 0, f"{label}: the control passed {swapped} times")
    ts = np.sort(np.asarray(list(lat.values())))
    nq = sum(len(r) for r in reqs)
    log(f"  {label}: {len(reqs)} requests of {len(reqs[0])} queries from 16 "
        f"clients (+ /embed, /healthz, /stats) in {wall:.2f} s: "
        f"{nq / wall:.2f} queries/s, latency p50 "
        f"{ts[len(ts) // 2] * 1e3:.1f} ms, p99 "
        f"{ts[min(len(ts) - 1, int(len(ts) * 0.99))] * 1e3:.1f} ms "
        f"(slowest {', '.join(f'{x * 1e3:.1f}' for x in ts[-3:])} ms); "
        f"{calls} coalesced device calls (their time p50 "
        f"{stats['search']['p50_s'] * 1e3:.1f} ms, p99 "
        f"{stats['search']['p99_s'] * 1e3:.1f} ms; /embed "
        f"{stats['embed'].get('mean_s', 0.0) * 1e3:.1f} ms); every answer "
        "== serial retrieve "
        f"(rtol {rtol}); launches {launches}")
    return launches


def phase_serving(torch, bp, dev, args, retriever, queries, texts,
                  alpha_index) -> dict:
    """Phase 10: the phase-4 retriever saved and reloaded bit for bit; the
    build and search CLIs over ``texts``; a beta server made by
    ``cli.serve`` and an alpha server over phase 9's index under
    concurrent load. Returns the launch counts of its paths."""
    from vsearch_tpu_torch.ops import cuda_build
    import shutil
    import tempfile

    from vsearch_tpu_torch.cli.build_index import (binary_token_index,
                                                   sparse_index)
    from vsearch_tpu_torch.cli.search import (beta_search,
                                              search_sparse_index)
    from vsearch_tpu_torch.cli.serve import make_parser, prepare_retriever
    from vsearch_tpu_torch.ops.ell import ell_matvec_chunked
    from vsearch_tpu_torch.ops.search import top_k
    from vsearch_tpu_torch.retriever import Retriever
    from vsearch_tpu_torch.serve import serve

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    launches = []
    try:
        # -- 1. checkpoint round trip ----------------------------------------
        ckpt = f"{work}/ckpt"
        t0 = time.perf_counter()
        retriever.save_pretrained(ckpt)
        t1 = time.perf_counter()
        loaded = Retriever.from_pretrained(ckpt, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        qs = queries[:B]
        require(np.array_equal(loaded.encoder_q.embed(qs),
                               retriever.encoder_q.embed(qs)),
                "reloaded query embeddings differ")
        require(np.array_equal(loaded.encoder_p.embed(texts[:8]),
                               retriever.encoder_p.embed(texts[:8])),
                "reloaded passage embeddings differ")
        log(f"phase 10 (checkpoints, CLIs, serving): save_pretrained "
            f"{t1 - t0:.2f} s, from_pretrained onto the card {t2 - t1:.2f} "
            "s; query and passage embeddings bit-identical")

        # -- 2. the build and search CLIs ------------------------------------
        corpus, qfile = f"{work}/corpus.jsonl", f"{work}/queries.jsonl"
        with open(corpus, "w") as f:
            f.writelines(json.dumps({"text": t}) + "\n" for t in texts)
        nq = min(64, len(queries))
        with open(qfile, "w") as f:
            f.writelines(json.dumps({"question": q}) + "\n"
                         for q in queries[:nq])
        dv = ["--device", str(dev)]
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        binary_token_index.main(["--text_file", corpus, "--save_file",
                                 f"{work}/bot.npz", "--tokenizer", ckpt,
                                 "--num_shift", "999", *dv])
        t1 = time.perf_counter()
        sparse_index.main(["--checkpoint", ckpt, "--text_file", corpus,
                           "--save_file", f"{work}/alpha.npz", *dv])
        t2 = time.perf_counter()
        search_sparse_index.main(["--checkpoint", ckpt, "--query_file",
                                  qfile, "--index_file", f"{work}/alpha.npz",
                                  "--save_file", f"{work}/alpha.json",
                                  "--topk", str(K), *dv])
        t3 = time.perf_counter()
        beta_search.main(["--checkpoint", ckpt, "--query_file", qfile,
                          "--text_file", corpus, "--index_file",
                          f"{work}/bot.npz", "--save_file",
                          f"{work}/beta.json", "--topk", str(K), *dv])
        t4 = time.perf_counter()
        log(f"  CLIs over {len(texts)} passages, {nq} queries: "
            f"binary_token_index {t1 - t0:.2f} s, sparse_index "
            f"{t2 - t1:.2f} s, search_sparse_index {t3 - t2:.2f} s, "
            f"beta_search {t4 - t3:.2f} s (each loads the checkpoint)")
        for name, index, kind, rerank in (
                ("alpha", "alpha", "sparse", False),
                ("beta", "bot", "bag_of_token", True)):
            with open(f"{work}/{name}.json") as f:
                res = json.load(f)
            ids = np.asarray([r["ids"] for r in res])
            scores = np.asarray([r["scores"] for r in res], np.float32)
            loaded.load_index(f"{work}/{index}.npz",
                              data_file=corpus if rerank else None,
                              index_type=kind)
            want = [loaded.retrieve(queries[s:s + B], k=K, rerank=rerank)
                    for s in range(0, nq, B)]
            w_ids = np.concatenate([w.ids for w in want])
            w_s = np.concatenate([w.scores for w in want])
            exact = (np.array_equal(ids, w_ids)
                     and np.array_equal(scores, w_s))
            require(ids.shape == (nq, K) and (exact or same_topk(
                w_ids, w_s, ids, scores, 1e-6)),
                f"{name} CLI results differ from in-process retrieve")
            log(f"  {name} CLI result file == in-process retrieve on the "
                f"loaded files ({'bit-identical' if exact else 'rtol 1e-6'}"
                f"); index {loaded.index.ell.shape}, nnz_pad "
                f"{loaded.index.ell.nnz_pad}")
        # the CLI-built alpha index (embed_sparse rows) through the proxy
        aidx = loaded.load_index(f"{work}/alpha.npz", index_type="sparse",
                                 search_mode="bitproxy")
        res = loaded.retrieve(queries[:B], k=K)
        q = torch.from_numpy(loaded.process_query(queries[:B])).to(dev)
        exact = ell_matvec_chunked(q, aidx.ell)
        kth = top_k(exact, K)[0][:, K - 1:]
        got = torch.gather(exact, 1, torch.from_numpy(res.ids).to(dev))
        rec = float((got >= kth - 1e-3 * kth.clamp_min(1.0)).float().mean())
        require(torch.equal(aidx.bitproxy.words, bp.pack_bits_plain(
            aidx.ell.cols, aidx.ell.nnz, aidx.ell.num_cols)),
            "pack kernel != plain on the CLI-built alpha index")
        nnz_h = aidx.ell.nnz.cpu().numpy()
        launches.append(dict(cuda_build.LAUNCHES))
        log(f"  CLI-built alpha index through the proxy: rows of "
            f"{nnz_h.mean():.1f} ids on average (max {nnz_h.max()}), "
            f"C = {aidx.rerank_budget // aidx.ell.nnz_pad}, kernel #3's "
            f"{aidx.bitproxy.form} form; recall vs exact "
            f"{rec:.4f} (not gated); pack == plain; launches of the CLI "
            f"section {launches[-1]}")
        # the proxy's kernel #3 in the form of the rows' width
        fold = COUNTERS["bucketed_keys_plane" if aidx.bitproxy.form == "plane"
                        else "bucketed_keys"]
        require(launches[-1]["pack"] >= 2 and launches[-1]["scores"] >= 1
                and launches[-1][fold] >= 1,
                f"CLI section skipped kernels: {launches[-1]}")
        del loaded, aidx, exact, got, q
        gc.collect()

        # -- 3. a beta server made by cli.serve ------------------------------
        reqs = [queries[(2 * i) % len(queries):(2 * i) % len(queries) + 2]
                for i in range(64)]
        ap = make_parser()
        t0 = time.perf_counter()
        beta = prepare_retriever(ap.parse_args(
            ["--checkpoint", ckpt, "--index_file", f"{work}/bot.npz",
             "--index_type", "bag_of_token", "--data_file", corpus,
             "--warmup", *dv]), ap)
        log(f"  cli.serve.prepare_retriever (checkpoint, index, warm-up) "
            f"{time.perf_counter() - t0:.2f} s")
        launches.append(load_test(
            torch, "beta server (rerank)",
            serve(beta, host="127.0.0.1", port=0), reqs, True, SERVED_RTOL))
        require(launches[-1]["scores"] >= 1,
                f"beta server skipped kernel #2: {launches[-1]}")
        require(beta.index.index_type.value == "bag_of_token",
                "the beta server's index is not bag-of-token")
        del beta

        # -- 4. phase 9's alpha index served in memory -----------------------
        retriever.index = alpha_index
        launches.append(load_test(
            torch, f"alpha server ({alpha_index.ell.shape[0]} rows)",
            serve(retriever, host="127.0.0.1", port=0), reqs, False,
            SERVED_RTOL))
        require(launches[-1]["bucketed"] >= 1,
                f"alpha server skipped kernel #3: {launches[-1]}")
        retriever.index = None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches)


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


# -- phase 11 -----------------------------------------------------------------
def host_rss_gib() -> tuple:
    """(resident set now from /proc/self/status, nan where the kernel does
    not say; the process's peak so far from getrusage) in GiB."""
    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 2**20
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def synth_dense_rows(torch, out, start: int, norms, seed: int,
                     chunk: int = 1 << 20) -> None:
    """Fill ``out[start:]`` ([N, D] bf16 on the card) with random
    directions, each row scaled to a norm drawn from ``norms`` (the real
    rows' norms), a chunk of rows at a time."""
    gen = torch.Generator(device=out.device)
    gen.manual_seed(seed)
    norms = norms.to(out.device, torch.float32)
    for s in range(start, out.shape[0], chunk):
        m = min(chunk, out.shape[0] - s)
        x = torch.randn((m, out.shape[1]), generator=gen, device=out.device)
        pick = torch.randint(0, len(norms), (m,), generator=gen,
                             device=out.device)
        x *= (norms[pick] / torch.linalg.vector_norm(x, dim=1))[:, None]
        out[s:s + m] = x.to(out.dtype)


def dense_reference(torch, qb, vectors, k: int, rows: int = 1 << 18):
    """float64 top-(k+1) of ``qb`` (bf16 queries) against ``vectors``,
    computed chunk by chunk on the card: (ids, scores) numpy."""
    q64 = qb.double()
    best_s = best_i = None
    for s in range(0, vectors.shape[0], rows):
        sc = q64 @ vectors[s:s + rows].double().T
        v, i = torch.topk(sc, min(k + 1, sc.shape[1]), dim=1)
        i = i + s
        if best_s is not None:
            v, i = torch.cat([best_s, v], 1), torch.cat([best_i, i], 1)
            v, pos = torch.topk(v, k + 1, dim=1)
            i = torch.gather(i, 1, pos)
        best_s, best_i = v, i
    return best_i.cpu().numpy(), best_s.cpu().numpy()


def dense_agrees(ids, scores, ref_ids, ref_scores, rtol: float = 1e-5,
                 tie: float = 1e-6):
    """Per query: the top-k scores within ``rtol`` of the float64 ones at
    the same ranks, and every id equal to the reference's except where
    the reference's gap to a neighbouring score is at most ``tie`` of the
    top score."""
    out = []
    k = ids.shape[1]
    for q in range(ids.shape[0]):
        rs = ref_scores[q]
        top = max(abs(rs[0]), 1e-30)
        ok = bool(np.allclose(scores[q], rs[:k], rtol=rtol, atol=rtol * top))
        for j in np.nonzero(ids[q] != ref_ids[q, :k])[0]:
            gaps = [abs(rs[j] - rs[j + d]) for d in (-1, 1)
                    if 0 <= j + d < len(rs)]
            ok = ok and min(gaps) <= tie * top
        out.append(ok)
    return out


def make_qa(rng, texts, n: int):
    """``n`` queries of 4-8 words drawn from random passages, their source
    passage ids, and for each an answer: one word of its source passage
    (``has_answer`` then finds it at least there)."""
    queries, src = make_queries(rng, texts, n, sources=True)
    answers = [[str(rng.choice(texts[int(i)].split()))] for i in src]
    return queries, src, answers


def phase_dpr(torch, dev, args, tok, texts, work: str) -> dict:
    """Phase 11 (f): DPR at BERT-base width over a wiki21m-size dense
    index. Returns the checkpoint, the corpus file, the questions with
    their sources and answers, and the search CLI's result file."""
    from vsearch_tpu_torch.cli.build_index import dense_index
    from vsearch_tpu_torch.cli.search import search_dense_index
    from vsearch_tpu_torch.index import DenseIndex
    from vsearch_tpu_torch.ops import search as dense_ops
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig

    rng = np.random.default_rng(args.seed + 11)
    n, n_real = args.dpr_rows, len(texts)
    enc = {"type": "dpr", "model_id": "synthetic", "vocab_size": 30522,
           "hidden_size": DPR_DIM, "num_hidden_layers": LAYERS,
           "num_attention_heads": 12, "intermediate_size": 3072,
           "dtype": "bfloat16"}
    dpr = Retriever(RetrieverConfig(encoder_q=dict(enc, max_len=128),
                                    encoder_p=dict(enc, max_len=256),
                                    shared_encoder=False),
                    tokenizer=tok, seed=args.seed + 5, device=dev)
    ckpt = f"{work}/dpr_ckpt"
    dpr.save_pretrained(ckpt)
    corpus, qfile = f"{work}/corpus.jsonl", f"{work}/questions.jsonl"
    with open(corpus, "w") as f:
        f.writelines(json.dumps({"text": t}) + "\n" for t in texts)
    questions, sources, answers = make_qa(rng, texts, B * args.batches)
    with open(qfile, "w") as f:
        f.writelines(json.dumps({"question": q}) + "\n" for q in questions)
    dv = ["--device", str(dev)]
    t0 = time.perf_counter()
    dense_index.main(["--checkpoint", ckpt, "--text_file", corpus,
                      "--save_file", f"{work}/dpr.npy", *dv])
    t1 = time.perf_counter()
    log(f"phase 11 (f) DPR, BERT-base width ({LAYERS} layers, hidden "
        f"{DPR_DIM}, bf16 compute; query max_len 128, passage 256): "
        f"cli.build_index.dense_index over {n_real} passages {t1 - t0:.2f} s "
        f"({n_real / (t1 - t0):.1f} passages/s, checkpoint load included)")

    # -- the whole index on the card: the CLI's rows, then synthetic rows --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    real = DenseIndex(index_file=f"{work}/dpr.npy", device=dev).vector
    require(tuple(real.shape) == (n_real, DPR_DIM)
            and real.dtype == torch.bfloat16, f"CLI index {real.shape}")
    full = torch.empty((n, DPR_DIM), dtype=torch.bfloat16, device=dev)
    full[:n_real] = real
    synth_dense_rows(torch, full, n_real,
                     torch.linalg.vector_norm(real.float(), dim=1),
                     args.seed + 12)
    idx = DenseIndex(device=dev)
    idx.set_vectors(full)
    require(idx.vector is full, "set_vectors copied a device tensor")
    del real
    torch.cuda.synchronize()
    log(f"  index {n} x {DPR_DIM} bf16 ({full.numel() * 2 / 1e9:.2f} GB) on "
        f"the card in {time.perf_counter() - t0:.2f} s: rows 0-{n_real - 1} "
        f"from the CLI's file, the rest random directions at the real rows' "
        f"norms; product: {dense_ops.gemm_form(full[:1], full)}; chunk "
        f"{dense_ops.dense_chunk_rows(B, DPR_DIM)} rows")

    # -- 4 batches through Retriever.retrieve --------------------------------
    results, stages = [], []
    for i in range(args.batches):
        results.append(dpr.retrieve(questions[i * B:(i + 1) * B], k=K,
                                    index=idx))
        stages.append(stage_times(dpr))
    for i, st in enumerate(stages):
        log(f"  batch {i}: " + ", ".join(
            f"{k} {t * 1e3:.1f} ms" for k, t in st.items()))
    warm = stages[1:] or stages
    total = sum(sum(st.values()) for st in warm)
    q_emb = dpr.process_query(questions[:B])
    qb = torch.from_numpy(q_emb).to(dev, torch.bfloat16)
    search_ms = time_ms(lambda: dense_ops.dense_topk_search(qb, full, K), 3)
    bound_ms = full.numel() * 2 / H100_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"  {B * len(warm) / total:.2f} queries/s over the {len(warm)} "
        f"batches after the first (k={K}); one search {search_ms:.2f} ms "
        f"(CUDA events), {search_ms / bound_ms:.2f}x its {bound_ms:.2f} ms "
        f"byte bound ({full.numel() * 2 / 1e9:.2f} GB read once at 3.35 "
        f"TB/s); card peak {peak / 2**30:.2f} GiB of {card / 2**30:.2f} GiB; "
        "host RSS {:.2f} GiB (process peak {:.2f} GiB, since the start)"
        .format(*host_rss_gib()))
    require(peak < card, "the dense search overflowed the card")
    profile_by_kernel(torch, "dense search",
                      lambda: dense_ops.dense_topk_search(qb, full, K),
                      {"GEMM": r"gemm|sm90|cutlass|xmma", "sort": r"sort"})
    for res in results:
        require(res.ids.shape == (B, K) and np.isfinite(res.scores).all()
                and (np.diff(res.scores, axis=1) <= 0).all()
                and res.ids.min() >= 0 and res.ids.max() < n,
                "dense results malformed")

    # -- 2 batches against a float64 reference, with a control ---------------
    passed, control = [], []
    t0 = time.perf_counter()
    for i in range(min(2, args.batches)):
        qi = torch.from_numpy(dpr.process_query(
            questions[i * B:(i + 1) * B])).to(dev, torch.bfloat16)
        ref_ids, ref_s = dense_reference(torch, qi, full, K)
        res = results[i]
        passed += dense_agrees(res.ids, res.scores, ref_ids, ref_s)
        control += dense_agrees(np.roll(res.ids, -1, axis=0),
                                np.roll(res.scores, -1, axis=0),
                                ref_ids, ref_s)
        gap = np.abs(res.scores - ref_s[:, :K]) / np.abs(ref_s[:, :1])
        n_diff = int((res.ids != ref_ids[:, :K]).sum())
        log(f"  batch {i} vs float64: largest score gap {gap.max():.3g} of "
            f"the top score, {n_diff} of {B * K} ids differ; real rows in "
            f"the top {K}: {int((res.ids < n_real).sum())} of {B * K}")
    log(f"  float64 reference (chunk by chunk on the card) in "
        f"{time.perf_counter() - t0:.1f} s: {sum(passed)} of {len(passed)} "
        f"queries agree (scores rtol 1e-5, ids except ties within 1e-6 of "
        f"the top score); control (the next query's answer): "
        f"{sum(control)} of {len(control)} pass")
    require(all(passed), "dense search disagrees with the float64 reference")
    require(not any(control), "the control passed")
    del idx, full, qb
    gc.collect()
    torch.cuda.empty_cache()

    # -- the search CLI on the CLI-built file, against in-process ------------
    t0 = time.perf_counter()
    search_dense_index.main(["--checkpoint", ckpt, "--query_file", qfile,
                             "--index_file", f"{work}/dpr.npy", "--save_file",
                             f"{work}/dpr.json", "--topk", str(K), *dv])
    cli_s = time.perf_counter() - t0
    with open(f"{work}/dpr.json") as f:
        res = json.load(f)
    dpr.load_index(f"{work}/dpr.npy", index_type="dense")
    want = [dpr.retrieve(questions[s:s + B], k=K)
            for s in range(0, len(questions), B)]
    ids = np.asarray([r["ids"] for r in res])
    scores = np.asarray([r["scores"] for r in res], np.float32)
    require(np.array_equal(ids, np.concatenate([w.ids for w in want]))
            and np.array_equal(scores, np.concatenate([w.scores
                                                       for w in want])),
            "dense search CLI != in-process retrieve")
    log(f"  cli.search.search_dense_index over the {n_real}-row file, "
        f"{len(questions)} questions: {cli_s:.2f} s (checkpoint load "
        "included); result file == in-process retrieve (bit-identical)")
    return dict(ckpt=ckpt, corpus=corpus, result=f"{work}/dpr.json",
                questions=questions, sources=sources, answers=answers)


class SyntheticImages:
    """``n`` [224, 224, 3] f32 images made on the card from ``seed`` when
    sliced: image i always has the same pixels, whatever the slice (a
    sequence, as an image corpus)."""

    def __init__(self, torch, n: int, seed: int, dev, res: int = 224):
        self.torch, self.n, self.seed, self.dev = torch, n, seed, dev
        self.res = res

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, sl):
        torch = self.torch
        a, b, _ = sl.indices(self.n)
        out = torch.empty((b - a, self.res, self.res, 3), device=self.dev)
        gen = torch.Generator(device=self.dev)
        for i in range(a, b):
            gen.manual_seed(self.seed * 1_000_003 + i)
            out[i - a] = torch.randn((self.res, self.res, 3), generator=gen,
                                     device=self.dev)
        return out


def phase_crossmodal(torch, bp, dev, args, tok, words, ptx, work: str
                     ) -> dict:
    """Phase 11 (g): cross-modal retrieval at full width. Returns the
    launch counts of the bitproxy path and the kernels' extra fields."""
    from vsearch_tpu_torch.ops import cuda_build
    from PIL import Image

    from vsearch_tpu_torch.index import SparseIndex
    from vsearch_tpu_torch.models.crossmodal_image import preprocess_image
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig

    rng = np.random.default_rng(args.seed + 13)
    n = args.images
    text = {"type": "vdr_crossmodal_text", "model_id": "synthetic",
            "max_len": 128, "topk": 768, "vocab_size": 30522,
            "hidden_size": 768, "num_hidden_layers": LAYERS,
            "num_attention_heads": 12, "intermediate_size": 3072,
            "dtype": "bfloat16"}
    image = {"type": "vdr_crossmodal_image", "resolution": 224,
             "patch_size": 32, "width": 768, "layers": LAYERS, "heads": 12,
             "topk": 768}
    t0 = time.perf_counter()
    xm = Retriever(RetrieverConfig(encoder_q=text, encoder_p=image,
                                   shared_encoder=False),
                   tokenizer=tok, seed=args.seed + 7, device=dev)
    v = xm.encoder_p.config.out_dim
    require(v == xm.encoder_q.config.out_dim == 27623,
            f"valid vocabulary {v}")
    torch.cuda.synchronize()
    log(f"phase 11 (g) cross-modal: BERT-base text encoder (bf16, 27,623 "
        f"valid ids, topk 768) -> ViT-B/32 image encoder (224 px, patch 32, "
        f"width 768, {LAYERS} layers, f32, topk 768), built in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- 4 images through PNG files and preprocess_image ---------------------
    paths = []
    for i, (h, w) in enumerate([(300, 260), (224, 224), (180, 400),
                                (512, 333)]):
        paths.append(f"{work}/image{i}.png")
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3),
                                     dtype=np.uint8)).save(paths[-1])
    e_png = xm.encoder_p.embed(paths)
    e_arr = xm.encoder_p.embed(np.stack([preprocess_image(p, 224)
                                         for p in paths]))
    require(e_png.shape == (4, v) and np.array_equal(e_png, e_arr)
            and ((e_png != 0).sum(axis=1) == 768).all(),
            "PNG images embed differently from their pixels")

    # -- the image index: build_index('sparse') from dense embeddings --------
    n_rate = min(2048, n)
    t0 = time.perf_counter()
    xm.encoder_p.embed(SyntheticImages(torch, n_rate, args.seed + 1, dev),
                       batch_size=B)
    torch.cuda.synchronize()
    img_s = n_rate / (time.perf_counter() - t0)
    images = SyntheticImages(torch, n, args.seed, dev)
    t0 = time.perf_counter()
    idx = xm.build_index(images, batch_size=B, index_type="sparse")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ell = idx.ell
    nnz = ell.nnz.cpu().numpy()
    log(f"  4 PNG images == their preprocessed pixels (bit-identical); "
        f"images embedded at {img_s:.1f} images/s ({n_rate} images, B={B}, "
        f"f32); build_index('sparse') over {n} images {build_s:.2f} s; ELL "
        f"{tuple(ell.cols.shape)}, ids a row {nnz.min()}-{nnz.max()}, "
        f"vals {ell.vals.dtype}; auto -> "
        f"{'bitproxy' if idx._use_bitproxy() else 'exact'}")
    require(type(idx) is SparseIndex and (nnz == 768).all()
            and ell.nnz_pad == 768 and not idx._use_bitproxy(),
            "image index is not exact rows of 768 ids")

    # -- text -> image, exact ('auto' below exact_threshold) -----------------
    captions = make_corpus(rng, words, n, mean_len=10, spread=5)
    picks = rng.integers(0, n, size=B * args.batches)
    queries = [captions[int(i)] for i in picks]
    exact, stages = [], []
    for i in range(args.batches):
        exact.append(xm.retrieve(queries[i * B:(i + 1) * B], k=K))
        stages.append(stage_times(xm))
    total = sum(sum(st.values()) for st in stages)
    log(f"  text -> image ({n} images, exact): {B * args.batches / total:.2f}"
        " queries/s; " + "; ".join(
            f"batch {i} " + ", ".join(f"{k} {t * 1e3:.1f} ms"
                                      for k, t in st.items())
            for i, st in enumerate(stages)))
    q_emb = xm.process_query(queries[:B])
    cols_h, vals_h = ell.cols.cpu().numpy(), ell.vals.float().cpu().numpy()
    for qi in range(5):
        j = int(exact[0].ids[qi, 0])
        want = float(np.dot(q_emb[qi, cols_h[j]].astype(np.float64),
                            vals_h[j]))
        require(np.isclose(exact[0].scores[qi, 0], want, rtol=1e-5),
                f"text -> image score {exact[0].scores[qi, 0]} != {want}")
    for res in exact:
        require(res.ids.shape == (B, min(K, n))
                and np.isfinite(res.scores).all()
                and (np.diff(res.scores, axis=1) <= 0).all(),
                "text -> image results malformed")

    # -- image -> text over an index of the captions -------------------------
    t0 = time.perf_counter()
    cap_emb = xm.encoder_q.embed(captions, batch_size=128)
    torch.cuda.synchronize()
    cap_s = n / (time.perf_counter() - t0)
    cidx = SparseIndex(device=dev)
    cidx.set_ell(ELLMatrix.from_dense(cap_emb, val_dtype=np.float32,
                                      device=dev))
    del cap_emb
    img_q = xm.encoder_p.embed(images[0:B * args.batches], batch_size=B)
    t0 = time.perf_counter()
    back = [xm.retrieve(img_q[i * B:(i + 1) * B], k=K, index=cidx)
            for i in range(args.batches)]
    i2t_s = time.perf_counter() - t0
    for i, res in enumerate(back):
        require(res.ids.shape == (B, min(K, n))
                and np.isfinite(res.scores).all(),
                "image -> text results malformed")
    log(f"  image -> text over {n} captions (ELL {tuple(cidx.ell.cols.shape)}"
        f"): captions embedded at {cap_s:.1f} captions/s; "
        f"{args.batches} batches of {B} image queries searched in "
        f"{i2t_s * 1e3:.1f} ms ({B * args.batches / i2t_s:.1f} queries/s)")
    del cidx, back, img_q
    gc.collect()

    # -- the same image index through the binary-support proxy ---------------
    idx.search_mode = "bitproxy"
    cand = idx.rerank_budget // ell.nnz_pad
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    proxy, stages = [], []
    for i in range(args.batches):
        proxy.append(xm.retrieve(queries[i * B:(i + 1) * B], k=K))
        stages.append(stage_times(xm))
    launches = dict(cuda_build.LAUNCHES)
    # rows of 768 ids: kernel #3 runs in the plane form
    require(idx.bitproxy.form == "plane" and launches["pack"] == 1
            and launches["bucketed_plane"] >= args.batches
            and launches["bucketed"] == 0,
            f"cross-modal bitproxy skipped kernels: {launches}")
    recall = float(np.mean([np.mean(p.scores >= e.scores[:, -1:]
                                    - 1e-3 * np.abs(e.scores[:, -1:]))
                            for p, e in zip(proxy, exact)]))
    log(f"  bitproxy over the image index: C = {idx.rerank_budget} // "
        f"{ell.nnz_pad} = {cand} candidates a query; recall vs exact "
        f"{recall:.4f} (not gated); " + "; ".join(
            f"batch {i} " + ", ".join(f"{k} {t * 1e3:.1f} ms"
                                      for k, t in st.items())
            for i, st in enumerate(stages)) + f"; launches {launches}")
    words_bits = idx.bitproxy.words
    require(torch.equal(words_bits, bp.pack_bits_plain(
        ell.cols, ell.nnz, ell.num_cols)),
        "pack kernel != plain at V=27,623")
    pack_ms = time_ms(lambda: bp.pack_bits(ell.cols, ell.nnz, v), 10)
    pack_plain = time_ms(lambda: bp.pack_bits_plain(ell.cols, ell.nnz, v), 2)
    pack_bytes = (ell.cols.numel() * 4 + ell.nnz.numel() * 4
                  + words_bits.numel() * 4)
    pack_bound = pack_bytes / H100_BYTES_PER_S * 1e3
    log(f"  kernel #1 at {n} x 768 ids, V={v} ({words_bits.shape[1]} words a "
        f"row): bit-identical to plain; {pack_ms:.3f} ms (plain "
        f"{pack_plain:.3f} ms, bound {pack_bound:.3f} ms)")
    q = torch.from_numpy(q_emb).to(dev)
    qT = bp.prepare_queries(q, idx.bitproxy)
    dyT = dyadic_operand(torch, rng, dev, words_bits.shape[1] * 32, v)
    lab = f"{n} image rows of 768 ids, V={v}"
    k3 = keys_at(torch, bp, ptx, lab, words_bits, qT, dyT, n, n * 768, v)
    k3p = keys_at(torch, bp, ptx, lab, words_bits, qT, dyT, n, n * 768, v,
                  form="plane", plain_ms=k3["plain_ms"])
    return dict(launches=launches, fields={
        "pack_ell": dict(crossmodal_ms=pack_ms, crossmodal_plain_ms=pack_plain,
                         crossmodal_bound_ms=pack_bound),
        "bucketed_keys": {f"crossmodal_{k}": x for k, x in k3.items()},
        "bucketed_keys_plane": {**{f"crossmodal_{k}": x
                                   for k, x in k3p.items()},
                                "crossmodal_recall_c256": recall}})


def run_cli(main, argv) -> dict:
    """A scoring CLI's ``main(argv)``; returns the JSON it printed last."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_scoring(torch, dev, args, retriever, texts, dpr: dict, work: str
                  ) -> None:
    """Phase 11 (h): ``eval_wiki21m`` on (f)'s result file; ``eval_beir``
    on a BEIR folder over the same passages, with the phase-4 VDR and the
    DPR checkpoints."""
    import os

    from vsearch_tpu_torch.cli.score import eval_beir, eval_wiki21m
    from vsearch_tpu_torch.eval import qa_utils

    qa = f"{work}/qa.csv"
    with open(qa, "w") as f:
        f.writelines(f"{q}\t{a!r}\n"
                     for q, a in zip(dpr["questions"], dpr["answers"]))
    t0 = time.perf_counter()
    acc = run_cli(eval_wiki21m.main, ["--result_file", dpr["result"],
                                      "--text_file", dpr["corpus"],
                                      "--qa_file", qa])
    log(f"phase 11 (h) scoring CLIs: has_answer through the "
        f"{'regex' if qa_utils._regex is not None else 're fallback'} "
        f"branch; eval_wiki21m on (f)'s result file "
        f"({time.perf_counter() - t0:.2f} s): {json.dumps(acc)}")
    vals = list(acc.values())
    require(list(acc) == ["top1", "top5", "top10", "top20", "top100"]
            and all(a <= b for a, b in zip(vals, vals[1:])),
            "top-k accuracies are not non-decreasing in k")
    beir = f"{work}/beir"
    os.makedirs(f"{beir}/qrels", exist_ok=True)
    with open(f"{beir}/corpus.jsonl", "w") as f:
        f.writelines(json.dumps({"_id": str(i), "title": "", "text": t})
                     + "\n" for i, t in enumerate(texts))
    with open(f"{beir}/queries.jsonl", "w") as f:
        f.writelines(json.dumps({"_id": f"q{i}", "text": q}) + "\n"
                     for i, q in enumerate(dpr["questions"]))
    with open(f"{beir}/qrels/test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.writelines(f"q{i}\t{int(s)}\t1\n"
                     for i, s in enumerate(dpr["sources"]))
    vdr_ckpt = f"{work}/vdr_ckpt"
    retriever.save_pretrained(vdr_ckpt)
    for name, ckpt in (("VDR (phase 4)", vdr_ckpt), ("DPR (f)", dpr["ckpt"])):
        t0 = time.perf_counter()
        m = run_cli(eval_beir.main, [
            "--checkpoint", ckpt, "--corpus_file", f"{beir}/corpus.jsonl",
            "--query_file", f"{beir}/queries.jsonl", "--qrels_file",
            f"{beir}/qrels/test.tsv", "--device", str(dev)])
        log(f"  eval_beir, {name}, {len(texts)} passages, "
            f"{len(dpr['questions'])} queries ({time.perf_counter() - t0:.2f}"
            f" s): {json.dumps(m)}")
        require(all(0.0 <= x <= 1.0 for x in m.values())
                and m["recall@100"] >= m["recall@1"],
                f"eval_beir metrics malformed for {name}")


def phase_eleven(torch, bp, dev, args, retriever, tok, words, texts,
                 ptx) -> dict:
    """Phase 11: (f) DPR at wiki21m size, (g) cross-modal retrieval at
    full width, (h) the scoring CLIs. Returns the launch counts of (g)'s
    bitproxy path and the kernels' extra fields."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_11_")
    try:
        t0 = time.perf_counter()
        dpr = phase_dpr(torch, dev, args, tok, texts, work)
        log(f"  (f) took {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = phase_crossmodal(torch, bp, dev, args, tok, words, ptx, work)
        log(f"  (g) took {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_scoring(torch, dev, args, retriever, texts, dpr, work)
        log(f"  (h) took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out



# -- phase 12 -----------------------------------------------------------------


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def train_flops(bert: dict, b: int, lq: int, lp: int, negs: int = 1,
                v_out: int = 29_523, vdr: bool = True) -> float:
    """One step's FLOPs (forward and backward, 3x the forward) of a q and a
    p encoder: 6 x non-embedding parameters x tokens, the tied vocabulary
    projection of each token (VDR) and attention's two L x L products."""
    h, f, nl = (bert["hidden_size"], bert["intermediate_size"],
                bert["num_hidden_layers"])
    layer = 4 * h * h + 2 * h * f + 9 * h + f
    m = b * (1 + negs)
    tokens = b * lq + m * lp
    flops = 6 * nl * layer * tokens
    if vdr:
        flops += 3 * 2 * h * v_out * tokens
    flops += 3 * nl * 4 * h * (b * lq * lq + m * lp * lp)
    return float(flops)


def make_train_samples(rng, texts, words, n: int, path: str) -> None:
    """``n`` samples in the training JSONL schema: the positive is a random
    passage of the corpus, the question 4-8 of its words, the answer the
    question's rarest word (the highest Zipf rank), one hard negative
    another random passage."""
    rank = {w: i for i, w in enumerate(words)}
    src = rng.integers(0, len(texts), size=(n, 2))
    with open(path, "w") as f:
        for pos, neg in src.tolist():
            ws = texts[pos].split()
            pick = rng.choice(len(ws), size=int(rng.integers(4, 9)),
                              replace=False)
            q = [ws[j] for j in sorted(pick)]
            f.write(json.dumps({
                "question": " ".join(q),
                "answers": [max(q, key=rank.__getitem__)],
                "positive_ctxs": [{"text": texts[pos]}],
                "negative_ctxs": [],
                "hard_negative_ctxs": [{"text": texts[neg]}]}) + "\n")


@contextlib.contextmanager
def recorded_steps(torch, dev, out: list, before=None, sums=None):
    """Every ``RetrieverTrainer`` made inside records, for each step, its
    host milliseconds (synchronised before and after), loss and unclipped
    global norm into ``out`` (as ``(ms, loss, grad_norm)``), and into
    ``sums`` the f64 sums of its clipped gradients and updated weights;
    ``before(i)`` runs ahead of the i-th step it records."""
    from vsearch_tpu_torch.train import trainer as tr

    orig = tr.RetrieverTrainer._init_state

    def init(self, updates_per_epoch):
        orig(self, updates_per_epoch)
        step = self._step_fn

        def timed(state, batch, seed):
            if before is not None:
                before(len(out))
            sync(torch, dev)
            t0 = time.perf_counter()
            state, metrics = step(state, batch, seed)
            sync(torch, dev)
            out.append(((time.perf_counter() - t0) * 1e3,
                        float(metrics["loss"]), float(metrics["grad_norm"])))
            if sums is not None:
                ps = state.tx.params
                with torch.no_grad():
                    sums.append(tuple(float(torch.stack(
                        [t.double().sum() for t in ts]).sum())
                        for ts in ([p.grad for p in ps], ps)))
            return state, metrics

        self._step_fn = timed

    tr.RetrieverTrainer._init_state = init
    try:
        yield out
    finally:
        tr.RetrieverTrainer._init_state = orig


def train_cli(conf: str, ckpt: str, out_dir: str, data: str, dev, extra
              ) -> list:
    """``cli.train`` on ``conf/train_ir_cfg.yaml`` with ``data`` as the one
    training set, the checkpoint ``ckpt`` and ``extra`` overrides."""
    from vsearch_tpu_torch.cli import train as cli_train

    return cli_train.main([
        "--config", conf, "--device", str(dev),
        f"data_stores.smoke.file={data}", "train_datasets=[smoke]",
        f"model_path={ckpt}", f"output_dir={out_dir}",
        "train.num_train_epochs=1", "train.log_batch_step=1000000",
        "train.train_rolling_loss_step=1000000", *extra])


def peak_gib(torch, dev) -> str:
    if dev.type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def check_train_tiny(torch, dev, tok, texts) -> None:
    """(a) A 2-layer f32 VDR trains 3 steps on the card and on the CPU from
    equal weights and batches, dropout 0: the losses and unclipped global
    norms agree (TF32 off)."""
    from vsearch_tpu_torch.data import BiEncoderPassage, BiEncoderSample
    from vsearch_tpu_torch.data.batching import create_biencoder_batch
    from vsearch_tpu_torch.models.vdr import VDREncoder, VDREncoderConfig
    from vsearch_tpu_torch.train import optim, step
    from vsearch_tpu_torch.train.loss import VDRLossConfig

    cfg = VDREncoderConfig.from_dict({
        "vocab_size": 30522, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "max_len": 64,
        "shift_vocab_num": 999, "topk": 768, "hidden_dropout_prob": 0.0,
        "attention_probs_dropout_prob": 0.0})
    samples = [BiEncoderSample(
        query=" ".join(texts[i].split()[:6]), answers=[],
        positive_passages=[BiEncoderPassage(" ".join(texts[i].split()[:50]))],
        negative_passages=[],
        hard_negative_passages=[BiEncoderPassage(
            " ".join(texts[i + 8].split()[:50]))]) for i in range(8)]
    b = create_biencoder_batch(tok, tok, samples, q_max_len=32,
                               p_max_len=64, num_hard_negatives=1)
    runs = []
    for where in ("cpu", dev):
        mods = {s: VDREncoder(cfg, tokenizer=tok, seed=seed, device="cpu")
                .module.to(where) for s, seed in (("q", 5), ("p", 6))}
        module = torch.nn.ModuleDict(mods)
        fn = step.make_train_step(
            *[step.make_encoder_apply(mods[s]) for s in "qp"],
            step.TrainStepConfig(vocab_size=30522, shift_vocab_num=999,
                                 loss=VDRLossConfig(topk=768)))
        state = step.TrainState.create(module, optim.get_optimizer(
            [module], schedule=optim.get_schedule_warmup(1, 1e-3)))
        batch = step.TrainBatch(
            torch.from_numpy(b.q_tensor).long().to(where),
            torch.from_numpy(b.p_tensor).long().to(where))
        got = []
        for i in range(3):
            state, m = fn(state, batch, i)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(np.array(got))
    gaps = (np.abs(runs[1] - runs[0]) / np.abs(runs[0])).max(axis=1)
    log(f"  (a) tiny f32 VDR, 3 steps: CPU (loss, grad_norm) "
        f"{runs[0].tolist()}, card {runs[1].tolist()}; relative gaps "
        f"{gaps.tolist()}")
    # steps 1-2 run equal weights (the warmup's first lr is 0): f32
    # summation order only, on logits that sum 29,523 products; step 3
    # follows Adam's ~lr x sign(g) update, which turns rounding in
    # near-zero gradients into lr-sized weight differences
    require(gaps[:2].max() <= 1e-4 and gaps[2] <= 1e-3,
            f"tiny training differs between CPU and card by {gaps}")


def mining_check(torch, dev, retriever, records: list):
    """Wrap ``retriever.retrieve_negatives``: time each call (synchronised)
    and hold its negatives to the gate: none contains its sample's answer
    unless that sample's pool was padded (fewer answer-free hits in the
    top ``ret_topk`` than negatives asked for)."""
    from vsearch_tpu_torch.eval.qa_utils import has_answer

    orig = retriever.retrieve_negatives

    def checked(q_emb, answers, ret_neg_num=1, ret_topk=100, pool_size=20,
                ret_dropout=0.0, index=None, seed=None):
        sync(torch, dev)
        t0 = time.perf_counter()
        negs = orig(q_emb, answers=answers, ret_neg_num=ret_neg_num,
                    ret_topk=ret_topk, pool_size=pool_size,
                    ret_dropout=ret_dropout, index=index, seed=seed)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        first_ms = retriever.last_timings["first_stage"] * 1e3
        bad = [i for i, (ans, ns) in enumerate(zip(answers, negs))
               if any(has_answer(ans, t, "string") for t in ns)]
        padded = 0
        if bad:
            idx = index if index is not None else retriever.index
            hits = retriever.retrieve(
                q_emb, a=768, k=ret_topk, dropout=ret_dropout, index=idx,
                rng=np.random.default_rng(seed) if seed is not None
                else None).ids
            for i in bad:
                clean = [j for j in hits[i] if not has_answer(
                    answers[i], str(idx.get_sample(int(j))), "string")]
                require(len(clean) < ret_neg_num,
                        f"mined negative of sample {i} holds its answer "
                        f"{answers[i]} though the pool had {len(clean)}")
                padded += 1
        records.append((ms, first_ms, padded))
        return negs

    retriever.retrieve_negatives = checked


def determinism_probe(torch, module, fn, batch) -> None:
    """Two train steps at lr 0 on the same weights, batch and seed: are
    the gradients equal bit for bit, and which ops does PyTorch flag as
    nondeterministic (``use_deterministic_algorithms(warn_only=True)``)?"""
    import warnings

    from vsearch_tpu_torch.train import optim, step

    state = step.TrainState.create(module, optim.get_optimizer(
        [module], learning_rate=0.0, max_grad_norm=None))
    grads = []
    flagged = set()
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                state, _ = fn(state, batch, 300)
            finally:
                torch.use_deterministic_algorithms(False)
        flagged |= {str(w.message).split(" does not have a deterministic")[0]
                    for w in caught if "deterministic" in str(w.message)}
        grads.append([p.grad.clone() for p in state.tx.params])
    differ = [i for i, (a, b) in enumerate(zip(*grads))
              if not torch.equal(a, b)]
    worst = max((float(((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30))) for a, b in zip(*grads)), default=0.0)
    log(f"  determinism: 2 backward passes on equal inputs give equal "
        f"gradients in {len(grads[0]) - len(differ)} of {len(grads[0])} "
        f"tensors (largest relative gap {worst:.2e}); ops PyTorch flags as "
        f"nondeterministic: {sorted(flagged) or 'none'}")
    state.tx.zero_grad()


def phase_train(torch, dev, args, retriever, tok, words, texts,
                bot_ell) -> dict:
    """Phase 12: (a) tiny CPU <-> card training parity; (b) svdr_nq at
    BERT-base width through ``cli.train`` with a mid-epoch save, the
    learning gate and peak memory with and without remat; (c) one step
    profiled by kernel; (d) retrieved negatives mined over the phase-4
    bag-of-token index; (e) resume from (b)'s mid-epoch train state; (f)
    DPR steps of dpr_nq. Returns the launch counts of (d)'s mining path."""
    from vsearch_tpu_torch.ops import cuda_build
    import shutil
    import tempfile

    from vsearch_tpu_torch.data import BiEncoderDataset
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.models.encoder_base import set_remat
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.train import optim, step
    from vsearch_tpu_torch.train.trainer import RetrieverTrainer

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                        "train_ir_cfg.yaml")
    work = tempfile.mkdtemp(prefix="chip_smoke_12_")
    try:
        t0 = time.perf_counter()
        check_train_tiny(torch, dev, tok, texts)
        log(f"  (a) took {time.perf_counter() - t0:.1f} s")

        # -- (b) svdr_nq through cli.train -----------------------------------
        t0 = time.perf_counter()
        rng = np.random.default_rng(args.seed + 12)
        data = os.path.join(work, "train.jsonl")
        make_train_samples(rng, texts, words, args.train_samples, data)
        ckpt = os.path.join(work, "vdr_init")
        retriever.save_pretrained(ckpt)  # random weights from --seed
        # the file's epoch is cut to --train-steps by the sampling rate
        file_steps = args.train_samples // TRAIN_B
        steps_per_epoch = args.train_steps
        save_at = steps_per_epoch - 4
        cut = [f"train.train_sampling_rates=[{steps_per_epoch / file_steps}]"]
        q_cfg = retriever.encoder_q.config
        flops = train_flops(BERT_BASE, TRAIN_B, TRAIN_LQ, TRAIN_LP,
                            v_out=q_cfg.out_dim)
        log(f"phase 12 (b) svdr_nq through cli.train: BERT-base VDR q+p "
            f"({BERT_BASE['num_hidden_layers']} layers, hidden "
            f"{BERT_BASE['hidden_size']}, V'={q_cfg.out_dim}, topk "
            f"{q_cfg.topk}), bf16 "
            f"compute on f32 weights, B={TRAIN_B} + 1 hard negative, q "
            f"{TRAIN_LQ} / p {TRAIN_LP} tokens; {args.train_samples} "
            f"samples, an epoch cut to {steps_per_epoch} of their "
            f"{file_steps} batches, mid-epoch save at step "
            f"{save_at}; set-up {time.perf_counter() - t0:.1f} s")
        steps, sums_b = [], []
        b_dir, mid_dir = os.path.join(work, "b"), os.path.join(work, "b_mid")

        def keep_mid_epoch_state(i):
            if i == save_at:  # the save after step save_at is on disk
                shutil.copytree(os.path.join(b_dir, "train_state"), mid_dir)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_steps(torch, dev, steps, keep_mid_epoch_state,
                            sums_b):
            trainer = train_cli(conf, ckpt, b_dir, data, dev,
                                [f"train.save_steps={save_at}", *cut])
        wall_b = time.perf_counter() - t0
        require(trainer.state.step == steps_per_epoch == len(steps),
                f"(b) took {len(steps)} steps")
        ms = np.array([m for m, _, _ in steps])
        losses = [x for _, x, _ in steps]
        require(np.isfinite(losses).all(), f"(b) losses {losses}")
        med = float(np.median(ms[1:]))
        padded = TRAIN_B * TRAIN_LQ + 2 * TRAIN_B * TRAIN_LP
        log(f"  step ms (synchronised): first {ms[0]:.1f}, median of the "
            f"other {len(ms) - 1} {med:.2f} (min {ms[1:].min():.2f}, max "
            f"{ms[1:].max():.2f}); {TRAIN_B / med * 1e3:.1f} samples/s, "
            f"{padded / med * 1e3:.0f} tokens/s ({padded} padded tokens a "
            f"step)")
        log(f"  step FLOPs {flops / 1e12:.2f} T: {flops / med / 1e9:.1f} "
            f"TFLOP/s, {flops / med / 1e9 / (H100_BF16_FLOPS / 1e12):.1%} of "
            f"the dense bf16 peak ({flops / H100_BF16_FLOPS * 1e3:.2f} ms "
            f"bound)")
        log(f"  loss first step {losses[0]:.4f}, last {losses[-1]:.4f}; "
            f"cli.train wall {wall_b:.1f} s (with checkpoint saves); card "
            f"peak {peak_gib(torch, dev)}")
        require(os.path.isfile(os.path.join(b_dir, "checkpoint_1",
                                            "pytorch_model.bin"))
                and os.path.isfile(os.path.join(mid_dir, "state.pt")),
                "(b) wrote no epoch-end model checkpoint or mid-epoch "
                "train state")

        # -- learning gate, remat, profile on the trained retriever ----------
        vdr = trainer.retriever
        module, ds = trainer.module, trainer.datasets[0]
        fixed = [trainer._make_device_batch(
            [ds[i] for i in range(k * TRAIN_B, (k + 1) * TRAIN_B)], 9, k)[0]
            for k in range(2)]
        real = sum(int((x != 0).sum()) for b in fixed for x in b)
        log(f"  {real / (2 * padded):.1%} of a step's padded tokens are "
            f"real: {real / 2 / med * 1e3:.0f} real tokens/s")
        tx = optim.get_optimizer([module], schedule=optim.get_schedule_warmup(
            0, 1e-4), max_grad_norm=2.0)
        state = step.TrainState.create(module, tx)
        fn = step.make_train_step(trainer._apply_q, trainer._apply_p,
                                  trainer.step_cfg)
        gate = []
        for i in range(24):
            state, m = fn(state, fixed[i % 2], i)
            gate.append(float(m["loss"]))
        first, last = float(np.mean(gate[:5])), float(np.mean(gate[-5:]))
        log(f"  learning gate: 2 fixed batches x 12 at lr 1e-4: mean loss "
            f"of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
        require(np.isfinite(gate).all() and last < first,
                f"training does not learn: {gate}")
        for remat in (False, True):
            set_remat(module, remat)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            sync(torch, dev)
            t1 = time.perf_counter()
            for i in range(2):
                state, m = fn(state, fixed[0], 100 + i)
            sync(torch, dev)
            ms_remat = (time.perf_counter() - t1) / 2 * 1e3
            log(f"  remat={remat}: card peak over 2 steps "
                f"{peak_gib(torch, dev)}, {ms_remat:.1f} ms a step")
        set_remat(module, False)

        # -- (c) one step by kernel -------------------------------------------
        if dev.type == "cuda":
            profile_by_kernel(
                torch, "train step (b's width)",
                lambda: fn(state, fixed[1], 200),
                {"bf16 GEMMs": r"gemm|nvjet|cutlass|sm90_xmma|ampere",
                 "softmax": r"softmax",
                 "reductions (amax, norms)": r"reduce|amax|norm",
                 "elementwise": r"elementwise|vectorized|unrolled",
                 "AdamW": r"adam|multi_tensor|foreach"})
        del state, tx
        determinism_probe(torch, module, fn, fixed[0])
        del fn, fixed
        gc.collect()

        # -- (d) retrieved negatives over the phase-4 index -------------------
        t0 = time.perf_counter()
        sync(torch, dev)
        cuda_build.reset_launch_counts()
        index = BoTIndex(device=dev)
        index.set_ell(dataclasses.replace(bot_ell,
                                          cols=bot_ell.cols.to(dev),
                                          nnz=bot_ell.nnz.to(dev)))
        index.data = texts
        index.build_bitpack()
        vdr.index, vdr.index_type = index, index.index_type
        mined = []
        mining_check(torch, dev, vdr, mined)
        steps_d = []
        cfg_d = dataclasses.replace(
            trainer.cfg, ret_negatives=1, ret_topk=20,
            negative_pool_size=100, save_steps=0,
            train_sampling_rates=[args.mining_steps / file_steps],
            output_dir=os.path.join(work, "d"))
        with recorded_steps(torch, dev, steps_d):
            RetrieverTrainer(vdr, cfg_d, [BiEncoderDataset(data)]).run_train()
        sync(torch, dev)
        launches = dict(cuda_build.LAUNCHES)
        del vdr.retrieve_negatives
        ms_d = [m for m, _, _ in steps_d]
        log(f"phase 12 (d) retrieved negatives over the phase-4 index "
            f"({len(texts)} rows, 1 negative of the top 20, pool 100): "
            f"{len(steps_d)} steps, losses "
            f"{[round(x, 4) for _, x, _ in steps_d]}; mining ms a batch "
            f"{[round(m, 1) for m, _, _ in mined]} (of which the first stage "
            f"{[round(f, 1) for _, f, _ in mined]}; the query embed runs "
            f"before it) against step ms "
            f"{[round(m, 1) for m in ms_d]} (96 passages a step: (b)'s 64 "
            f"and 32 mined); "
            f"{sum(p for _, _, p in mined)} padded pools; launches "
            f"{launches}; took {time.perf_counter() - t0:.1f} s")
        require(len(steps_d) >= 5 and len(mined) == len(steps_d),
                f"(d) ran {len(steps_d)} steps, {len(mined)} minings")
        require(np.isfinite([x for _, x, _ in steps_d]).all(),
                "(d) non-finite loss")
        require(launches["pack"] >= 1 and launches["bucketed"] >= len(mined),
                f"mining skipped kernels: {launches}")
        vdr.index = None
        del index, trainer, vdr, module, ds
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # -- (e) resume from (b)'s mid-epoch train state ----------------------
        t0 = time.perf_counter()
        with open(os.path.join(mid_dir, "train_meta.json")) as f:
            meta = json.load(f)
        require(meta["offset"] == save_at, f"(b)'s mid-epoch state {meta}")
        runs, sums_e = [], []
        for k in range(2):  # the second resume is a control on the first
            resume_dir = os.path.join(work, f"e{k}")
            shutil.copytree(mid_dir, os.path.join(resume_dir, "train_state"))
            steps_e, sums = [], []
            with recorded_steps(torch, dev, steps_e, sums=sums):
                resumed = train_cli(conf, ckpt, resume_dir, data, dev,
                                    [f"train.save_steps={save_at}",
                                     "resume=true", *cut])
            require(resumed.start_batch == save_at,
                    f"resumed at {resumed.start_batch}")
            runs.append(np.array([(x, g) for _, x, g in steps_e]))
            sums_e.append(sums)
            del resumed
            gc.collect()
        want = np.array([(x, g) for _, x, g in steps[save_at:]])
        gaps = (np.abs(runs[0] - want) / np.abs(want)).tolist()
        gaps_rr = (np.abs(runs[1] - runs[0]) / np.abs(runs[0])).tolist()
        log(f"phase 12 (e) resume at epoch 0, offset {save_at}: (loss, "
            f"grad_norm) {runs[0].tolist()} against the uninterrupted "
            f"run's {want.tolist()}; relative gaps {gaps} (the next step's "
            f"loss held to {RESUME_RTOL}); a second resume against the "
            f"first: gaps {gaps_rr}; took {time.perf_counter() - t0:.1f} s")
        for k, label in ((0, "the next step"), (1, "the step after")):
            log(f"  (e) f64 sums of the clipped gradients and the updated "
                f"weights after {label}: uninterrupted "
                f"{sums_b[save_at + k]}, resumes {sums_e[0][k]}, "
                f"{sums_e[1][k]}")
        require(len(runs[0]) == len(want) and gaps[0][0] <= RESUME_RTOL,
                "resumed run differs")

        # -- (f) DPR ---------------------------------------------------------
        t0 = time.perf_counter()
        enc = dict(BERT_BASE, type="dpr", model_id="synthetic",
                   dtype="bfloat16")
        dpr_ckpt = os.path.join(work, "dpr_init")
        Retriever(RetrieverConfig(encoder_q=dict(enc, max_len=TRAIN_LQ),
                                  encoder_p=dict(enc, max_len=TRAIN_LP)),
                  tokenizer=tok, seed=args.seed, device=dev
                  ).save_pretrained(dpr_ckpt)
        steps_f = []
        with recorded_steps(torch, dev, steps_f):
            train_cli(conf, dpr_ckpt, os.path.join(work, "f"), data, dev,
                      ["biencoder=dpr", "train=dpr_nq",
                       "train.train_sampling_rates="
                       f"[{args.dpr_steps / file_steps}]"])
        loss_f = [x for _, x, _ in steps_f]
        ms_f = np.array([m for m, _, _ in steps_f])
        flops_f = train_flops(BERT_BASE, TRAIN_B, TRAIN_LQ, TRAIN_LP,
                              vdr=False)
        log(f"phase 12 (f) DPR dpr_nq through cli.train: {len(loss_f)} "
            f"steps, losses {[round(x, 4) for x in loss_f]}, step ms "
            f"{[round(float(m), 1) for m in ms_f]} ({flops_f / 1e12:.2f} "
            f"TFLOP a "
            f"step, {flops_f / float(np.median(ms_f[1:])) / 1e9:.1f} "
            f"TFLOP/s after the first); took {time.perf_counter() - t0:.1f} s")
        require(len(loss_f) >= 3 and np.isfinite(loss_f).all(),
                f"DPR training: {loss_f}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- phase 13 -----------------------------------------------------------------
def card_scores(torch, q_rows, ids, cols, nnz, v: int):
    """``host_scores`` on the card, for an ELL that lives there: each
    query's f32 weights summed (in f64) over its rows' ids. q_rows [B, V]
    numpy, ids [B, k] numpy -> [B, k] numpy f32."""
    dev = cols.device
    ids_t = torch.from_numpy(ids).to(dev)
    rows = cols[ids_t].long().clamp(0, v)  # [B, k, nnz_pad]; sentinel -> v
    valid = (torch.arange(cols.shape[1], device=dev)
             < nnz[ids_t][..., None])
    q = torch.from_numpy(q_rows).to(dev, torch.float64)
    qpad = torch.cat([q, torch.zeros((len(q), 1), dtype=q.dtype,
                                     device=dev)], dim=1)
    g = torch.gather(qpad[:, None, :].expand(-1, ids.shape[1], -1), 2, rows)
    return (g * valid).sum(dim=-1).float().cpu().numpy()


def timed_search(torch, fn):
    """(result, host milliseconds) of ``fn()`` with the card synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_mesh(torch, bp, dev, args, retriever, tok, words, texts, queries,
               bot_ell, large, smi: str) -> dict:
    """Phase 13: the port's mesh paths over ``MESH_SHARDS`` virtual shards
    of the card, each against its one-device answer. Returns the launch
    counts of the sharded paths (each zeroed just before the sharded run
    and read just after; the one-device references run outside)."""
    from vsearch_tpu_torch.ops import cuda_build
    import io
    import shutil
    import tempfile
    import threading

    from vsearch_tpu_torch.cli.build_index import binary_token_index
    from vsearch_tpu_torch.cli.serve import make_parser, prepare_retriever
    from vsearch_tpu_torch.index import BoTIndex, DenseIndex
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.parallel.mesh import make_mesh
    from vsearch_tpu_torch.serve import serve

    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    counts = {name: 0 for name in cuda_build.LAUNCHES}

    def sharded(fn):
        """Run ``fn`` with the launch counts zeroed before and added to
        ``counts`` after."""
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            for name, c in cuda_build.LAUNCHES.items():
                counts[name] += c

    t_phase = time.perf_counter()
    log(f"phase 13 (more than one device): {mesh} - {MESH_SHARDS} virtual "
        f"shards of one card ({smi}); no multi-card speed is measured")

    # -- (a) the resident index, sharded ---------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 13)
    ell = dataclasses.replace(bot_ell, cols=bot_ell.cols.to(dev),
                              nnz=bot_ell.nnz.to(dev))
    one = BoTIndex(device=dev)
    one.set_ell(ell)
    one.data = texts
    one.build_bitpack()
    n, v = ell.shape[0], ell.num_cols
    q_emb = retriever.process_query(queries[:B])
    dy = (rng.integers(0, 129, size=q_emb.shape) / 16.0).astype(np.float32)
    want, ms_one = {}, {}
    for sel in ("bucketed", "exact"):
        one.selection = sel
        for name, qq in (("dyadic", dy), ("query", q_emb)):
            want[sel, name], ms_one[sel, name] = timed_search(
                torch, lambda: one.search(qq, k=K))
    exact = bp.bitpack_scores(torch.from_numpy(q_emb).to(dev), one.bitmat)
    kth = bp.top_k(exact, K)[0][:, K - 1:]
    sh = BoTIndex(device=dev)
    sh.set_ell(ell)
    sh.data = texts
    got, ms_sh = {}, {}

    def run_a():
        sh.to_mesh(mesh)  # kernel #1 packs each shard on its device
        for sel in ("bucketed", "exact"):
            sh.selection = sel
            for name, qq in (("dyadic", dy), ("query", q_emb)):
                got[sel, name], ms_sh[sel, name] = timed_search(
                    torch, lambda: sh.search(qq, k=K))

    before = dict(counts)
    sharded(run_a)
    la = {k: counts[k] - before[k] for k in counts}
    for key in got:
        a, b = got[key], want[key]
        same = (np.array_equal(a.ids, b.ids)
                and np.array_equal(a.scores, b.scores))
        if key[1] == "dyadic":
            require(same, f"(a) sharded {key} differs from one device")
        else:
            require(same or same_topk(b.ids, b.scores, a.ids, a.scores,
                                      1e-6), f"(a) sharded {key} differs")
        log(f"  (a) {key[0]} selection, {key[1]} weights: sharded "
            f"{'==' if same else 'within rtol 1e-6 of'} one device; first "
            f"stage {ms_sh[key]:.1f} ms sharded, {ms_one[key]:.1f} ms one "
            f"device")
    hit = torch.gather(exact, 1, torch.from_numpy(
        got["bucketed", "query"].ids).to(dev))
    rec = float((hit >= kth - 1e-3 * kth.clamp_min(1.0)).float().mean())
    log(f"phase 13 (a) resident index, {n} rows over {MESH_SHARDS} shards "
        f"of {sh._shards.rows_per} rows (whole 1024-row blocks): dyadic "
        f"weights bit for bit; bucketed recall vs exact {rec:.4f}; "
        f"launches {la}; took {time.perf_counter() - t0:.1f} s")
    require(rec >= 0.99, f"(a) sharded recall {rec}")
    require(la["pack"] >= MESH_SHARDS and la["bucketed"] >= 2 * MESH_SHARDS
            and la["scores"] >= 2 * MESH_SHARDS,
            f"(a) sharded path skipped kernels: {la}")
    del exact, hit, sh

    # -- (d) beta search with rerank through Retriever.to_mesh ----------------
    t0 = time.perf_counter()
    one.selection = "auto"
    qs = queries[:B]
    base = retriever.retrieve(qs, k=K, rerank=True, index=one)
    ms_base = stage_times(retriever)
    one.bitmat = None  # the sharded retriever packs its own shards
    gc.collect()
    torch.cuda.empty_cache()
    retriever.index = one
    encs = (retriever.encoder_q, retriever.encoder_p)

    def run_d():
        retriever.to_mesh(mesh)
        return retriever.retrieve(qs, k=K, rerank=True)

    before = dict(counts)
    try:
        res = sharded(run_d)
    finally:
        retriever.index = None
        for enc in encs:  # later phases embed on one device
            enc._mesh = None
    ld = {k: counts[k] - before[k] for k in counts}
    same = (np.array_equal(res.ids, base.ids)
            and np.array_equal(res.scores, base.scores))
    gap = float(np.abs(res.scores - base.scores).max()
                / max(float(np.abs(base.scores).max()), 1e-6))
    log(f"phase 13 (d) beta search with rerank, Retriever.to_mesh (index "
        f"and rerank embeds over {MESH_SHARDS} shards): "
        f"{'ids and scores == one device' if same else 'largest relative score gap ' + str(gap)}"
        f", {int((res.ids != base.ids).sum())} of {res.ids.size} ids "
        f"differ; stages sharded "
        + ", ".join(f"{k} {t * 1e3:.1f} ms"
                    for k, t in stage_times(retriever).items())
        + "; one device " + ", ".join(f"{k} {t * 1e3:.1f} ms"
                                      for k, t in ms_base.items())
        + f"; launches {ld}; took {time.perf_counter() - t0:.1f} s")
    require(same or same_topk(base.ids, base.scores, res.ids, res.scores,
                              RERANK_RTOL),
            f"(d) sharded beta search differs (gap {gap})")
    require(ld["pack"] >= MESH_SHARDS and ld["bucketed"] >= MESH_SHARDS,
            f"(d) skipped kernels: {ld}")
    del one, ell, res, base
    gc.collect()
    torch.cuda.empty_cache()

    # -- (b) phase 8's rows, the block tier sharded --------------------------
    t0 = time.perf_counter()
    nb, vb = args.wiki_rows, len(words)
    cols_d, nnz_d = synth_bot_rows(torch, dev, nb, args.seed, vb)
    blk = BoTIndex(search_mode="block", device=dev)
    blk.set_ell(ELLMatrix(cols=cols_d, nnz=nnz_d, vals=None, num_cols=vb,
                          sentinel_padded=True))
    torch.cuda.synchronize()
    t_made = time.perf_counter() - t0
    firsts, ms_b = [], []

    def run_b():
        blk.to_mesh(mesh)  # the compact ELL, split as views
        for qe in large["q_embs"]:
            res, ms = timed_search(torch, lambda: blk.search(qe, k=K))
            firsts.append(res)
            ms_b.append(ms)

    before = dict(counts)
    sharded(run_b)
    lb = {k: counts[k] - before[k] for k in counts}
    bases = {id(p.cols._base) for p in blk._mesh_ell.parts}
    views = len(bases) == 1 and id(None) not in bases
    for i, (res, qe) in enumerate(zip(firsts, large["q_embs"])):
        one_res = large["firsts"][i]
        qb = torch.from_numpy(qe).to(torch.bfloat16).float().numpy()
        got_s = card_scores(torch, qb, res.ids, cols_d, nnz_d, vb)
        kth_b = large["refs"][i][:, -1:]
        rec = float(np.mean(got_s >= kth_b - 1e-3 * np.maximum(kth_b, 1.0)))
        overlap = np.mean([len(set(a) & set(b)) / K for a, b in
                           zip(res.ids.tolist(), one_res.ids.tolist())])
        exact_ok = np.allclose(res.scores, card_scores(
            torch, qe, res.ids, cols_d, nnz_d, vb), rtol=1e-6, atol=0)
        log(f"  (b) batch {i}: sharded block-tier first stage "
            f"{ms_b[i]:.1f} ms (phase 8, one device: "
            f"{large['first_ms'][i]:.1f} ms); recall vs exact {rec:.4f}; "
            f"{overlap:.4f} of phase 8's ids; scores == exact f32 sums "
            f"(rtol 1e-6): {exact_ok}")
        require(rec >= 0.99 and overlap >= 0.99 and exact_ok,
                f"(b) batch {i}: recall {rec}, overlap {overlap}")
    log(f"phase 13 (b) block tier: {nb} rows remade on the card in "
        f"{t_made:.1f} s; compact ELL {tuple(blk._mesh_ell.parts[0].cols.shape)}"
        f" x {MESH_SHARDS} shards ({'views' if views else 'copies'}); "
        f"launches {lb}; took {time.perf_counter() - t0:.1f} s")
    require(views, "(b) the shards copied the compact ELL")
    need = -(-blk._mesh_ell.rows_per // blk.stream_block_rows) \
        * MESH_SHARDS * len(firsts)
    require(lb["pack"] >= need and lb["int8_bucketed"] >= need,
            f"(b) skipped kernels: {lb}, need {need}")
    del blk, cols_d, nnz_d, firsts
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) a dense index of phase 11's size, sharded as views --------------
    t0 = time.perf_counter()
    full = torch.empty((args.dpr_rows, DPR_DIM), dtype=torch.bfloat16,
                       device=dev)
    synth_dense_rows(torch, full, 0, torch.linspace(8.0, 14.0, 1024),
                     args.seed + 12)
    g = torch.Generator(device=dev).manual_seed(args.seed + 13)
    qd = torch.randn((B, DPR_DIM), generator=g, device=dev) \
        .to(torch.bfloat16)
    didx = DenseIndex(device=dev)
    didx.set_vectors(full)
    d_one, ms_d1 = timed_search(torch, lambda: didx.search(qd, k=K))
    didx.to_mesh(mesh)
    views = all(p._base is full for p in didx._shards.parts)
    d_sh, ms_ds = timed_search(torch, lambda: didx.search(qd, k=K))
    same = (np.array_equal(d_sh.ids, d_one.ids)
            and np.array_equal(d_sh.scores, d_one.scores))
    log(f"phase 13 (c) dense: {args.dpr_rows} x {DPR_DIM} bf16 rows "
        f"({full.numel() * 2 / 1e9:.2f} GB) over {MESH_SHARDS} shards "
        f"({'views' if views else 'copies'}): "
        f"{'ids and scores ==' if same else 'within rtol 1e-5 of'} one "
        f"device; search {ms_ds:.1f} ms sharded, {ms_d1:.1f} ms one device "
        f"(host clock, first call each); took "
        f"{time.perf_counter() - t0:.1f} s")
    require(views and (same or same_topk(d_one.ids, d_one.scores, d_sh.ids,
                                         d_sh.scores, 1e-5)),
            "(c) sharded dense search differs or copied the index")
    del didx, full, qd, d_one, d_sh
    gc.collect()
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_13_")
    try:
        # -- (e) cli.serve --mesh_dp ------------------------------------------
        t0 = time.perf_counter()
        served = texts[:args.served_rows]
        ckpt, corpus = f"{work}/ckpt", f"{work}/corpus.jsonl"
        retriever.save_pretrained(ckpt)
        with open(corpus, "w") as f:
            f.writelines(json.dumps({"text": t}) + "\n" for t in served)
        dv = ["--device", str(dev)]
        binary_token_index.main(["--text_file", corpus, "--save_file",
                                 f"{work}/bot.npz", "--tokenizer", ckpt,
                                 "--num_shift", "999", *dv])
        argv = ["--checkpoint", ckpt, "--index_file", f"{work}/bot.npz",
                "--index_type", "bag_of_token", "--data_file", corpus,
                "--warmup", *dv]
        reqs = [queries[2 * i:2 * i + 2] for i in range(8)]
        answers = []
        for extra in ([], ["--mesh_dp", "1"]):
            def run_e():
                ap = make_parser()
                r = prepare_retriever(ap.parse_args(argv + extra), ap)
                server = serve(r, host="127.0.0.1", port=0)
                url = f"http://127.0.0.1:{server.server_address[1]}"
                thread = threading.Thread(target=server.serve_forever,
                                          daemon=True)
                thread.start()
                try:
                    return r, [http(url + "/search", {
                        "queries": qq, "k": K, "rerank": True})
                        for qq in reqs]
                finally:
                    server.shutdown()
                    server.server_close()
                    thread.join(10)

            before = dict(counts)
            r, out = sharded(run_e) if extra else run_e()
            le = {k: counts[k] - before[k] for k in counts}
            if extra:
                require(r.index._mesh is not None, "(e) index not sharded")
            answers.append(out)
            del r
        gap, ndiff = 0.0, 0
        for a, b in zip(*answers):
            ia, ib = np.asarray(a["ids"]), np.asarray(b["ids"])
            sa = np.asarray(a["scores"], np.float32)
            sb = np.asarray(b["scores"], np.float32)
            gap = max(gap, float(np.abs(sa - sb).max())
                      / max(float(np.abs(sa).max()), 1e-6))
            ndiff += int((ia != ib).sum())
            require(same_topk(ia, sa, ib, sb, SERVED_RTOL),
                    "(e) the --mesh_dp 1 server's answer differs")
        ap = make_parser()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            try:
                prepare_retriever(ap.parse_args(argv + ["--mesh_dp", "2"]),
                                  ap)
                refused = False
            except SystemExit:
                refused = True
        msg = err.getvalue().strip().splitlines()[-1] if err.getvalue() \
            else ""
        log(f"phase 13 (e) cli.serve --mesh_dp 1: {len(reqs)} requests "
            f"against the unsharded server: largest relative score gap "
            f"{gap}, {ndiff} ids differ (rtol {SERVED_RTOL}); launches "
            f"{le}; --mesh_dp 2 on {torch.cuda.device_count()} card(s): "
            f"{msg!r}; took {time.perf_counter() - t0:.1f} s")
        require(refused and "needs 2 devices but only" in msg,
                f"(e) --mesh_dp 2 was not refused: {msg!r}")
        require(le["pack"] >= 1 and le["scores"] >= len(reqs),
                f"(e) skipped kernels: {le}")

        # -- (f) distributed training: one NCCL rank on the card --------------
        t0 = time.perf_counter()
        conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "conf", "train_ir_cfg.yaml")
        data = f"{work}/train.jsonl"
        make_train_samples(np.random.default_rng(args.seed + 12), texts,
                           words, args.train_samples, data)
        cut = [f"train.train_sampling_rates="
               f"[{DIST_STEPS / (args.train_samples // TRAIN_B)}]"]
        single = []
        with recorded_steps(torch, dev, single):
            train_cli(conf, ckpt, f"{work}/f1", data, dev, cut)
        child = subprocess.run(
            [sys.executable, "-c", DIST_CHILD, conf, ckpt, f"{work}/f2",
             data, json.dumps(cut), dev.type],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port())),
            capture_output=True, text=True, timeout=600)
        line = [x for x in child.stdout.splitlines()
                if x.startswith("PHASE13F ")]
        require(child.returncode == 0 and line,
                f"(f) the torchrun-style child failed: {child.stderr[-3000:]}")
        info = json.loads(line[-1][len("PHASE13F "):])
        dist_steps = info["steps"]
        l1 = np.array([x for _, x, _ in single])
        l2 = np.array([x for _, x, _ in dist_steps])
        gaps = (np.abs(l2 - l1) / np.abs(l1)).tolist()
        log(f"phase 13 (f) cli.train as rank 0 of a {info['world']}-rank "
            f"{info['backend']} group (WORLD_SIZE=1, LOCAL_RANK=0): "
            f"losses {l2.round(6).tolist()} against one process's "
            f"{l1.round(6).tolist()}, relative gaps {gaps} (step 1 held to "
            f"1e-6, later steps to {DIST_RTOL}); step ms "
            f"{[round(m, 1) for m, _, _ in dist_steps]} against one "
            f"process's {[round(m, 1) for m, _, _ in single]}; the child "
            f"took {info['wall']:.1f} s; took "
            f"{time.perf_counter() - t0:.1f} s")
        require(info["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
                and info["world"] == 1,
                f"(f) the child's group: {info}")
        require(len(l1) == len(l2) == DIST_STEPS and gaps[0] <= 1e-6
                and max(gaps) <= DIST_RTOL, f"(f) losses differ: {gaps}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s; launches of "
        f"its sharded paths {counts}")
    return counts


# -- phase 14 -----------------------------------------------------------------
def tp_train(torch, dev, conf: str, ckpt: str, data: str, rate: float,
             out_dir: str, tp: int):
    """svdr_nq (``conf``'s ``train`` group) from the checkpoint ``ckpt``
    through the trainer API for the share ``rate`` of ``data``'s batches,
    over a mesh of ``tp`` virtual shards of ``dev`` along tp (none at
    tp=1, or a dp of 1 under a process group of one). Returns the
    trainer."""
    from vsearch_tpu_torch.config import load_config
    from vsearch_tpu_torch.data import BiEncoderDataset
    from vsearch_tpu_torch.parallel.collectives import group_up
    from vsearch_tpu_torch.parallel.mesh import make_mesh
    from vsearch_tpu_torch.retriever import Retriever
    from vsearch_tpu_torch.train.trainer import RetrieverTrainer, TrainConfig

    cfg = load_config(conf, [])
    retriever = Retriever.from_pretrained(ckpt, device=dev)
    tcfg = TrainConfig.from_dict({
        **cfg["train"], "seed": int(cfg["seed"]), "output_dir": out_dir,
        "num_train_epochs": 1, "train_sampling_rates": [rate],
        "log_batch_step": 10 ** 6, "train_rolling_loss_step": 10 ** 6})
    mesh = (make_mesh(dp=1, tp=tp, devices=[dev] * tp)
            if tp > 1 or group_up() else None)
    trainer = RetrieverTrainer(retriever, tcfg, [BiEncoderDataset(data)],
                               mesh=mesh)
    trainer.run_train()
    return trainer


@contextlib.contextmanager
def recorded_splits():
    """Records, for each forward under autograd, the device types the VDR
    head's vocabulary was split over (None: not split)."""
    import torch

    from vsearch_tpu_torch.models import vdr

    split, seen = vdr._vocab_split, []

    def record(pool, h, proj, valid, devices):
        if torch.is_grad_enabled():
            seen.append(tuple(d.type for d in devices) if devices else None)
        return split(pool, h, proj, valid, devices)

    vdr._vocab_split = record
    try:
        yield seen
    finally:
        vdr._vocab_split = split


def hold_first_step(label: str, got: tuple, want: tuple) -> None:
    """Step 1's (unclipped global norm, f64 sum of the clipped gradients,
    f64 sum of the updated weights) against tp=1's from the same weights
    and batch: the backward pass through the vocabulary split, which the
    losses barely see (the first update moves no weight)."""
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    log(f"  {label} step 1 against tp=1: grad_norm {got[0]!r} / "
        f"{want[0]!r}, gradient sum {got[1]!r} / {want[1]!r}, weight sum "
        f"{got[2]!r} / {want[2]!r}; relative gaps {gaps} (the first two "
        f"held to {TP_NORM_RTOL} and {TP_GRAD_SUM_RTOL})")
    require(gaps[0] <= TP_NORM_RTOL and gaps[1] <= TP_GRAD_SUM_RTOL,
            f"{label}'s first step differs from tp=1: {gaps}")


def phase_tp(torch, dev, args, retriever, tok, words, texts, smi: str
             ) -> None:
    """Phase 14: svdr_nq at BERT-base width, ``TP_STEPS`` steps at tp=1
    and at tp=``TP_SHARDS`` virtual shards of the card from one checkpoint
    and seed, then one step at tp=2 under a one-rank NCCL group."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                        "train_ir_cfg.yaml")
    work = tempfile.mkdtemp(prefix="chip_smoke_14_")
    try:
        data = os.path.join(work, "train.jsonl")
        make_train_samples(np.random.default_rng(args.seed + 14), texts,
                           words, args.train_samples, data)
        ckpt = os.path.join(work, "vdr_init")
        retriever.save_pretrained(ckpt)  # random weights from --seed
        rate = TP_STEPS / (args.train_samples // TRAIN_B)
        v_out = retriever.encoder_q.config.out_dim
        widest = -(-v_out // TP_SHARDS)
        rows = 2 * TRAIN_B * TRAIN_LP  # a step's passages x tokens
        log(f"phase 14 (training on the tp axis): svdr_nq, BERT-base VDR "
            f"q+p, V'={v_out}, bf16 compute on f32 weights, B={TRAIN_B} + 1 "
            f"hard negative, q {TRAIN_LQ} / p {TRAIN_LP}; {TP_STEPS} steps "
            f"at tp=1 and at tp={TP_SHARDS} virtual shards of one card "
            f"({smi}) from one checkpoint and seed; no multi-card speed is "
            f"measured; set-up {time.perf_counter() - t_phase:.1f} s")
        runs, firsts = {}, {}
        for tp in (1, TP_SHARDS):
            steps, sums = [], []
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with recorded_steps(torch, dev, steps, sums=sums), \
                    recorded_splits() as splits:
                trainer = tp_train(torch, dev, conf, ckpt, data, rate,
                                   os.path.join(work, f"tp{tp}"), tp)
            peak = peak_gib(torch, dev)
            # the q and p forwards of every step, split over the tp line
            want = [(dev.type,) * tp if tp > 1 else None] * (2 * TP_STEPS)
            require(len(steps) == TP_STEPS and splits == want
                    and next(trainer.module.parameters()).device.type
                    == dev.type,
                    f"tp={tp}: {len(steps)} steps, the head split over "
                    f"{splits}")
            slice_cols = v_out if tp == 1 else widest
            ms = [m for m, _, _ in steps]
            runs[tp] = np.array([x for _, x, _ in steps])
            firsts[tp] = (steps[0][2],) + sums[0]
            log(f"  tp={tp}: losses {runs[tp].round(6).tolist()}, step ms "
                f"{[round(m, 1) for m in ms]} (median after the first "
                f"{float(np.median(ms[1:])):.2f}); card peak {peak}; the "
                f"widest slice {slice_cols} of {v_out} columns, its "
                f"[{rows}, {slice_cols}] f32 passage logits "
                f"{rows * slice_cols * 4 / 1e9:.3f} GB; {trainer.mesh}; "
                f"took {time.perf_counter() - t0:.1f} s")
            require(np.isfinite(runs[tp]).all(),
                    f"tp={tp}: non-finite loss {runs[tp]}")
            del trainer
        gaps = (np.abs(runs[TP_SHARDS] - runs[1]) / np.abs(runs[1])).tolist()
        log(f"  tp={TP_SHARDS} against tp=1: relative loss gaps {gaps} "
            f"(step 1 held to {TP_RTOL}, later steps to {DIST_RTOL})")
        require(gaps[0] <= TP_RTOL and max(gaps) <= DIST_RTOL,
                f"tp={TP_SHARDS} losses differ from tp=1: {gaps}")
        hold_first_step(f"tp={TP_SHARDS}", firsts[TP_SHARDS], firsts[1])

        # -- dp x tp under a process group: one NCCL rank, tp=2 ---------------
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", TP_CHILD, conf, ckpt, f"{work}/tp2",
             data, str(1 / (args.train_samples // TRAIN_B)), dev.type],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port())),
            capture_output=True, text=True, timeout=600)
        line = [x for x in child.stdout.splitlines()
                if x.startswith("PHASE14 ")]
        require(child.returncode == 0 and line,
                f"the dp x tp child failed: {child.stderr[-3000:]}")
        info = json.loads(line[-1][len("PHASE14 "):])
        loss = info["steps"][0][1]
        require([tuple(x) for x in info["splits"]] == [(dev.type,) * 2] * 2,
                f"the dp x tp child's head split over {info['splits']}")
        gap = abs(loss - runs[1][0]) / abs(runs[1][0])
        log(f"  dp=1 x tp=2 as rank 0 of a {info['world']}-rank "
            f"{info['backend']} group ({info['mesh']}): step 1 loss "
            f"{loss:.6f} against tp=1's {runs[1][0]:.6f}, relative gap "
            f"{gap:.2e} (held to {TP_RTOL}); step ms "
            f"{info['steps'][0][0]:.1f}; the child took {info['wall']:.1f} "
            f"s; took {time.perf_counter() - t0:.1f} s")
        require(info["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
                and info["world"] == 1
                and len(info["steps"]) == 1 and gap <= TP_RTOL,
                f"the dp x tp child: {info}")
        hold_first_step("the dp=1 x tp=2 rank",
                        (info["steps"][0][2],) + tuple(info["sums"][0]),
                        firsts[1])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 15 -----------------------------------------------------------------
def captured(fn, *a):
    """``fn(*a)`` with its standard output logged line by line under a
    prefix (so this script's own last two lines stay last); returns what
    ``fn`` returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    for line in buf.getvalue().splitlines():
        log(f"    | {line}")
    return out


def same_quick_start(got: dict, want: dict, rtol: float) -> str:
    """'' when two quick start runs agree (alpha and beta ids equal,
    scores within ``rtol`` of the largest, ``explain``'s top 5 tokens
    equal), else what differs."""
    for key in ("alpha", "beta"):
        if not np.array_equal(got[key].ids, want[key].ids):
            return f"{key} ids {got[key].ids} != {want[key].ids}"
    for key, a, b in (("scores", got["scores"], want["scores"]),
                      ("alpha scores", got["alpha"].scores,
                       want["alpha"].scores),
                      ("beta scores", got["beta"].scores,
                       want["beta"].scores),
                      ("explain weights", list(got["explain"].values()),
                       list(want["explain"].values()))):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        gap = float(np.abs(a - b).max(initial=0.0)
                    / max(np.abs(b).max(initial=0.0), 1e-6))
        if gap > rtol:
            return f"{key} differ by {gap:.3g} of the largest (> {rtol})"
    if list(got["explain"]) != list(want["explain"]):
        return (f"explain top 5 {list(got['explain'])} != "
                f"{list(want['explain'])}")
    return ""


def f32_checkpoint(src: str, dst: str) -> str:
    """``dst``: the checkpoint ``src`` with each encoder's compute dtype
    set to f32 (its weights, stored in f32, and vocab linked)."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name != "config.json":
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    for side in ("encoder_q", "encoder_p"):
        cfg[side]["dtype"] = "float32"
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f)
    return dst


def run_script(name: str, env: dict) -> float:
    """One of the port's wiki21m scripts through ``bash`` from the repo
    root; fails the phase on a non-zero exit. Returns its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        ["bash", os.path.join(root, "vsearch_tpu_torch", "examples",
                              "svdr_wiki21m", name)],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    require(out.returncode == 0, f"{name} exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    for line in out.stdout.strip().splitlines()[-2:]:
        log(f"    | {line}")
    return secs


def bf16_gap(got: dict, want: dict) -> tuple:
    """A quick start run in bf16 (``got``) against the f32 run of the same
    checkpoint on the same device: (the largest score change, the change
    on the ids that both runs match between the query and a passage, each
    a share of the largest f32 score; the least share of a text's nonzero
    ids, the query's or a passage's, that both runs keep)."""
    gq, wq = got["q_emb"][0], want["q_emb"][0]
    gp, wp = got["p_emb"], want["p_emb"]
    top = float(np.abs(want["scores"]).max())
    gap = float(np.abs(got["scores"] - want["scores"]).max()) / top
    kept = 0.0
    for j in range(len(wp)):
        both = (gq != 0) & (gp[j] != 0) & (wq != 0) & (wp[j] != 0)
        moved = (gq[both].astype(np.float64) * gp[j][both]).sum() \
            - (wq[both].astype(np.float64) * wp[j][both]).sum()
        kept = max(kept, abs(float(moved)) / top)
    overlap = min(float(((g != 0) & (w != 0)).sum() / max((w != 0).sum(), 1))
                  for g, w in [(gq, wq)] + list(zip(gp, wp)))
    return gap, kept, overlap


# the kernel wrappers that phases 15 and 16 record, (module of
# vsearch_tpu_torch.ops, function): every wrapper that launches a kernel
# (tests/test_torch_package.py::test_every_kernel_has_a_counter_and_a_
# plain_twin); ``call_counter`` names each call's launch counter
RECORDED = (("bitpack", "pack_bits"), ("bitpack", "score_bits"),
            ("bitpack", "bucket_keys"), ("bitpack", "int8_bucket_keys"),
            ("probes", "bitcast_rows"), ("probes", "pack_bits_t"),
            ("probes", "bucket_keys_t"), ("probes", "plane_variant"),
            ("probes", "bucket_keys_t_decode_only"), ("ssd", "ssd_chunk"))
# the wrappers of timing-only kernels: counted, never held (their keys
# are not the function's)
TIMING_ONLY = ("plane_variant", "bucket_keys_t_decode_only")
HOLD_ROWS = 1 << 18  # rows a slice of a recorded call's hold
# a recorded call's tensors up to this size are copied when recorded (a
# caller may reuse a buffer, as the stream tier's staging); a larger one
# is kept as it is and must be unchanged (its version) when held
KEEP_BYTES = 1 << 28


def call_counter(fname: str, a: dict) -> str:
    """The ``cuda_build.LAUNCHES`` counter that a call of wrapper ``fname``
    with the arguments ``a`` (by name) adds to."""
    if fname == "plane_variant":
        return a["kernel"]
    plane = a.get("_form") == "plane"
    return {"pack_bits": "pack",
            "score_bits": "scores_plane" if plane else "scores",
            "bucket_keys": "bucketed_plane" if plane else "bucketed",
            "int8_bucket_keys": "int8_bucketed",
            "bitcast_rows": "bitcast_rows", "pack_bits_t": "pack_t",
            "bucket_keys_t": "bucketed_t",
            "bucket_keys_t_decode_only": "bucketed_t_decode_only",
            "ssd_chunk": "ssd_chunk"}[fname]


@contextlib.contextmanager
def recorded_kernel_calls(where: dict):
    """Every kernel wrapper of ``RECORDED`` as the paths run inside call
    it on the card, wherever the port holds it by name (``ops.bitpack``,
    ``ops.probes``, ``ops.ssd`` and each module that imported it): the calls by launch
    counter (``rec["calls"]``), and for the first call at each shape (its
    tensors' shapes and its other arguments) the arguments by name and
    the output (copies up to ``KEEP_BYTES``), under ``where["part"]`` at
    that time (``rec["first"]``, for ``hold_recorded_calls``). The
    timing-only kernels (``TIMING_ONLY``) are counted and never kept.
    ``rec["orig"]`` holds the wrappers themselves, which the holds
    call."""
    import inspect

    from vsearch_tpu_torch.ops import bitpack, probes, ssd

    mods = {"bitpack": bitpack, "probes": probes, "ssd": ssd}
    rec = {"first": {}, "seen": set(), "calls": {}, "orig": {}}
    wrappers = {}

    def record(fname, fn, sig):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            if out.device.type == DEVICE:
                bound = sig.bind(*a, **kw)
                bound.apply_defaults()
                args = dict(bound.arguments)
                c = call_counter(fname, args)
                rec["calls"][c] = rec["calls"].get(c, 0) + 1
                key = (fname, c) + tuple(
                    tuple(v.shape) if hasattr(v, "shape") else v
                    for v in args.values())
                if fname not in TIMING_ONLY and key not in rec["seen"]:
                    rec["seen"].add(key)
                    large = {}
                    args = {k: kept(k, v, large) for k, v in args.items()}
                    rec["first"][key] = (where["part"], args,
                                         kept("out", out, large), large)
            return out
        return recorded

    def kept(name, v, large):
        if not hasattr(v, "_version"):
            return v
        if v.numel() * v.element_size() <= KEEP_BYTES:
            return v.clone()
        large[name] = (v, v._version)
        return v

    for mname, fname in RECORDED:
        fn = getattr(mods[mname], fname)
        rec["orig"][fname] = fn
        wrappers[fname] = record(fname, fn, inspect.signature(fn))

    def swap(table):
        # ``table``: function -> its replacement, in every module of the port
        for m in list(sys.modules.values()):
            if not getattr(m, "__name__", "").startswith("vsearch_tpu_torch"):
                continue
            for fname in wrappers:
                f = getattr(m, fname, None)
                if f in table:
                    setattr(m, fname, table[f])

    swap({rec["orig"][f]: w for f, w in wrappers.items()})
    try:
        yield rec
    finally:
        # also modules first imported inside, which took the recorders
        swap({w: rec["orig"][f] for f, w in wrappers.items()})


def check_recorded_launches(phase: int, rec: dict, launches: dict) -> None:
    """Every launch of the phase went through a recorded wrapper."""
    for c, n in launches.items():
        got = rec["calls"].get(c, 0)
        require(got == n, f"phase {phase}: {got} {c} calls recorded against "
                f"{n} launches")


def hold_rows(torch, bp, pk, fname: str, a: dict, out, q, s: int, e: int):
    """(the kernel's output, its plain version's) on rows [s, e) of the
    call ``a`` of wrapper ``fname`` (#2-#4 or P5) under the query operand
    ``q``: the rows' scores, or their keys (``s`` a multiple of 1024)."""
    if fname == "score_bits":
        return out[s:e], bp.score_bits_plain(a["words"][s:e], q)
    rows = min(max(a["num_rows"] - s, 0), e - s)
    got = out[s // a["bucket"]:e // a["bucket"]]
    if fname == "bucket_keys_t":
        return got, pk.bucket_keys_t_plain(a["words_t"][:, s:e], q, rows,
                                           a["bucket"])
    plain = (bp.int8_bucket_keys_plain if fname == "int8_bucket_keys"
             else bp.bucket_keys_plain)
    return got, plain(a["words"][s:e], q, rows, a["bucket"])


def hold_call(torch, dev, rng, orig: dict, fname: str, a: dict, out
              ) -> str:
    """One recorded call held against its kernel's plain version on the
    same inputs, in slices of ``HOLD_ROWS`` rows (the plain versions of a
    2M-row call at once would need tens of GB): P1, P2, #1 and #4 bit for
    bit; #2 within 1e-5 of the largest score (phase 3's tolerance) and #3
    in either form and P5 within 2^-12 of the keys' scale (decoded), on
    the call's own queries, then each of those bit for bit on a dyadic
    operand of the same shape through the same wrapper. Returns what was
    held."""
    from vsearch_tpu_torch.ops import bitpack as bp
    from vsearch_tpu_torch.ops import probes as pk

    def fail(what):
        return f"{fname} {what} at {shapes}"

    shapes = {k: list(v.shape) if hasattr(v, "shape") else v
              for k, v in a.items()}
    if fname == "ssd_chunk":
        from vsearch_tpu_torch.ops import ssd

        want = ssd.ssd_chunk_plain(a["proj"], a["conv_w"], a["conv_b"],
                                   a["dt_bias"], a["a_log"], a["d"],
                                   a["heads"], a["d_head"], a["d_state"])
        err = float((out.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        require(err <= SSD_TOL * scale, fail(
            f"differs from plain by {err} (tolerance {SSD_TOL} of {scale})"))
        return f"max_abs_err {err} against plain (largest value {scale})"
    if fname == "bitcast_rows":
        want = pk.bitcast_rows_plain(a["x"])
        require(torch.equal(out.view(torch.int16), want.view(torch.int16)),
                fail("!= plain"))
        return "bit-identical to plain"
    if fname in ("pack_bits", "pack_bits_t"):
        cols, nnz, v = a["cols"], a["nnz"], a["num_cols"]
        n = cols.shape[0]
        w = out if fname == "pack_bits" else out.T
        ok = not bool(w[n:].any())
        for s, e in ((s, min(n, s + HOLD_ROWS)) for s in range(0, n,
                                                               HOLD_ROWS)):
            if fname == "pack_bits":
                want = bp.pack_bits_plain(cols[s:e], nnz[s:e], v)[:e - s]
            else:
                want = pk.pack_bits_t_plain(cols[s:e], nnz[s:e],
                                            v)[:, :e - s].T
            ok = ok and torch.equal(w[s:e], want)
        require(ok, fail("!= plain"))
        return "bit-identical to plain"
    words = a["words_t"].T if fname == "bucket_keys_t" else a["words"]
    n_pad = words.shape[0]
    q = a["q8T"] if fname == "int8_bucket_keys" else a["qT"]
    slices = [(s, min(n_pad, s + HOLD_ROWS)) for s in range(0, n_pad,
                                                            HOLD_ROWS)]
    dec = lambda kk: (kk & ~1023).view(torch.float32).clamp_min(0)  # noqa
    err = scale = 0.0
    for s, e in slices:
        got, want = hold_rows(torch, bp, pk, fname, a, out, q, s, e)
        if fname == "int8_bucket_keys":
            require(torch.equal(got, want), fail("!= plain"))
            continue
        if fname != "score_bits":
            got, want = dec(got), dec(want)
        err = max(err, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    if fname == "int8_bucket_keys":
        return "bit-identical to plain"
    tol = (1e-5 * max(scale, 1.0) if fname == "score_bits"
           else 2.0 ** -12 * scale)
    require(err <= tol, fail(f"differs from plain by {err} (tolerance "
                             f"{tol})"))
    vp, b = q.shape
    dyT = dyadic_operand(torch, rng, dev, vp, a.get("num_cols") or vp, b)
    dy_out = orig[fname](**dict(a, qT=dyT))
    for s, e in slices:
        got, want = hold_rows(torch, bp, pk, fname, a, dy_out, dyT, s, e)
        require(torch.equal(got, want), fail("!= plain (dyadic)"))
    return (f"bit-identical to plain (dyadic), max_abs_err {err} "
            f"{'' if fname == 'score_bits' else 'decoded '}(the call's "
            f"queries)")


def hold_recorded_calls(torch, dev, rec: dict, phase: int) -> None:
    """Each first call at a shape that ``rec`` kept since the last hold,
    held against its kernel's plain version (``hold_call``), then let
    go."""
    rng = np.random.default_rng(phase)
    for key, (part, a, out, large) in rec["first"].items():
        for name, (t, version) in large.items():
            require(t._version == version, f"{key[1]} as {part} called it: "
                    f"its {name} changed after the call")
        shapes = ", ".join(f"{k} {list(v.shape)}" if hasattr(v, "shape")
                           else f"{k} {v}" for k, v in a.items())
        what = hold_call(torch, dev, rng, rec["orig"], key[0], a, out)
        log(f"  {key[1]} as {part} called it ({shapes}): {what}")
    rec["first"].clear()


@contextlib.contextmanager
def timed_info_cards(torch, dev, out: list):
    """Every ``RetrieverTrainer`` info card made inside records its
    milliseconds into ``out`` (synchronised before and after)."""
    from vsearch_tpu_torch.train import trainer as tr

    orig = tr.RetrieverTrainer._log_info_card

    def timed(self, host_batch):
        sync(torch, dev)
        t0 = time.perf_counter()
        orig(self, host_batch)
        sync(torch, dev)
        out.append((time.perf_counter() - t0) * 1e3)

    tr.RetrieverTrainer._log_info_card = timed
    try:
        yield out
    finally:
        tr.RetrieverTrainer._log_info_card = orig


def tools_quick_start(torch, dev, retriever, work: str) -> str:
    """Phase 15 (a): the quick start tiny, then from the tiny model's
    checkpoint and the phase-4 BERT-base retriever's computed in f32, each
    held against the same ``main`` on the CPU, then that checkpoint as
    saved (bf16) against its f32 run on each device. Returns the
    BERT-base checkpoint's path."""
    from vsearch_tpu_torch.examples import quick_start

    log("phase 15 (the repo's tools on the card): (a) quick start")
    dv = ["--device", str(dev)]
    t0 = time.perf_counter()
    got = captured(quick_start.main, dv)
    n = len(quick_start.PASSAGES)
    require(got["scores"].shape == (1, n)
            and np.isfinite(got["scores"]).all()
            and all(sorted(r.ids[0].tolist()) == list(range(n))
                    for r in (got["alpha"], got["beta"])),
            f"quick start (tiny, no checkpoint): {got}")
    log(f"  tiny random model on the card ({time.perf_counter() - t0:.2f}"
        f" s): finite scores, alpha and beta rank all {n} passages")
    # the same main from checkpoints on the card and on the CPU, in f32:
    # the tiny model's (its seed draws other weights on each device, so it
    # is saved from the card) and the phase-4 BERT-base retriever's weights
    # with its compute dtype set to f32 (bf16 moves top-k ids, below)
    ckpt, tiny = f"{work}/ckpt", f"{work}/tiny"
    retriever.save_pretrained(ckpt)
    f32 = f32_checkpoint(ckpt, f"{work}/ckpt_f32")
    quick_start.make_tiny_retriever(dev).save_pretrained(tiny)
    for label, path in (("tiny checkpoint (f32)", tiny),
                        ("phase 10's BERT-base checkpoint in f32", f32)):
        argv = ["--checkpoint", path]
        t0 = time.perf_counter()
        got = captured(quick_start.main, argv + dv)
        t1 = time.perf_counter()
        want = captured(quick_start.main, argv + ["--device", "cpu"])
        t2 = time.perf_counter()
        diff = same_quick_start(got, want, QUICK_RTOL)
        log(f"  {label}: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; "
            f"alpha {got['alpha'].ids[0].tolist()}, beta "
            f"{got['beta'].ids[0].tolist()}, explain top 5 "
            f"{list(got['explain'])}; card vs CPU: "
            f"{diff or f'equal ids and tokens, scores within {QUICK_RTOL}'}")
        require(not diff, f"quick start ({label}), card vs CPU: {diff}")
        gc.collect()
    # the checkpoint as saved, bf16, against its f32 run on each device:
    # the CPU's reading is the yardstick of the card's, which is gated
    for where, f32_run in (("card", got), ("CPU", want)):
        t0 = time.perf_counter()
        bf16 = captured(quick_start.main, [
            "--checkpoint", ckpt, "--device",
            str(dev) if where == "card" else "cpu"])
        gap, kept, overlap = bf16_gap(bf16, f32_run)
        log(f"  phase 10's BERT-base checkpoint as saved (bf16) on the "
            f"{where} ({time.perf_counter() - t0:.2f} s): alpha "
            f"{bf16['alpha'].ids[0].tolist()}, beta "
            f"{bf16['beta'].ids[0].tolist()}; against the {where}'s f32 "
            f"run: largest score change {gap!r} of the largest score, on "
            f"the matched ids both runs keep {kept!r}; top-k ids kept, "
            f"least of the four texts: {overlap!r}")
        require(np.isfinite(bf16["scores"]).all(),
                f"quick start (bf16 checkpoint, {where}): non-finite scores")
        if where == "card":
            require(gap <= BF16_GAP and kept <= BF16_KEPT
                    and overlap >= BF16_OVERLAP,
                    f"quick start in bf16 on the card against f32: change "
                    f"{gap} (limit {BF16_GAP}), on kept ids {kept} (limit "
                    f"{BF16_KEPT}), ids kept {overlap} (at least "
                    f"{BF16_OVERLAP})")
        gc.collect()
    return ckpt


def tools_scripts(torch, dev, ckpt: str, queries, texts, work: str) -> None:
    """Phase 15 (b): the three wiki21m scripts through ``bash`` over
    ``texts`` and ``ckpt``, ``beta_search.sh``'s results held against the
    ``beta_search`` CLI run in this process on the same inputs."""
    from vsearch_tpu_torch.cli.search import beta_search

    corpus, qfile = f"{work}/corpus.jsonl", f"{work}/queries.jsonl"
    with open(corpus, "w") as f:
        f.writelines(json.dumps({"text": t}) + "\n" for t in texts)
    qs = queries[:min(64, len(queries))]
    with open(qfile, "w") as f:
        f.writelines(json.dumps({"question": q}) + "\n" for q in qs)
    with open(f"{work}/qa.csv", "w") as f:
        f.writelines(f"{q}\t{[q.split()[-1]]!r}\n" for q in qs)
    env = dict(os.environ, DEVICE=str(dev), PYTHON=sys.executable,
               HF_HUB_OFFLINE="1", VSEARCH_TPU_VOCAB=f"{ckpt}/vocab.txt",
               CKPT=ckpt, TEXT=corpus, INDEX=f"{work}/bot.npz",
               QUERY=qfile, RESULT=f"{work}/beta.json",
               QA=f"{work}/qa.csv")
    secs = {"build_binary_token_index.sh": run_script(
        "build_binary_token_index.sh", dict(env, SAVE=f"{work}/bot.npz"))}
    secs["beta_search.sh"] = run_script(
        "beta_search.sh", dict(env, SAVE=f"{work}/beta.json"))
    secs["score_wiki21m.sh"] = run_script("score_wiki21m.sh", env)
    t0 = time.perf_counter()
    beta_search.main(["--checkpoint", ckpt, "--query_file", qfile,
                      "--text_file", corpus, "--index_file",
                      f"{work}/bot.npz", "--save_file", f"{work}/ref.json",
                      "--num_rerank", "100", "--device", str(dev)])
    ref_s = time.perf_counter() - t0
    res = []
    for name in ("beta", "ref"):
        with open(f"{work}/{name}.json") as f:
            rows = json.load(f)
        res.append((np.asarray([r["ids"] for r in rows]),
                    np.asarray([r["scores"] for r in rows], np.float32)))
    (ids, scores), (r_ids, r_scores) = res
    exact = np.array_equal(ids, r_ids) and np.array_equal(scores, r_scores)
    require(ids.shape == (len(qs), K) and (exact or same_topk(
        r_ids, r_scores, ids, scores, SERVED_RTOL)),
        "beta_search.sh results differ from the beta_search CLI's")
    log(f"  (b) wiki21m scripts over {len(texts)} passages, {len(qs)} "
        f"queries: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" (each a process of its own); beta_search.sh == the "
        f"beta_search CLI in this process ({ref_s:.2f} s): "
        f"{'bit-identical' if exact else f'rtol {SERVED_RTOL}'}")
    gc.collect()
    torch.cuda.empty_cache()


def tools_demo(torch, dev, args, work: str) -> None:
    """Phase 15 (c): the convergence demo, ``--demo-topics`` topics for
    ``--demo-epochs`` epochs at 4 layers of 256, its top-1 gated at the
    full run; its train time split into the steps, the info cards and the
    rest, each synchronised."""
    from vsearch_tpu_torch.examples import train_demo

    torch.cuda.reset_peak_memory_stats(dev)
    full = (args.demo_topics, args.demo_epochs) == (DEMO_TOPICS, DEMO_EPOCHS)
    steps, cards = [], []
    with recorded_steps(torch, dev, steps), \
            timed_info_cards(torch, dev, cards):
        demo = captured(train_demo.main, [
            "--num-topics", str(args.demo_topics), "--epochs",
            str(args.demo_epochs), "--layers", "4", "--hidden", "256",
            "--batch-size", str(B), "--out", f"{work}/demo", "--device",
            str(dev)])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"  (c) convergence demo ({demo['model']}, "
        f"{demo['num_topics']} topics, {demo['steps']} steps at B={B}): "
        f"top-1 {demo['top1_before']} before, {demo['top1_after']} "
        f"after by alpha search, {demo['top1_beta_after']} by beta "
        f"search with rerank; {demo['steps_per_s']} steps/s, train "
        f"{demo['train_seconds']} s, card peak {peak:.3f} GiB "
        f"({demo['device']})")
    ms = [s[0] for s in steps]
    step_s, card_s = sum(ms) / 1e3, sum(cards) / 1e3
    log(f"    train time: {len(ms)} steps {step_s!r} s (median "
        f"{float(np.median(ms))!r} ms, first {ms[0]!r} ms), {len(cards)} "
        f"info cards {card_s!r} s (median {float(np.median(cards))!r} ms), "
        f"the rest {demo['train_seconds'] - step_s - card_s!r} s "
        f"(batches, epoch ends, saves); each step and card synchronised")
    if full:
        require(demo["top1_before"] <= 0.2,
                f"demo top-1 before {demo['top1_before']} > 0.2")
        require(demo["top1_after"] >= 0.9 and demo["top1_beta_after"] >= 0.9,
                f"demo top-1 after {demo['top1_after']} (alpha), "
                f"{demo['top1_beta_after']} (beta): below 0.9")
    else:
        log("    (cut by --demo-topics/--demo-epochs: top-1 not gated)")


def phase_tools(torch, dev, args, retriever, queries, texts) -> dict:
    """Phase 15: the repo's own tools on the card, through the port's
    entry points: (a) the quick start (``tools_quick_start``), (b) the
    wiki21m scripts over ``texts`` (``tools_scripts``), (c) the
    convergence demo (``tools_demo``). Launch counts are zeroed before (a)
    and read after (c); the script children's launches are their own.
    Every launch must have been recorded (``recorded_kernel_calls``), and
    each shape at which (a)-(c) called a kernel in this process is held
    against its plain version on the same inputs. Returns the counts."""
    from vsearch_tpu_torch.ops import cuda_build
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    where = {"part": "(a)"}
    try:
        with recorded_kernel_calls(where) as rec:
            ckpt = tools_quick_start(torch, dev, retriever, work)
            where["part"] = "(b)"
            tools_scripts(torch, dev, ckpt, queries, texts, work)
            where["part"] = "(c)"
            tools_demo(torch, dev, args, work)
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  launches of phase 15 (this process): {launches}")
    require(launches["pack"] >= 1 and launches["scores"] >= 1,
            f"phase 15 skipped kernels #1 or #2: {launches}")
    check_recorded_launches(15, rec, launches)
    hold_recorded_calls(torch, dev, rec, 15)
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def hold_probes(r: dict) -> None:
    """What phase 16's probes must find on the card, beside the holds of
    every kernel call (``hold_recorded_calls``): P1's layout A; the
    probes' own checks of P2, P5, #1, #3 and #4; the streamed search
    equal to the resident one; the fused QKV within its tolerance; no
    request failed."""
    bc = r["bitcast"]
    require(bc["layout"] == "A" and bc["check"]["bit_identical"],
            f"P1: layout {bc['layout']}, check {bc['check']}")
    pp = r["pack"]
    require(pp["packT"]["bit_identical_to_plain"]
            and pp["pack"]["bit_identical_to_plain"]
            and pp["words_t_equals_words_T"], f"P2 / #1 at 2M: {pp}")
    sv = r["scorer"]
    small = sv["small_check"]
    require(small["ok"] and small["pack_t_bit_identical"]
            and small["keys_t_bit_identical_dyadic"], f"P5 check {small}")
    require(all(sv["pack_checks"].values()), f"P2 / #1: {sv['pack_checks']}")
    for row in sv["rows"]:
        require(row["bit_identical_dyadic"] and row["decoded_within"],
                f"{row['variant']} at 2M x B=1024: {row}")
    require(sv["plane_split"]["shipped_bit_identical_dyadic"],
            "#3's plane form on the 768-id block")
    require(sv["v3_equals_v0"], "P5's keys differ from #3's gather form at "
            "2M x B=1024 (random weights)")
    lc = sv["long_check"]
    require(all(lc[f"b{k}_{w}"] for k in (1, 8)
                for w in ("equals_gather", "bit_identical_dyadic"))
            and lc["rows_past_cap"] > 0 and lc["long_rows_counted"]
            == lc["launches"] * lc["rows_past_cap"],
            f"P5 on rows longer than its lists: {lc}")
    i8 = r["int8"]
    for bucket in (16, 32):
        c8, c3 = i8[f"int8_b{bucket}_check"], i8[f"bf16_b{bucket}_check"]
        require(c8["bit_identical"] and c3["bit_identical_dyadic"]
                and c3["decoded_within"], f"#4 / #3 at bucket {bucket}")
    for label in ("parts", "parts_b32"):
        bpr = r[label]
        require(bpr["pack_check"]["bit_identical"]
                and bpr["keys_bit_identical_dyadic"]
                and bpr["topk_int_matches"], f"{label}: {bpr}")
    for row in r["regret"]["rows"]:
        require(row.get("keys_bit_identical_dyadic", True),
                f"#3 at {row['n']} rows")
    st = r["stream"]
    require(st["stage_a"]["scores_match_resident"]
            and st["stage_b"]["recall_vs_exact"] >= 0.99,
            f"stream tier: {st['stage_a']}, recall "
            f"{st['stage_b']['recall_vs_exact']}")
    require(r["embed"]["fused_within_atol"],
            "fused QKV differs from split beyond its tolerance")
    sl = r["serve"]
    require(all(ph["errors"] == 0 and ph["requests"] > 0
                for ph in sl["phases"]), f"serve load: {sl['phases']}")


def phase_launch(torch, args) -> dict:
    """Phase 16 (b), outside the recorder (which wraps each kernel call
    and would time itself): ``probe_launch_cost``, the host time of one
    kernel call through ``cuda_build.launch`` against the uncached launch
    path (``probe_launch_cost.legacy_launch``), for P1 and for #2 on
    4,096 rows; P1 against its plain
    expression in turns at [8, 128] and [65,536, 1,024], held bit for bit
    there and at [4,099, 1,030]."""
    from vsearch_tpu_torch.scripts import probe_launch_cost

    out = [] if not args.probe_out else [
        "--out", os.path.join(args.probe_out, "probe_launch_cost.json")]
    r = probe_launch_cost.main(["--seed", str(args.seed), "--device",
                                DEVICE] + out)
    h = {k: "n/a" if v is None else f"{v:.2f}"  # None: a CPU rehearsal
         for k, v in r["host_us_a_call"].items()}
    log(f"  host us a call (time.perf_counter, {r['calls']} calls in "
        f"turns; {threading.active_count()} threads in this process): "
        f"P1 wrapper {h['p1_wrapper']}, its plain expression "
        f"{h['p1_plain']}; launch {h['p1_launch']} against the "
        f"uncached path {h['p1_legacy_launch']}; the bare ctypes "
        f"call {h['p1_ctypes']}; the uncached path's parts: device guard "
        f"{h['guard']}, Stream object {h['stream_object']}, "
        f"lookup and typing {h['lookup_and_type']}")
    log(f"  #2 on 4,096 rows of 64 ids, B=32: wrapper {h['s2_wrapper']}"
        f" us, launch {h['s2_launch']} against the uncached path's "
        f"{h['s2_legacy_launch']}")
    for label, c in r["p1"].items():
        require(c["bit_identical"], f"P1 at {c['shape']} != plain: {c}")
        if "p1_ms" in c:
            log(f"  P1 at {c['shape']}: {c['p1_ms']} ms against its "
                f"plain expression {c['plain_ms']} (in turns, rounds "
                f"{c['p1_rounds_ms']} / {c['plain_rounds_ms']}), bound "
                f"{c['bound_ms']:.4g} ms ({c['bound_by']}); bit-identical")
        else:
            log(f"  P1 at {c['shape']}: bit-identical to plain")
    return r


def phase_probes(torch, args) -> dict:
    """Phase 16: the port's probes (``vsearch_tpu_torch/scripts``), the
    counterparts of the repo's TPU probes, each ``main`` in this process
    (``PROBE_RUNS``, two timed repetitions each; the serve load starts its
    server as a child). Launch counts are zeroed before each probe and
    read after it; every launch must have been recorded
    (``recorded_kernel_calls``), and after each probe every shape at which
    it first called a kernel is held against the plain version on the
    same inputs (``hold_recorded_calls``). ``hold_probes`` then holds
    what the probes found, and (b) ``phase_launch`` times the launch path
    and P1 outside the recorder. Returns the launches, the kernels line's
    entries of the probe kernels and fields for the entries of #1-#4."""
    import importlib

    from vsearch_tpu_torch.ops import cuda_build

    t_phase = time.perf_counter()
    log("phase 16: the repo's probes on the card")
    if args.probe_out:
        os.makedirs(args.probe_out, exist_ok=True)
    r = {}
    launches = dict.fromkeys(cuda_build.LAUNCHES, 0)
    where = {}
    with recorded_kernel_calls(where) as rec:
        for key, name, argv in PROBE_RUNS:
            label = " ".join([name] + argv)
            where["part"] = label
            t0 = time.perf_counter()
            out = ([] if not args.probe_out else ["--out", os.path.join(
                args.probe_out, label.replace(" ", "_").replace("-", "")
                + ".json")])
            mod = importlib.import_module(f"vsearch_tpu_torch.scripts.{name}")
            torch.cuda.synchronize()
            cuda_build.reset_launch_counts()
            r[key] = mod.main(argv + ["--iters", "2", "--seed",
                                        str(args.seed), "--device",
                                        DEVICE] + out)
            torch.cuda.synchronize()
            for c, n in cuda_build.LAUNCHES.items():
                launches[c] += n
            t_hold = time.perf_counter()
            hold_recorded_calls(torch, DEVICE, rec, 16)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"  {label}: {t_hold - t0:.1f} s, its holds "
                f"{time.perf_counter() - t_hold:.1f} s")
    log(f"  launches of phase 16: {launches}")
    check_recorded_launches(16, rec, launches)
    log("  every launch was recorded: " + ", ".join(
        f"{c} {n}" for c, n in launches.items() if n))
    # no probe runs #2's plane form or the granite trunk's chunk scan
    # (phase 18 holds it)
    require(all(launches[c] for c in cuda_build.LAUNCHES
                if c not in ("scores_plane", "ssd_chunk")),
            f"phase 16's probes skipped a kernel: {launches}")
    hold_probes(r)
    log("  held: P1 layout A; every kernel call at each shape above "
        "against its plain version; P5 = #3's gather form at 2M x B=1024 "
        "and on rows past its lists; stream = resident; fused QKV; no "
        "failed request")
    bc, pp, sv = r["bitcast"], r["pack"], r["scorer"]
    rows = {row["variant"]: row for row in sv["rows"]}
    ps, vs, lc = sv["plane_split"], sv["v3_split"], sv["long_check"]
    occupancy = (cuda_build.occupancy("bucketed_t") if DEVICE == "cuda"
                 else "n/a")
    log(f"  P5 at 2M x B=1024, in turns (median of rounds): "
        f"{rows['v3_transpose']['ms']} ms (rounds "
        f"{rows['v3_transpose']['rounds_ms']}) "
        f"against #3 gather {rows['v0_current']['ms']} ms (rounds "
        f"{rows['v0_current']['rounds_ms']}), plane {rows['plane']['ms']}"
        f" ms; keys equal to #3's gather form for the random queries: "
        f"{sv['v3_equals_v0']}")
    log(f"  P5's split: words and decode alone {vs['decode_only_ms']} ms "
        f"(rounds {vs['decode_only_rounds_ms']}), so the sweep's gathers "
        f"and adds {vs['sweep_ms']} ms ({vs['qT_gather_bytes'] / 1e9:.1f} "
        f"GB of qT gathers); geometry {vs['geometry']}; {occupancy} CTAs "
        f"an SM (runtime occupancy); long rows at that shape "
        f"{sv['v3_long_rows']}")
    log(f"  P5 on {lc['rows']} rows of up to {lc['max_ids']} ids "
        f"({lc['rows_past_cap']} past the lists' {lc['cap']}), B="
        f"{lc['b']}: = #3's gather form at buckets 1 and 8; long-row path "
        f"taken {lc['long_rows_counted']} times in {lc['launches']} "
        f"launches")
    log(f"  the plane form's split (768-id block, B=32): shipped "
        f"{ps['shipped_ms']} ms, operand only {ps['operand_only_ms']} ms, "
        f"fragments only {ps['fragments_only_ms']} ms (bound "
        f"{ps['bound_ms']:.3f} ms)")
    entries = []

    def add(name, source, replaces, err, ms, plain_ms, bnd, library_ms,
            **extra):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"vsearch_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches[COUNTERS[name]],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": library_ms, **extra})
        log(f"  {name}: {ms} ms (plain {plain_ms} ms, bound "
            f"{bnd['bound_ms']} ms, library {library_ms})")

    # P1's plain expression is also its one-call library counterpart;
    # its times are phase 16 (b)'s, taken outside the recorder
    lc1 = phase_launch(torch, args)
    p1s, p1l = lc1["p1"]["small"], lc1["p1"]["large"]
    host = lc1["host_us_a_call"]
    add("bitcast_rows", "probe_bitcast.cu",
        "scripts/probe_bitcast_layout.py:52",
        max(c["max_abs_err"] for c in lc1["p1"].values()), p1s["p1_ms"],
        p1s["plain_ms"], p1s, p1s["plain_ms"], shape="[8, 128] u32",
        large_shape="[65536, 1024] u32",
        large_ms=p1l["p1_ms"], large_plain_ms=p1l["plain_ms"],
        large_bound_ms=p1l["bound_ms"], host_us=host["p1_wrapper"],
        plain_host_us=host["p1_plain"])
    add("pack_ell_t", "pack_t.cu", "scripts/probe_pack.py:49", 0,
        pp["packT"]["ms"], pp["packT"]["plain_ms"], pp["packT"], None,
        shape="2,000,000 x 128 ids (64 valid), V'=29,523")
    v3 = rows["v3_transpose"]
    add("bucketed_keys_t", "bucketed_t.cu",
        "scripts/probe_scorer_variants.py:198", v3["max_abs_err"], v3["ms"],
        v3["plain_ms"], v3, None,
        shape="2,000,000 rows of ~119 ids, B=1024, bucket 8",
        gather_in_turns_ms=rows["v0_current"]["ms"],
        decode_only_ms=vs["decode_only_ms"],
        long_check_long_rows=lc["long_rows_counted"])
    # timing only: the keys are not the function's and are not compared
    add("bucketed_keys_t_decode_only", "bucketed_t_decode_only.cu",
        "scripts/probe_scorer_variants.py:198", None, vs["decode_only_ms"],
        v3["plain_ms"], v3, None, timing_only=True, shipped_ms=v3["ms"],
        shape="2,000,000 rows of ~119 ids, B=1024, bucket 8")
    for v in ("operand_only", "fragments_only"):
        # timing only: the keys are not the function's and are not compared
        add(f"plane_{v}", f"plane_{v}.cu",
            "scripts/probe_scorer_variants.py:141", None, ps[f"{v}_ms"],
            ps["plain_ms"], ps, None, timing_only=True,
            shipped_ms=ps["shipped_ms"],
            shape="262,144 rows of 768 ids, B=32, bucket 8")
    i8 = r["int8"]
    fields = {
        "bitpack_scores": {"launch_host_us": host["s2_launch"],
                           "launch_host_us_uncached":
                           host["s2_legacy_launch"],
                           "wrapper_host_us": host["s2_wrapper"]},
        "pack_ell": {"probe_2m_ms": pp["pack"]["ms"],
                     "probe_2m_plain_ms": pp["pack"]["plain_ms"],
                     "probe_2m_bound_ms": pp["pack"]["bound_ms"]},
        "bucketed_keys": {"probe_2m_b1024_ms": rows["v0_current"]["ms"],
                          "probe_2m_b1024_bound_ms":
                          rows["v0_current"]["bound_ms"]},
        "bucketed_keys_plane": {"probe_2m_b1024_ms": rows["plane"]["ms"]},
        "int8_bucketed_keys": {"probe_block_b1024_ms": i8["int8_b16_ms"],
                               "probe_block_b1024_plain_ms":
                               i8["int8_b16_plain_ms"]}}
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "entries": entries, "fields": fields}


def bench_resident_check(torch, args) -> None:
    """Phase 17 (a): the bench's resident section over
    ``BENCH_CHECK_PASSAGES`` of its passages on the card (kernels #1 and
    #2) and on the CPU (their plain versions, ``search_mode="bitpack"``):
    the same ids, scores within ``BENCH_RTOL``."""
    from vsearch_tpu_torch import bench
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.scripts import common

    tok, _ = bench.get_bench_tokenizer()
    corpus = bench.make_corpus(BENCH_CHECK_PASSAGES, seed=args.seed)
    _, cols, nnz = bench.build_section(tok, corpus, 32, chunks=1, passes=1)
    v = tok.vocab_size - bench.SHIFT
    q = common.make_queries(256, v, args.seed + 1, torch.device(DEVICE))
    got = {}
    for where, dev, mode in (("card", DEVICE, "auto"),
                             ("CPU", "cpu", "bitpack")):
        index = BoTIndex(search_mode=mode, device=dev)
        index.set_ell(ELLMatrix.from_arrays(cols, nnz, None, v, True,
                                            device=dev))
        t0 = time.perf_counter()
        got[where] = bench.resident_section(index, q.to(dev), 128, K, cols)
        log(f"  (a) resident section, {BENCH_CHECK_PASSAGES} passages on "
            f"the {where} ({time.perf_counter() - t0:.2f} s): "
            f"{got[where]['search_mode']}, selection "
            f"{got[where]['selection']}, recall "
            f"{got[where]['search_recall_vs_exact']!r}")
    card, cpu = got["card"], got["CPU"]
    same = np.array_equal(card["ids"], cpu["ids"])
    require(card["search_mode"] == "bitpack" and (same or same_topk(
        cpu["ids"], cpu["scores"], card["ids"], card["scores"],
        BENCH_RTOL)), "the bench's resident section: card and CPU differ")
    log(f"  (a) card == CPU: "
        f"{'the same ids' if same else 'ids equal but for ties'}, scores "
        f"within {BENCH_RTOL} (largest gap "
        f"{float(np.abs(card['scores'] - cpu['scores']).max())!r})")


def phase_bench(torch, args) -> dict:
    """Phase 17: the port's bench (``vsearch_tpu_torch.bench``, the
    counterpart of ``bench.py``) on the card, inside the recorder: (a)
    ``bench_resident_check``, then ``bench.main`` at its defaults in this
    process (its JSON line logged). Launch counts are zeroed before each
    and read after it; every launch must have been recorded, and every
    shape at which the two called a kernel is held against its plain
    version on the same inputs. #1, #3 and #4 must have launched in the
    bench, its four recalls reach ``BENCH_RECALL_MIN`` (alpha at C =
    1,536), its over-card index take the block tier, and every value be
    finite. Returns the bench's launches."""
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch import bench

    t_phase = time.perf_counter()
    log("phase 17: the port's bench on the card (python -m "
        "vsearch_tpu_torch.bench)")
    where = {"part": "(a)"}
    with recorded_kernel_calls(where) as rec:
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        bench_resident_check(torch, args)
        torch.cuda.synchronize()
        launch_a = dict(cuda_build.LAUNCHES)
        where["part"] = "bench.main"
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        out = captured(bench.main, ["--device", DEVICE, "--seed",
                                    str(args.seed)])
        torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    log(f"  bench.main took {bench_s:.1f} s; launches {launches}; (a)'s "
        f"{launch_a}")
    check_recorded_launches(17, rec, {c: n + launch_a[c]
                                      for c, n in launches.items()})
    t0 = time.perf_counter()
    hold_recorded_calls(torch, DEVICE, rec, 17)
    log(f"  holds {time.perf_counter() - t0:.1f} s")
    require(all(launches[c] for c in ("pack", "bucketed", "int8_bucketed")),
            f"the bench skipped #1, #3 or #4: {launches}")
    recalls = {key: out[key] for key in (
        "search_recall_vs_exact", "scale_search_recall",
        "alpha_scale_recall", "oversize_recall_vs_exact")}
    require(all(r is not None and r >= BENCH_RECALL_MIN
                for r in recalls.values()),
            f"the bench's recalls {recalls}, below {BENCH_RECALL_MIN}")
    require(out["alpha_rerank_candidates"] == bench.ALPHA_C
            and out["oversize_tier"] == "block"
            and out["search_mode"] == "bitpack",
            f"the bench's alpha C {out['alpha_rerank_candidates']}, tier "
            f"{out['oversize_tier']}, search mode {out['search_mode']}")
    bad = [k for k, x in out.items()
           if x is None or (isinstance(x, float) and not np.isfinite(x))]
    require(not bad, f"the bench's values not finite: {bad}")
    log(f"  held: recalls {recalls} >= {BENCH_RECALL_MIN}; over-card tier "
        f"{out['oversize_tier']} ({out['oversize_selection']}); every "
        f"value finite")
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def ssd_inputs(torch, dev, gen, b: int, length: int):
    """Inputs of one chunk-scan call at granite-4.0-h-micro's widths, bf16:
    ``proj`` N(0, 1) (an RMSNormed activation through N(0, 0.02) weights
    of 2,048 inputs reads ~0.9), the conv and Mamba-2's step, decay and
    skip parameters in their published initial ranges."""
    inner = SSD_HEADS * SSD_D_HEAD
    conv_dim = inner + 2 * SSD_D_STATE
    f = dict(device=dev, dtype=torch.float32)
    proj = torch.randn(b, length, inner + conv_dim + SSD_HEADS,
                       generator=gen, **f)
    conv_w = torch.rand(conv_dim, 4, generator=gen, **f) - 0.5
    conv_b = torch.rand(conv_dim, generator=gen, **f) - 0.5
    dt = torch.exp(torch.rand(SSD_HEADS, generator=gen, **f)
                   * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(1 + 15 * torch.rand(SSD_HEADS, generator=gen, **f))
    d = torch.ones(SSD_HEADS, **f)
    return [t.to(torch.bfloat16) for t in
            (proj, conv_w, conv_b, dt_bias, a_log, d)]


def ssd_bound_ms(b: int, length: int) -> tuple:
    """The chunk scan's least milliseconds on the H100 over ``b`` sequences
    of ``length`` positions (``benchmark/flops_granite.py``'s count), the
    largest of: xBC and dt read once and y written once (bf16) at
    3.35 TB/s; the causal pairs' products (C.B shared, then each head's,
    on bf16 inputs) at the bf16 tensor-core rate; the conv's taps and the
    skip at the f32 rate; and which bounds it."""
    inner = SSD_HEADS * SSD_D_HEAD
    conv_dim = inner + 2 * SSD_D_STATE
    pairs = length * (length + 1) // 2
    pair_ops = b * pairs * (2 * SSD_D_STATE + 2 * inner)
    other_ops = b * (length * 8 * conv_dim + length * 2 * inner)
    nbytes = b * length * 2 * (conv_dim + SSD_HEADS + inner)
    t = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
         "tensor-core work": pair_ops / H100_BF16_FLOPS * 1e3,
         "f32 work": other_ops / H100_F32_FLOPS * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def phase_ssd(torch, dev) -> list:
    """Phase 18: the chunk scan on ``SSD_BATCH`` sequences of each of
    ``SSD_LENGTHS``: every call recorded and held against the twin, then
    timed (the kernel by CUDA events over 20 launches, the twin over 2)
    beside its bound. Returns the kernels line's entries."""
    from vsearch_tpu_torch.ops import cuda_build, ssd

    t_phase = time.perf_counter()
    log("phase 18: the granite trunk's Mamba-2 chunk scan at "
        f"granite-4.0-h-micro's widths ({SSD_HEADS} heads of {SSD_D_HEAD}, "
        f"d_state {SSD_D_STATE}), {SSD_BATCH} sequences a call")
    gen = torch.Generator(device=dev).manual_seed(18)
    where = {"part": "phase 18"}
    before = cuda_build.LAUNCHES["ssd_chunk"]
    rows = []
    with recorded_kernel_calls(where) as rec:
        for length in SSD_LENGTHS:
            args = ssd_inputs(torch, dev, gen, SSD_BATCH, length)
            where["part"] = f"phase 18, L={length}"
            ssd.ssd_chunk(*args, SSD_HEADS, SSD_D_HEAD, SSD_D_STATE)
            torch.cuda.synchronize()
            rows.append((length, args))
    launched = cuda_build.LAUNCHES["ssd_chunk"] - before
    check_recorded_launches(18, rec, {"ssd_chunk": launched})
    require(launched == len(SSD_LENGTHS),
            f"phase 18: {launched} chunk-scan launches")
    hold_recorded_calls(torch, dev, rec, 18)
    entries = []
    for length, args in rows:
        ms = time_ms(lambda: ssd.ssd_chunk(*args, SSD_HEADS, SSD_D_HEAD,
                                           SSD_D_STATE), 20)
        plain_ms = time_ms(lambda: ssd.ssd_chunk_plain(
            *args, SSD_HEADS, SSD_D_HEAD, SSD_D_STATE), 2)
        bound, by = ssd_bound_ms(SSD_BATCH, length)
        entries.append({
            "name": "ssd_chunk", "route": "cuda",
            "source": "vsearch_tpu_torch/ops/csrc/ssd_chunk.cu",
            "replaces": "none (the granite trunk's Mamba-2 mixer)",
            "shape": f"{SSD_BATCH} x {length} positions",
            "launches": launched, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
        log(f"  ssd_chunk, {SSD_BATCH} x {length}: {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by}, "
            f"{100 * bound / ms:.1f}% of it)")
        del args
    rows.clear()
    torch.cuda.empty_cache()
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return entries


def phase_int8(torch, bp, dev, ptx: dict) -> list:
    """Phase 19: kernel #4 on one ``BLOCK_ROWS``-row block of Zipf rows
    at bucket 16 for each of ``INT8_BATCHES``: bit-identical to the plain
    version in one launch, one read of the words counted in the call
    record, then timed (20 launches; the plain version once) beside its
    bound. Returns one dict a batch for the kernels line."""
    from vsearch_tpu_torch.ops import cuda_build
    from vsearch_tpu_torch.utils.profiling import TRACER

    t_phase = time.perf_counter()
    v = 29523
    cols, nnz = synth_bot_rows(torch, dev, BLOCK_ROWS, 19, v)
    n_bits = int(nnz.sum())
    blk = bp.pack_bits(cols, nnz, v)
    del cols, nnz
    n_pad, w = blk.shape
    log(f"phase 19: kernel #4 on one {BLOCK_ROWS}-row block of Zipf rows "
        f"({n_bits / BLOCK_ROWS:.1f} set bits a row), bucket "
        f"{bp.BLOCK_BUCKET}")
    gen = torch.Generator(device=dev).manual_seed(19)
    out = []
    for b in INT8_BATCHES:
        q = torch.randn((b, v), generator=gen, device=dev).abs()
        q8T = bp.prepare_queries_int8(q, w * 32)
        before = cuda_build.LAUNCHES["int8_bucketed"]
        with TRACER.call("phase19") as call:
            keys = bp.int8_bucket_keys(blk, q8T, BLOCK_ROWS)
            counts = dict(call.rec.counts)
        torch.cuda.synchronize()
        launched = cuda_build.LAUNCHES["int8_bucketed"] - before
        require(launched == 1, f"phase 19, B={b}: {launched} launches")
        require(counts == {"int8_word_passes": 1},
                f"phase 19, B={b}: call record counts {counts}")
        require(torch.equal(keys, bp.int8_bucket_keys_plain(
            blk, q8T, BLOCK_ROWS)), f"kernel #4 != plain at B={b}")
        ms = time_ms(lambda: bp.int8_bucket_keys(blk, q8T, BLOCK_ROWS), 20)
        plain_ms = time_ms(lambda: bp.int8_bucket_keys_plain(
            blk, q8T, BLOCK_ROWS), 1)
        nbytes = blk.numel() * 4 + q8T.numel() + keys.numel() * 4
        bd = score_bounds(nbytes, n_bits, BLOCK_ROWS, v, b)
        geom = bp.int8_fold_geometry(n_pad, bp.BLOCK_BUCKET, b, w)
        log(f"  kernel #4, B={b}: bit-identical to plain, 1 launch, "
            f"int8_word_passes 1; {ms:.3f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bd['bound_ms']:.3f} ms by {bd['bound_by']}, "
            f"{100 * bd['bound_ms'] / ms:.1f}% of it); {geom.passes} "
            f"pass(es), {geom.lanes} lanes x {geom.groups} entry groups")
        log("    " + geometry_line(ptx, "int8_bucketed", geom, ms, nbytes))
        out.append({"b": b, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                    "launches": launched, "word_passes": 1})
        del q, q8T, keys
    del blk
    torch.cuda.empty_cache()
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# phase 13 (f): cli.train in a process of its own, under torchrun's
# environment (set by the parent): its steps recorded as phase 12 records
# them, with the process group's backend and size
DIST_CHILD = r"""
import json, sys, time
import torch
import torch.distributed as dist
import chip_smoke as cs

conf, ckpt, out, data, cut, device = sys.argv[1:7]
dev = torch.device(device)
steps, info = [], {}
def before(i):
    info.setdefault("backend", dist.get_backend())
    info.setdefault("world", dist.get_world_size())
t0 = time.perf_counter()
with cs.recorded_steps(torch, dev, steps, before):
    cs.train_cli(conf, ckpt, out, data, device, json.loads(cut))
info.update(steps=steps, wall=time.perf_counter() - t0)
print("PHASE13F " + json.dumps(info), flush=True)
"""

# phase 14: one svdr_nq step at tp=2 (virtual shards of the card) as rank 0
# of a one-rank process group formed from torchrun's environment (set by
# the parent), recorded as phase 12 records steps
TP_CHILD = r"""
import json, sys, time
import torch
import torch.distributed as dist
import chip_smoke as cs
from vsearch_tpu_torch.parallel.collectives import initialize_distributed

conf, ckpt, out, data, rate, device = sys.argv[1:7]
dev = torch.device(device)
t0 = time.perf_counter()
assert initialize_distributed(device=device)
try:
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    steps, sums = [], []
    with cs.recorded_steps(torch, dev, steps, sums=sums), \
            cs.recorded_splits() as splits:
        trainer = cs.tp_train(torch, dev, conf, ckpt, data, float(rate), out,
                              tp=2)
    info = dict(backend=dist.get_backend(), world=dist.get_world_size(),
                mesh=repr(trainer.mesh), steps=steps, sums=sums,
                splits=splits)
finally:
    dist.destroy_process_group()
info["wall"] = time.perf_counter() - t0
print("PHASE14 " + json.dumps(info), flush=True)
"""


if __name__ == "__main__":
    sys.exit(main())
