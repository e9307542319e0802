"""Convergence demo on the port (counterpart of the repo's
``scripts/tpu_train_demo.py``): a synthetic word-overlap retrieval task,
trained on the device, with top-1 accuracy before and after.

    python -m vsearch_tpu_torch.examples.train_demo [--num-topics 256]
        [--epochs 8] [--layers 4] [--hidden 256] [--device cuda|cpu]

Each topic owns 24 content words; its passage samples 48 of them and its
query 6 (no verbatim copy). A VDR bi-encoder (BERT of ``--layers`` x
``--hidden``, the 30,522-entry synthetic vocabulary) trains through
``RetrieverTrainer`` with the JAX demo's settings, from the JAX package's
initialization (``models.bert.init_jax_weights``). Top-1 accuracy is
read by alpha search over a ``"sparse"`` index before and after
training, and after training by beta search with rerank over a
``"bag_of_token"`` index. Prints one JSON line with the JAX demo's keys;
``main`` returns it as a dict.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..cli.common import add_device_arg, setup_logging
from .synthetic_vocab import BASE_WORDS, build_wordpiece_vocab


def make_task(num_topics: int, words_per_passage: int, seed: int = 0
              ) -> Tuple[List[str], List[str]]:
    """(queries, passages), one of each a topic: each topic owns a
    disjoint set of content words; the query uses a sampled subset of its
    topic's words."""
    rng = np.random.default_rng(seed)
    vocab = np.array(BASE_WORDS + [f"word{i:05d}" for i in range(25_000)])
    perm = rng.permutation(len(vocab))
    per_topic = 24
    topics = [perm[i * per_topic:(i + 1) * per_topic]
              for i in range(num_topics)]
    passages, queries = [], []
    for t in topics:
        p_words = vocab[rng.choice(t, size=words_per_passage)]
        q_words = vocab[rng.choice(t, size=6, replace=False)]
        passages.append(" ".join(p_words))
        queries.append("which passage talks about " + " ".join(q_words))
    return queries, passages


def write_train_file(path: str, queries: List[str], passages: List[str]
                     ) -> None:
    """The training rows, in the DPR schema: each query's positive is its
    topic's passage, its hard negative another topic's."""
    n = len(queries)
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for i, q in enumerate(queries):
            j = (i + 1 + int(rng.integers(0, n - 2))) % n
            f.write(json.dumps({
                "question": q, "answers": [],
                "positive_ctxs": [{"text": passages[i]}],
                "negative_ctxs": [],
                "hard_negative_ctxs": [{"text": passages[j]}],
            }) + "\n")


def device_label(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def demo_config(layers: int, hidden: int):
    """The demo's bi-encoder: one VDR encoder of ``layers`` x ``hidden``
    over the 30,522-id vocabulary. ``norm`` and the trainer's 0.05
    temperature are the JAX demo's: the elu1p scores of random weights are
    large and saturate the softmax; L2-normed scores give a healthy
    contrastive gradient."""
    from ..retriever import RetrieverConfig

    enc = {"type": "vdr", "model_id": "demo", "max_len": 64,
           "topk": 128, "shift_vocab_num": 999, "vocab_size": 30522,
           "norm": True, "hidden_size": hidden, "num_hidden_layers": layers,
           "num_attention_heads": max(2, hidden // 64),
           "intermediate_size": 4 * hidden, "max_position_embeddings": 128}
    return RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                           shared_encoder=True)


def make_retriever(layers: int, hidden: int, tokenizer, device):
    """The demo's retriever on ``device``, from the JAX package's
    initialization (``init_jax_weights``, seed 0), as the JAX demo starts:
    from BERT's N(0, 0.02), the port's default, the random model already
    matches the topics' words and the run would show no learning
    (``tests/test_torch_tools.py::test_demo_initialization``)."""
    from ..models.bert import init_jax_weights
    from ..retriever import Retriever

    retriever = Retriever(demo_config(layers, hidden), tokenizer=tokenizer,
                          device=device)
    init_jax_weights(retriever.encoder_q.module,
                     torch.Generator(device=retriever.device).manual_seed(0))
    return retriever


def top1(retriever, queries: List[str], passages: List[str],
         index_type: str = "sparse", rerank: bool = False) -> float:
    """Share of queries whose first hit is their own topic's passage, by
    alpha search over a ``"sparse"`` index or beta search with rerank
    over a ``"bag_of_token"`` one."""
    retriever.build_index(passages, index_type=index_type, batch_size=64)
    res = retriever.retrieve(queries, k=10 if rerank else 1, rerank=rerank,
                             batch_size=64)
    return float(np.mean(np.asarray(res.ids)[:, 0]
                         == np.arange(len(queries))))


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-topics", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=None,
                    help="training output dir (default: a temporary "
                         "directory, removed at the end)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    setup_logging()

    from ..data import BiEncoderDataset
    from ..device import resolve_device
    from ..tokenization.native import NativeWordPieceTokenizer
    from ..train.trainer import RetrieverTrainer, TrainConfig

    dev = resolve_device(args.device)
    tok = NativeWordPieceTokenizer(build_wordpiece_vocab())
    queries, passages = make_task(args.num_topics, words_per_passage=48)
    out_dir = args.out or tempfile.mkdtemp(prefix="train_demo_")
    try:
        os.makedirs(out_dir, exist_ok=True)
        train_path = os.path.join(out_dir, "train.jsonl")
        write_train_file(train_path, queries, passages)

        retriever = make_retriever(args.layers, args.hidden, tok, dev)
        acc_before = top1(retriever, queries, passages)
        tcfg = TrainConfig(
            batch_size=args.batch_size, num_train_epochs=args.epochs,
            learning_rate=args.lr, num_warmup_epochs=1, temperature=0.05,
            num_epoch_to_save=1000, hard_negatives=1, other_negatives=0,
            log_batch_step=10_000, train_rolling_loss_step=10_000,
            output_dir=out_dir, seed=7)
        trainer = RetrieverTrainer(retriever, tcfg,
                                   [BiEncoderDataset(train_path)])
        t0 = time.perf_counter()
        trainer.run_train()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        steps = int(trainer.state.step)
        acc_after = top1(retriever, queries, passages)
        # beta search: the tokenizer-only binary index and the rerank,
        # the semi-parametric path the 4-term loss trains for
        acc_beta = top1(retriever, queries, passages, "bag_of_token",
                        rerank=True)
    finally:
        if args.out is None:
            shutil.rmtree(out_dir, ignore_errors=True)
    out = {
        "metric": "train_demo",
        "steps": steps,
        "train_seconds": train_s,
        "steps_per_s": steps / train_s,
        "queries_per_s": steps * args.batch_size / train_s,
        "top1_before": acc_before,
        "top1_after": acc_after,
        "top1_beta_after": acc_beta,
        "num_topics": args.num_topics,
        "model": f"{args.layers}L-{args.hidden}H-30522V",
        "device": device_label(dev),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
