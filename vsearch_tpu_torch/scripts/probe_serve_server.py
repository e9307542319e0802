"""The serve target of ``probe_serve_load`` (counterpart of
``scripts/probe_serve_server.py``).

    python -m vsearch_tpu_torch.scripts.probe_serve_server [--port 0]
        [--num-passages 200000] [--device cpu]

A BERT-base VDR retriever (one shared encoder, 128 tokens, bf16, random
weights from ``--seed``) over a bag-of-token index of ``--num-passages``
synthetic passages (``bench.py``'s corpus: 80 Zipf-drawn words a passage
over its word list and 25,000 synthetic words), served over HTTP by the
port's ``serve`` (coalescing unless ``--no-coalesce``). Once every
coalescer batch size the load can reach is warm it prints ``READY
<port>`` (``--port 0`` takes a free one) and serves until SIGTERM.
"""
from __future__ import annotations

import signal
import sys
import threading
import time

import numpy as np

from ..cli.common import add_device_arg
from ..examples.synthetic_vocab import BASE_WORDS, build_wordpiece_vocab


def make_corpus(n: int, words_per_passage: int = 80, seed: int = 0):
    """``bench.py``'s synthetic passages: Zipf(1) draws over its word list
    and 25,000 synthetic words."""
    rng = np.random.default_rng(seed)
    vocab = np.array(list(BASE_WORDS) + [f"word{i:05d}"
                                         for i in range(25_000)])
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    idx = rng.choice(len(vocab), size=(n, words_per_passage),
                     p=probs / probs.sum())
    return [" ".join(row) for row in vocab[idx]]


def add_model_args(ap) -> None:
    """The encoder's widths (BERT-base by default) and the corpus size,
    shared with ``probe_serve_load``, which passes them on."""
    ap.add_argument("--num-passages", type=int, default=200_000)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--intermediate", type=int, default=3072)
    ap.add_argument("--warmup-max", type=int, default=256,
                    help="the largest batch warmed (rerank: up to 32)")


def build(args):
    """The retriever with its index built."""
    from ..retriever import Retriever, RetrieverConfig
    from ..tokenization.native import NativeWordPieceTokenizer

    # the C++ tokenizer over the synthetic vocabulary, as bench.py's
    tok = NativeWordPieceTokenizer(build_wordpiece_vocab())
    enc = {"type": "vdr", "max_len": 128, "topk": 768,
           "shift_vocab_num": 999, "vocab_size": tok.vocab_size,
           "hidden_size": args.hidden, "num_hidden_layers": args.layers,
           "num_attention_heads": args.heads,
           "intermediate_size": args.intermediate,
           "max_position_embeddings": 512, "dtype": "bfloat16"}
    cfg = RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                          shared_encoder=True)
    retriever = Retriever(cfg, tokenizer=tok, seed=args.seed,
                          device=args.device)
    corpus = make_corpus(args.num_passages, seed=args.seed)
    retriever.build_index(corpus, batch_size=256, index_type="bag_of_token")
    return retriever, corpus


def main(argv=None) -> None:
    import argparse

    from ..serve import serve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--no-coalesce", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    add_model_args(ap)
    args = ap.parse_args(argv)
    retriever, corpus = build(args)
    srv = serve(retriever, host="127.0.0.1", port=args.port, default_k=100,
                coalesce=not args.no_coalesce)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    # warm every coalescer batch the load's phases can reach
    service = srv.service
    qs = [" ".join(c.split()[:12]) for c in corpus[:256]]
    t0 = time.time()
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        if b <= args.warmup_max:
            service.search(qs[:b], k=100, rerank=False)
    for b in (1, 2, 4, 8, 16, 32):
        if b <= args.warmup_max:
            service.search(qs[:b], k=100, rerank=True)
    print(f"# warmup {time.time() - t0:.1f}s", file=sys.stderr, flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"READY {srv.server_address[1]}", flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()


if __name__ == "__main__":
    main()
