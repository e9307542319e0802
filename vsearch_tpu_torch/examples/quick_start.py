"""Quick start on the port (counterpart of the repo's
``examples/quick_start.py``).

    python -m vsearch_tpu_torch.examples.quick_start [--checkpoint DIR]
        [--device cuda|cpu]

With a checkpoint directory (the HF layout of ``save_pretrained`` or a
reference torch checkpoint), embeds a query and a few passages, scores
them, runs alpha search over a ``"sparse"`` index and beta search with
rerank over a ``"bag_of_token"`` index, and prints token-level
attributions. Without one it uses a tiny random VDR retriever over the
synthetic vocabulary, so it always runs end to end.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from ..cli.common import add_device_arg

QUERY = "what is green tea good for"
PASSAGES = [
    "green tea is a drink with many benefits",
    "the red planet mars has ice water on the surface",
    "einstein wrote the famous theory of relativity",
]


def make_tiny_retriever(device="cuda", seed: int = 0):
    """A tiny random VDR retriever (``BertConfig.tiny``, one shared
    encoder) over the synthetic 30,522-entry WordPiece vocabulary, with
    the JAX quick start's encoder settings."""
    from ..models.bert import BertConfig
    from ..retriever import Retriever, RetrieverConfig
    from ..tokenization.wordpiece import WordPieceTokenizer
    from .synthetic_vocab import build_wordpiece_vocab

    tok = WordPieceTokenizer(build_wordpiece_vocab())
    bert = BertConfig.tiny(tok.vocab_size)
    enc = {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
           **{k: getattr(bert, k) for k in (
               "vocab_size", "hidden_size", "num_hidden_layers",
               "num_attention_heads", "intermediate_size",
               "max_position_embeddings")}}
    cfg = RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                          shared_encoder=True)
    return Retriever(cfg, tokenizer=tok, seed=seed, device=device)


def run(ir) -> Dict[str, Any]:
    """The quick start's calls on a retriever; prints its four lines and
    returns the embeddings ``q_emb`` [1, V] and ``p_emb`` [3, V],
    ``scores`` [1, 3], the ``alpha`` and ``beta`` search results and the
    ``explain`` top 5 (token -> weight)."""
    q_emb = ir.encoder_q.embed([QUERY])
    p_emb = ir.encoder_p.embed(PASSAGES)
    scores = q_emb @ p_emb.T
    print("scores:", scores.round(4))

    ir.build_index(PASSAGES, index_type="sparse")
    alpha = ir.retrieve([QUERY], k=3)
    print("alpha search ids:", np.asarray(alpha.ids)[0].tolist())

    ir.build_index(PASSAGES, index_type="bag_of_token")
    beta = ir.retrieve([QUERY], k=3, rerank=True)
    print("beta search ids:", np.asarray(beta.ids)[0].tolist())

    top = dict(list(ir.explain(QUERY, PASSAGES[0], topk=32).items())[:5])
    print("top attributions:", top)
    return {"q_emb": q_emb, "p_emb": p_emb, "scores": scores,
            "alpha": alpha, "beta": beta, "explain": top}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default=None,
                    help="HF-layout checkpoint dir (save_pretrained's, or "
                         "a reference torch checkpoint)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.checkpoint:
        from ..retriever import Retriever

        ir = Retriever.from_pretrained(args.checkpoint, device=args.device)
    else:
        print("(no checkpoint given; using a tiny random model)")
        ir = make_tiny_retriever(args.device)
    return run(ir)


if __name__ == "__main__":
    main()
