"""Batch creation: samples -> fixed-shape token arrays (a copy of
``vsearch_tpu/data/batching.py``).

Counterpart of reference src/ir/utils/biencoder_utils.py:20-95, with the
same passage layout ([N positives] + [negatives, sample-major]) but
static-shape padding to the encoder max_len so the train step compiles
once.
"""
from __future__ import annotations

import random
from typing import List, NamedTuple, Optional

import numpy as np

from .dataset import BiEncoderSample


class BiEncoderBatch(NamedTuple):
    q_tensor: np.ndarray  # [N, Lq] int32
    p_tensor: np.ndarray  # [N*(1+negs), Lp] int32
    q_texts: List[str]
    p_texts: List[str]
    answers: List[List[str]]


def _encode_fixed(tokenizer, text: str, max_len: int,
                  pair: Optional[str] = None) -> np.ndarray:
    if pair is not None:
        # title/text pair joined exactly like encode_corpus
        # (reference biencoder.py:105)
        ids = tokenizer.encode(f"{text} [SEP] {pair}", max_length=max_len)
    else:
        ids = tokenizer.encode(text, max_length=max_len)
    out = np.zeros(max_len, dtype=np.int32)
    out[: len(ids)] = ids[:max_len]
    return out


def create_biencoder_batch(
        tokenizer_q, tokenizer_p, samples: List[BiEncoderSample],
        q_max_len: int = 256, p_max_len: int = 256,
        insert_title: bool = False, num_hard_negatives: int = 0,
        num_other_negatives: int = 0, shuffle: bool = True,
        shuffle_positives: bool = False,
        rng: Optional[random.Random] = None) -> BiEncoderBatch:
    """Pick one positive + n negatives per sample, tokenize to fixed
    shapes (reference biencoder_utils.py:20-95). Every sample must
    contribute the same number of negatives for the static layout; short
    pools wrap around."""
    rng = rng or random.Random()
    answers, q_rows, p_pos_rows, p_neg_rows = [], [], [], []
    q_texts, p_pos_texts, p_neg_texts = [], [], []

    num_negs = num_hard_negatives + num_other_negatives
    for si, sample in enumerate(samples):
        if shuffle and shuffle_positives:
            positive = sample.positive_passages[
                rng.randrange(len(sample.positive_passages))]
        else:
            positive = sample.positive_passages[0]
        neg_ctxs = list(sample.negative_passages)
        hard_negs = list(sample.hard_negative_passages)
        if shuffle:
            rng.shuffle(neg_ctxs)
            rng.shuffle(hard_negs)

        chosen = []
        for pool, want in ((neg_ctxs, num_other_negatives),
                           (hard_negs, num_hard_negatives)):
            if want and pool:
                reps = -(-want // len(pool))  # wrap short pools
                chosen.extend((pool * reps)[:want])
        # a sample with no negatives pads from OTHER samples' negative
        # pools: using any in-batch positive (its own or another
        # sample's) would duplicate a softmax target row, capping that
        # query's probability at 0.5 and pushing the gradient AGAINST
        # its true positive every step. Only a batch with no negatives
        # anywhere falls back to the (self-colliding) own positive.
        if len(chosen) < num_negs:
            donor_pool = [ctx for s in samples
                          if s is not sample
                          for ctx in (list(s.hard_negative_passages)
                                      + list(s.negative_passages))]
            fi = 0
            while len(chosen) < num_negs:
                if donor_pool:
                    chosen.append(donor_pool[fi % len(donor_pool)])
                    fi += 1
                else:
                    chosen.append(positive)

        q_rows.append(_encode_fixed(tokenizer_q, sample.query, q_max_len))
        if insert_title and positive.title:
            p_pos_rows.append(_encode_fixed(
                tokenizer_p, positive.title, p_max_len, pair=positive.text))
        else:
            p_pos_rows.append(_encode_fixed(
                tokenizer_p, positive.text, p_max_len))
        for ctx in chosen:
            if insert_title and ctx.title:
                p_neg_rows.append(_encode_fixed(
                    tokenizer_p, ctx.title, p_max_len, pair=ctx.text))
            else:
                p_neg_rows.append(_encode_fixed(
                    tokenizer_p, ctx.text, p_max_len))
        answers.append(list(sample.answers))
        q_texts.append(sample.query)
        p_pos_texts.append(positive.text)
        p_neg_texts.extend(c.text for c in chosen)

    return BiEncoderBatch(
        q_tensor=np.stack(q_rows),
        p_tensor=np.stack(p_pos_rows + p_neg_rows),
        q_texts=q_texts,
        p_texts=p_pos_texts + p_neg_texts,
        answers=answers,
    )
