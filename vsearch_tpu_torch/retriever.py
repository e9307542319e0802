"""Retriever: the top-level user API (embed, index, search, rerank)
(counterpart of ``vsearch_tpu/retriever.py``).

Bi-encoder + dense / sparse / bag-of-token index; alpha (parametric)
search and beta (semi-parametric: binary first stage + on-the-fly
rerank) search; tokenizer-only BoT index construction. Negative mining
for training comes with the training slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .biencoder import BiEncoder, BiEncoderConfig, join_corpus
from .index import (BoTIndex, DenseIndex, IndexType, SearchResults,
                    SparseIndex)


@dataclasses.dataclass
class RetrieverConfig(BiEncoderConfig):
    pass


class Retriever(BiEncoder):
    """Bi-encoder with an attached index."""

    config_class = RetrieverConfig

    def __init__(self, config: RetrieverConfig, index=None, **kwargs):
        super().__init__(config, **kwargs)
        self.index = index
        self.index_type: Optional[IndexType] = (
            index.index_type if index is not None else None)
        # host seconds of each stage of the last retrieve(); every stage
        # ends in a device->host copy, so the clock covers device work
        self.last_timings: Dict[str, float] = {}

    # -- query processing --------------------------------------------------
    def process_query(self, queries, dropout: float = 0.0,
                      a: Optional[int] = None, batch_size: int = 32,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
        num_activation = (a if a is not None
                          else getattr(self.encoder_q.config, "topk", None))
        if isinstance(queries, str) or (
                isinstance(queries, list) and queries
                and isinstance(queries[0], str)):
            q_emb = self.encoder_q.embed(queries, batch_size=batch_size,
                                         topk=num_activation)
        else:
            q_emb = np.asarray(queries, dtype=np.float32)
        if dropout:
            rng = rng or np.random.default_rng()
            keep = rng.random(q_emb.shape) >= dropout
            q_emb = q_emb * keep / (1.0 - dropout)
        return np.asarray(q_emb)

    # -- retrieval -----------------------------------------------------------
    def retrieve(self, queries, k: int = 5, dropout: float = 0.0,
                 a: Optional[int] = None, index=None, rerank: bool = False,
                 batch_size: int = 32, rng=None) -> SearchResults:
        """Top-k retrieval; ``rerank=True`` runs beta search on a
        bag-of-token index: first-stage binary-index hits are re-embedded
        on the fly and re-scored parametrically."""
        index = index if index is not None else self.index
        if index is None:
            raise ValueError("no index attached: build_index or "
                             "load_index first, or pass index=")
        t0 = time.perf_counter()
        q_emb = self.process_query(queries, dropout, a,
                                   batch_size=batch_size, rng=rng)
        t1 = time.perf_counter()
        results = index.search(q_emb, k=k)
        t2 = time.perf_counter()
        self.last_timings = {"query_embed": t1 - t0, "first_stage": t2 - t1}
        if rerank and index.index_type == IndexType.BAG_OF_TOKEN:
            results = self._beta_rerank(q_emb, results, index, batch_size)
            self.last_timings["rerank"] = time.perf_counter() - t2
        return results

    def _beta_rerank(self, q_emb: np.ndarray, results: SearchResults,
                     index, batch_size: int) -> SearchResults:
        """Second stage of beta search: embed the retrieved texts once each
        (deduplicated across queries, length-sorted into batches), keep
        them on the device in compact sparse form, and rescore there."""
        ret_ids = np.asarray(results.ids)  # [B, k]
        b, k = ret_ids.shape  # the index may have clamped k to its rows
        uniq_ids, inverse = np.unique(ret_ids.reshape(-1),
                                      return_inverse=True)
        ret_texts = [_passage_embed_text(index.get_sample(int(i)))
                     for i in uniq_ids]
        # length-sort so each embed batch lands in the smallest length
        # bucket; the inverse map composes the sort away
        sort_perm = np.argsort([len(t.split()) for t in ret_texts],
                               kind="stable")
        ret_texts = [ret_texts[int(i)] for i in sort_perm]
        inverse = np.argsort(sort_perm, kind="stable")[inverse]
        cols, vals = self.encoder_p.embed_sparse(
            ret_texts, batch_size=batch_size, activate_lexical=True,
            return_device=True)
        rescored = _sparse_rerank_scores(
            cols, vals, inverse, b, k,
            np.ascontiguousarray(q_emb, dtype=np.float32)).cpu().numpy()
        order = np.argsort(-rescored, axis=1)
        return SearchResults(np.take_along_axis(ret_ids, order, axis=1),
                             np.take_along_axis(rescored, order, axis=1))

    # -- index building ------------------------------------------------------
    def build_index(self, texts: Sequence[Any], batch_size: int = 32,
                    index_type: Union[str, IndexType] = IndexType.DENSE,
                    max_len: Optional[int] = None):
        if isinstance(index_type, str):
            index_type = IndexType(index_type.lower())
        texts = list(texts)
        if index_type == IndexType.DENSE:
            index = DenseIndex(device=self.device)
            index.set_vectors(self.encode_corpus(
                texts, batch_size=batch_size, max_len=max_len))
        elif index_type == IndexType.SPARSE:
            from .ops.ell import ell_from_topk

            index = SparseIndex(device=self.device)
            cols, vals = self.encoder_p.embed_sparse(
                join_corpus(texts), batch_size=batch_size, max_len=max_len)
            index.set_ell(ell_from_topk(cols, vals,
                                        self.encoder_p.config.out_dim,
                                        device=self.device))
        elif index_type == IndexType.BAG_OF_TOKEN:
            from .index.bot_build import build_bot_ell

            index = BoTIndex(device=self.device)
            tokenizer = self.encoder_p.tokenizer
            index.set_ell(build_bot_ell(
                tokenizer, join_corpus(texts), max_len=max_len or 128,
                shift=self.encoder_p.config.shift_vocab_num,
                vocab_size=tokenizer.vocab_size,
                device=self.device))
        else:
            raise NotImplementedError(index_type)
        index.data = texts
        self.index = index
        self.index_type = index_type
        return index

    # -- persistence ---------------------------------------------------------
    def save_index(self, path: str):
        self.index.save(path)

    def load_index(self, index_file: Optional[str] = None,
                   data_file: Optional[str] = None,
                   index_type: Union[None, str, IndexType] = None,
                   search_mode: Optional[str] = None):
        """Load an index written by either package; the type is inferred
        from the file name unless given."""
        if index_file is None:
            raise ValueError(
                "load_index requires index_file (a path or glob)")
        if index_type is None:
            if index_file.endswith(".pt") or index_file.endswith(".npy"):
                index_type = IndexType.DENSE
            elif index_file.endswith(".bot.npz"):
                index_type = IndexType.BAG_OF_TOKEN
            elif index_file.endswith(".ell.npz"):
                # native ELL archives without values are bag-of-token
                from .index.base import _resolve_files

                with np.load(_resolve_files(index_file)[0]) as z:
                    index_type = (IndexType.SPARSE if "vals" in z.files
                                  else IndexType.BAG_OF_TOKEN)
            elif index_file.endswith(".npz"):
                index_type = IndexType.SPARSE
            else:
                raise ValueError(
                    "cannot infer index type from file extension; pass "
                    "index_type explicitly")
        elif isinstance(index_type, str):
            index_type = IndexType(index_type.lower())
        elif not isinstance(index_type, IndexType):
            raise TypeError("index_type must be IndexType or str")
        self.index_type = index_type
        mode = {} if search_mode is None else {"search_mode": search_mode}
        if index_type == IndexType.DENSE:
            if search_mode is not None:
                raise ValueError(
                    "search_mode applies to sparse/bag-of-token "
                    "indexes; dense indexes always score exactly")
            self.index = DenseIndex(index_file, data_file,
                                    device=self.device)
        elif index_type == IndexType.SPARSE:
            self.index = SparseIndex(index_file, data_file,
                                     device=self.device, **mode)
        elif index_type == IndexType.BAG_OF_TOKEN:
            self.index = BoTIndex(index_file, data_file,
                                  device=self.device, **mode)
        else:
            raise NotImplementedError(index_type)
        return self.index


def _sparse_rerank_scores(cols: torch.Tensor, vals: torch.Tensor,
                          inverse: np.ndarray, b: int, k: int,
                          q32: np.ndarray) -> torch.Tensor:
    """On-device beta-rerank rescoring, [b, k] f32.

    ``cols``/``vals`` are the deduplicated candidates in compact sparse
    form on the device (rows past the real count are padding);
    ``inverse`` maps each (query, slot) to its candidate row. Sentinel
    columns (== V) hit the zero pad column of the query."""
    dev = cols.device
    inv = torch.from_numpy(inverse.astype(np.int64).reshape(b, k)).to(dev)
    q = torch.from_numpy(q32).to(dev)
    v_dim = q.shape[1]
    qpad = F.pad(q, (0, 1))  # [b, V+1]
    c = cols[inv].long().clamp_max(v_dim)  # [b, k, kk]
    g = torch.gather(qpad[:, None, :].expand(b, k, v_dim + 1), 2, c)
    return (g * vals[inv].float()).sum(dim=2)


def _passage_text(sample: Any) -> str:
    """Extract text from an index data record (str or jsonl dict)."""
    if isinstance(sample, str):
        return sample
    if isinstance(sample, dict):
        return sample.get("text") or sample.get("contents") or ""
    return str(sample)


def _passage_embed_text(sample: Any) -> str:
    """The string the index embedded for this record: dict corpora are
    built as "title [SEP] text", so the rerank re-embeds the same."""
    if isinstance(sample, dict) and sample.get("title"):
        return f"{sample['title']} [SEP] {_passage_text(sample)}"
    return _passage_text(sample)
