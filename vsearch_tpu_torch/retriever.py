"""Retriever: the top-level user API (embed, index, search, rerank)
(counterpart of ``vsearch_tpu/retriever.py``).

Bi-encoder + dense / sparse / bag-of-token index; alpha (parametric)
search (through the binary-support proxy on large sparse indexes), dense
(DPR) search, cross-modal text <-> image search, and beta
(semi-parametric: binary first stage + on-the-fly rerank) search;
tokenizer-only BoT index construction; checkpoints through the
bi-encoder's ``save_pretrained``/``from_pretrained``; negative mining
for training (``retrieve_negatives``).
"""
from __future__ import annotations

import dataclasses
import random as pyrandom
import unicodedata
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .biencoder import BiEncoder, BiEncoderConfig, join_corpus, takes_images
from .eval.qa_utils import has_answer
from .index import (BoTIndex, DenseIndex, IndexType, SearchResults,
                    SparseIndex)
from .utils.profiling import TRACER


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
        self._timings: Dict[str, float] = {}

    @property
    def last_timings(self) -> Dict[str, float]:
        """The call record (``utils.profiling.Tracer``) of the device call
        that ran the last ``retrieve``: host seconds of each stage,
        ``query_embed``, ``first_stage`` and, with the rerank, ``rerank``
        (every stage ends in a device->host copy, so its clock covers its
        device work), and of each span under them (``<stage>/<child>``,
        repeated children summed); called through the serving layer's
        coalescer, also ``serve/queue_wait``."""
        return self._timings

    def to_mesh(self, mesh, axis_name: str = "dp"):
        """Serve over a device mesh: the index rows shard (per-shard top-k,
        one merge on the mesh's first device), and the beta rerank's
        candidate embeds split over the same devices, rescored on the
        first one."""
        if self.index is not None and hasattr(self.index, "to_mesh"):
            self.index.to_mesh(mesh, axis_name)
        for enc in {id(self.encoder_q): self.encoder_q,
                    id(self.encoder_p): self.encoder_p}.values():
            if hasattr(enc, "to_mesh"):
                enc.to_mesh(mesh, axis_name)
        return self

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
        with TRACER.call("retrieve"):
            with TRACER.span("query_embed"):
                q_emb = self.process_query(queries, dropout, a,
                                           batch_size=batch_size, rng=rng)
            with TRACER.span("first_stage"):
                results = index.search(q_emb, k=k)
            if rerank and index.index_type == IndexType.BAG_OF_TOKEN:
                with TRACER.span("rerank"):
                    results = self._beta_rerank(q_emb, results, index,
                                                batch_size)
            self._timings = TRACER.record()
        return results

    def _beta_rerank(self, q_emb: np.ndarray, results: SearchResults,
                     index, batch_size: int) -> SearchResults:
        """Second stage of beta search: embed the retrieved texts once each
        (deduplicated across queries, length-sorted into batches) and
        rescore them: in compact sparse form on the device for encoders
        with ``embed_sparse``, from dense embeddings on the host for the
        others (DPR, cross-modal text), as the JAX package does."""
        ret_ids = np.asarray(results.ids)  # [B, k]
        b, k = ret_ids.shape  # the index may have clamped k to its rows
        with TRACER.span("fetch"):
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
        q32 = np.ascontiguousarray(q_emb, dtype=np.float32)
        # the encoder's tokenize / forward / to_host spans nest here
        if hasattr(self.encoder_p, "embed_sparse"):
            cols, vals = self.encoder_p.embed_sparse(
                ret_texts, batch_size=batch_size, activate_lexical=True,
                return_device=True)
            with TRACER.span("rescore"):
                scores = _sparse_rerank_scores(cols, vals, inverse, b, k,
                                               q32)
            with TRACER.span("to_host"):
                rescored = scores.cpu().numpy()
        else:  # dense passage embeddings, rescored on the host
            p_emb = self.encoder_p.embed(ret_texts, batch_size=batch_size)
            with TRACER.span("rescore"):
                rescored = np.einsum("bkv,bv->bk", p_emb[inverse].reshape(
                    b, k, -1).astype(np.float32), q32)
        order = np.argsort(-rescored, axis=1)
        return SearchResults(np.take_along_axis(ret_ids, order, axis=1),
                             np.take_along_axis(rescored, order, axis=1))

    # -- negative mining (reference retriever.py:150-205) --------------------
    def retrieve_negatives(self, q_emb, answers: List[List[str]],
                           ret_neg_num: int = 1, ret_topk: int = 100,
                           pool_size: int = 20, ret_dropout: float = 0.0,
                           index=None, seed: Optional[int] = None
                           ) -> List[List[str]]:
        """Mine in-training negatives: retrieve top-k, drop
        answer-containing passages, sample ``ret_neg_num`` per query.
        With equal index, queries, answers and ``seed`` it picks the JAX
        package's negatives (the same first stage, then Python's
        ``random.Random(seed)``)."""
        index = index if index is not None else self.index
        if index is None:
            raise ValueError("no index found")
        if not answers:
            raise ValueError("no answer strings found")
        if not (isinstance(q_emb, str) or (
                isinstance(q_emb, list) and q_emb
                and isinstance(q_emb[0], str))):
            # embeddings normalize to an array; string queries reach
            # process_query untouched
            q_emb = np.asarray(q_emb)
        # the seed covers BOTH the sampling below and the query-dropout rng
        results = self.retrieve(
            q_emb, a=768, k=ret_topk, dropout=ret_dropout, index=index,
            rng=np.random.default_rng(seed) if seed is not None else None)
        rnd = pyrandom.Random(seed)
        batch_neg_texts: List[List[str]] = []
        for sample_id, sample_ret in enumerate(np.asarray(results.ids)):
            pool: List[int] = []
            for ret_ind in sample_ret.tolist():
                text = _passage_text(index.get_sample(ret_ind))
                if not has_answer(answers[sample_id], text, "string"):
                    pool.append(ret_ind)
                if len(pool) >= pool_size:
                    break
            if len(pool) < ret_neg_num:
                pad = ret_neg_num - len(pool)
                pool += rnd.sample(range(len(index)), pad)
            chosen = rnd.sample(pool, ret_neg_num)
            batch_neg_texts.append(
                [_normalize_text(_passage_text(index.get_sample(i)))
                 for i in chosen])
        return batch_neg_texts

    # the reference's public spelling, kept as an alias
    retireve_negatives = retrieve_negatives

    # -- index building ------------------------------------------------------
    def build_index(self, texts: Sequence[Any], batch_size: int = 32,
                    index_type: Union[str, IndexType] = IndexType.DENSE,
                    max_len: Optional[int] = None):
        if isinstance(index_type, str):
            index_type = IndexType(index_type.lower())
        if not takes_images(self.encoder_p):
            texts = list(texts)
        if index_type == IndexType.DENSE:
            index = DenseIndex(device=self.device)
            index.set_vectors(self.encode_corpus(
                texts, batch_size=batch_size, max_len=max_len))
        elif index_type == IndexType.SPARSE:
            from .ops.ell import ELLMatrix, ell_from_topk

            index = SparseIndex(device=self.device)
            if hasattr(self.encoder_p, "embed_sparse"):
                cols, vals = self.encoder_p.embed_sparse(
                    join_corpus(texts), batch_size=batch_size,
                    max_len=max_len)
                ell = ell_from_topk(cols, vals, self.encoder_p.config.out_dim,
                                    device=self.device)
            else:  # dense embeddings (cross-modal encoders) -> ELL rows
                ell = ELLMatrix.from_dense(
                    self.encode_corpus(texts, batch_size=batch_size,
                                       max_len=max_len),
                    val_dtype=np.float32, device=self.device)
            index.set_ell(ell)
        elif index_type == IndexType.BAG_OF_TOKEN:
            from .index.bot_build import build_bot_ell

            index = BoTIndex(device=self.device)
            tokenizer = self.encoder_p.tokenizer
            index.set_ell(build_bot_ell(
                tokenizer, join_corpus(texts), max_len=max_len or 128,
                shift=getattr(self.encoder_p.config, "shift_vocab_num", 0),
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
    # a copy from pageable host memory waits for the device's stream, so
    # this is where the host waits for the candidates' embeds
    with TRACER.span("upload"):
        inv = torch.from_numpy(inverse.astype(np.int64).reshape(b, k)
                               ).to(dev)
        q = torch.from_numpy(q32).to(dev)
    v_dim = q.shape[1]
    qpad = F.pad(q, (0, 1))  # [b, V+1]
    c = cols[inv].long().clamp_max(v_dim)  # [b, k, kk]
    g = torch.gather(qpad[:, None, :].expand(b, k, v_dim + 1), 2, c)
    return (g * vals[inv].float()).sum(dim=2)


def _normalize_text(text: str) -> str:
    """Unicode-quote/newline normalization applied to passages
    (reference: src/ir/data/biencoder_dataset.py:27-29)."""
    text = text.replace("’", "'").replace("\n", " ")
    return unicodedata.normalize("NFD", text)


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
