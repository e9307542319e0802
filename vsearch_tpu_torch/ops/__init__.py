"""Vocabulary-space math and the bit-packed CUDA kernels (layer 0)."""
from .activations import elu1p
from .ell import (ELLMatrix, ell_from_topk, ell_matvec_chunked,
                  ell_matvec_scores, ell_row_block_scores)
from .search import dense_topk_search, merge_shard_topk, top_k, topk_from_scores
from .sparse import build_bow_mask, build_topk_mask, topk_sparsify

__all__ = [
    "elu1p",
    "build_topk_mask",
    "topk_sparsify",
    "build_bow_mask",
    "ELLMatrix",
    "ell_from_topk",
    "ell_matvec_chunked",
    "ell_matvec_scores",
    "ell_row_block_scores",
    "dense_topk_search",
    "merge_shard_topk",
    "top_k",
    "topk_from_scores",
]
