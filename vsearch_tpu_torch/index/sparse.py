"""Sparse (ELL) and bag-of-token indexes (counterpart of
``vsearch_tpu/index/sparse.py``).

Scoring paths: exact chunked gather for real-valued sparse indexes, and
for binary bag-of-token indexes the bit-packed CUDA kernels at every
size when the index lives on the card (``ops.bitpack``; fused bucketed
selection above 131,072 rows). The JAX package's other routes — the
binary-support proxy for large real-valued indexes and the block /
stream tiers for packed matrices over the device budget — are not ported
yet. On-disk formats are the JAX package's: scipy-compatible f16 CSR
``.npz`` and the native ``.ell.npz``, readable and writable both ways.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..ops.ell import ELLMatrix
from .base import (DenseIndex, IndexType, SearchResults, _resolve_files,
                   _results)

logger = logging.getLogger(__name__)


class SparseIndex(DenseIndex):
    """Sparse vocab-space index over an ELLMatrix (exact search)."""

    index_type = IndexType.SPARSE
    _binary = False
    _search_modes = ("auto", "exact")

    def __init__(self, index_file: Optional[str] = None,
                 data_file: Optional[str] = None, low_memory: bool = False,
                 shift: int = 0,
                 val_dtype=torch.bfloat16, search_mode: str = "auto",
                 selection: Optional[str] = None, device="cuda"):
        if search_mode not in self._search_modes:
            raise NotImplementedError(
                f"search_mode={search_mode!r} is not ported yet "
                f"(available: {self._search_modes})")
        self.shift = shift
        self.val_dtype = val_dtype
        self.search_mode = search_mode
        if selection is not None:  # else the class default applies
            self.selection = selection
        self.ell: Optional[ELLMatrix] = None
        super().__init__(index_file, data_file, low_memory=low_memory,
                         device=device)

    # -- loading -----------------------------------------------------------
    def init_index(self, index_file: Union[str, Sequence[str]]):
        files = _resolve_files(index_file)
        logger.info("Loading %s index from %d file(s)",
                    self.index_type.value, len(files))
        if all(f.endswith(".ell.npz") for f in files):
            self.set_ell(self._load_native(files))
        else:
            self.set_ell(self._load_scipy(files))

    def _load_scipy(self, files) -> ELLMatrix:
        from scipy.sparse import csr_matrix, load_npz, vstack

        def load_f32(path):
            m = load_npz(path)
            if m.dtype == np.float16:
                # scipy cannot operate on f16 matrices (the reference
                # stores f16 npz): rebuild as f32 via the raw constructor
                m = csr_matrix(
                    (m.data.astype(np.float32), m.indices, m.indptr),
                    shape=m.shape)
            return m

        shards = [load_f32(f) for f in files]
        if self.shift:
            shards = [s[:, self.shift:] for s in shards]
        mat = vstack(shards).tocsr() if len(shards) > 1 else shards[0].tocsr()
        return ELLMatrix.from_scipy_csr(mat, binary=self._binary,
                                        device=self.device)

    def _load_native(self, files) -> ELLMatrix:
        parts = []
        num_cols = sentinel = has_vals = None
        for f in files:
            with np.load(f) as z:
                cols, nnz = z["cols"], z["nnz"]
                vals = z["vals"] if "vals" in z.files else None
                meta = (int(z["num_cols"]),
                        bool(z["sentinel_padded"])
                        if "sentinel_padded" in z.files else False,
                        vals is not None)
                if num_cols is None:
                    num_cols, sentinel, has_vals = meta
                elif meta != (num_cols, sentinel, has_vals):
                    # shards from different builds would corrupt the
                    # merged index (vocab width / sentinel / values)
                    raise ValueError(
                        f"inconsistent index shard {f}: "
                        f"(num_cols, sentinel_padded, has_vals)={meta} "
                        f"vs {(num_cols, sentinel, has_vals)} from "
                        f"{files[0]}")
                parts.append((cols, nnz, vals))
        nnz_pad = max(p[0].shape[1] for p in parts)
        pad_col = num_cols if sentinel else 0
        cols = np.concatenate(
            [np.pad(p[0], ((0, 0), (0, nnz_pad - p[0].shape[1])),
                    constant_values=pad_col) for p in parts])
        nnz = np.concatenate([p[1] for p in parts])
        vals = None
        if parts[0][2] is not None:
            vals = torch.from_numpy(np.concatenate(
                [np.pad(p[2], ((0, 0), (0, nnz_pad - p[2].shape[1])))
                 for p in parts]).astype(np.float32)).to(self.val_dtype)
        return ELLMatrix.from_arrays(cols, nnz, vals, num_cols, sentinel,
                                     self.device)

    def set_ell(self, ell: ELLMatrix):
        self.ell = ell

    def set_vectors(self, mat):
        """Accept a dense or scipy-sparse matrix and convert to ELL."""
        import scipy.sparse as sp

        if sp.issparse(mat):
            ell = ELLMatrix.from_scipy_csr(mat, binary=self._binary,
                                           device=self.device)
        else:
            ell = ELLMatrix.from_dense(np.asarray(mat), binary=self._binary,
                                       device=self.device)
        self.set_ell(ell)

    @property
    def vector(self):  # reference-compat accessor
        return self.ell

    @vector.setter
    def vector(self, v):
        if v is None:
            self.ell = None
        elif isinstance(v, ELLMatrix):
            self.set_ell(v)
        else:
            self.set_vectors(v)

    def __len__(self) -> int:
        if self.data is not None:
            return len(self.data)
        if self._lazy is not None:
            return len(self._lazy)
        return 0 if self.ell is None else self.ell.shape[0]

    # -- search ------------------------------------------------------------
    def search(self, q_embs, k: int) -> SearchResults:
        from ..ops.two_stage import exact_search

        q = self._query_tensor(q_embs, self.ell.num_cols)
        k = min(k, self.ell.shape[0])
        if q.shape[0] == 0:
            return SearchResults(np.zeros((0, k), np.int64),
                                 np.zeros((0, k), np.float32))
        return _results(*exact_search(q, self.ell, k=k))

    # -- persistence -------------------------------------------------------
    def save(self, path: str, native: Optional[bool] = None):
        if native is None:
            native = path.endswith(".ell.npz")
        ell = self.ell
        if native:
            arrays = dict(
                cols=ell.cols.cpu().numpy(),
                nnz=ell.nnz.cpu().numpy(),
                num_cols=np.asarray(ell.num_cols),
                sentinel_padded=np.asarray(ell.sentinel_padded),
            )
            if ell.vals is not None:
                arrays["vals"] = ell.vals.to(torch.float16).cpu().numpy()
            np.savez_compressed(path, **arrays)
        else:
            from scipy.sparse import csr_matrix, save_npz

            csr = ell.to_scipy_csr(dtype=np.float32).tocsr()
            # f16 on disk (reference-compatible) via the raw constructor
            save_npz(path, csr_matrix(
                (csr.data.astype(np.float16), csr.indices, csr.indptr),
                shape=csr.shape))
        logger.info("Index saved to %s", path)

    def __str__(self):
        shape = None if self.ell is None else self.ell.shape
        return (f"Index Type        : {type(self).__name__}\n"
                f"Vector Shape      : {shape}\n"
                f"nnz_pad           : "
                f"{None if self.ell is None else self.ell.nnz_pad}\n"
                f"Number of Texts   : {len(self)}\n")


class BoTIndex(SparseIndex):
    """Bag-of-token binary index: same ELL storage, no values (implicit
    1.0 weights). On the card it scores through the bit-packed CUDA
    kernels (4 KB a row in device memory, exact scores).

    search_mode: 'auto' | 'exact' | 'bitpack'; selection: 'auto' |
    'exact' | 'bucketed'.
    """

    index_type = IndexType.BAG_OF_TOKEN
    _binary = True
    _search_modes = ("auto", "exact", "bitpack")

    # device budget for the packed matrix; above it the JAX package moves
    # to its block / stream tiers, which the port does not have yet
    hbm_budget_bytes: Optional[int] = None  # None -> 12 GiB

    # 'auto' resolves to the fused bucketed kernel above this row count
    # and to exact top-k below it (with only N/8 buckets, top-100 bucket
    # collisions become measurable at small N)
    selection = "auto"
    bucketed_threshold = 131_072
    # 'auto' mode off the card keeps the exact gather path up to here
    exact_threshold = 131_072

    def __init__(self, *args, **kwargs):
        self.bitmat = None
        super().__init__(*args, **kwargs)

    def _resolved_selection(self) -> str:
        if self.selection not in ("auto", "exact", "bucketed"):
            raise NotImplementedError(
                f"selection={self.selection!r} is not ported yet")
        if self.selection != "auto":
            return self.selection
        return ("bucketed" if self.ell.shape[0] > self.bucketed_threshold
                else "exact")

    def _packed_bytes(self, n: Optional[int] = None,
                      v: Optional[int] = None) -> int:
        """Device footprint of the bit-packed matrix (4 KB/row at V~30k)."""
        n = self.ell.shape[0] if n is None else n
        v = self.ell.num_cols if v is None else v
        n_pad = -(-n // 1024) * 1024
        vp = -(-v // 4096) * 4096
        return n_pad * (vp // 8)

    def _budget(self) -> int:
        if self.hbm_budget_bytes is not None:
            return self.hbm_budget_bytes
        return 12 << 30

    def _use_bitpack(self) -> bool:
        if self.search_mode == "bitpack":
            return True
        if self.search_mode != "auto":
            return False
        # the JAX package takes the kernel at every size on the TPU; the
        # port does so whenever the index lives on the card
        if self.ell.cols.is_cuda:
            return True
        return self.ell.shape[0] > self.exact_threshold

    def build_bitpack(self):
        from ..ops.bitpack import pack_ell

        if self.ell.cols.is_cuda and self._packed_bytes() > self._budget():
            raise NotImplementedError(
                f"packed matrix of {self._packed_bytes()} bytes exceeds the "
                f"{self._budget()}-byte device budget; the block/stream "
                "tiers that serve such indexes are not ported yet")
        self.bitmat = pack_ell(self.ell)
        return self.bitmat

    def set_ell(self, ell: ELLMatrix):
        super().set_ell(ell)
        self.bitmat = None

    def search(self, q_embs, k: int) -> SearchResults:
        if not self._use_bitpack():
            return super().search(q_embs, k)
        from ..ops.bitpack import bitpack_bucketed_topk, bitpack_topk_search

        q = self._query_tensor(q_embs, self.ell.num_cols)
        k = min(k, self.ell.shape[0])
        if q.shape[0] == 0:
            return SearchResults(np.zeros((0, k), np.int64),
                                 np.zeros((0, k), np.float32))
        if self.bitmat is None:
            self.build_bitpack()
        if self._resolved_selection() == "bucketed":
            return _results(*bitpack_bucketed_topk(q, self.bitmat, k=k))
        return _results(*bitpack_topk_search(q, self.bitmat, k=k))
