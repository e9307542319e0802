"""Sparse (ELL) and bag-of-token indexes (counterpart of
``vsearch_tpu/index/sparse.py``).

Scoring paths: for real-valued sparse indexes the exact chunked gather,
and above 131,072 rows the binary-support proxy (the rows' ids packed to
bits and scored by the CUDA kernels, then an exact rerank of the
candidates: ``ops.two_stage.binary_proxy_search``); for binary
bag-of-token indexes the bit-packed CUDA kernels at every size when the
index lives on the card (``ops.bitpack``; fused bucketed selection above
131,072 rows). A bag-of-token index whose packed bits exceed the device
budget goes to the block tier (compact ELL on the card, repacked block by
block) or, when even that ELL would not fit, to the stream tier (ELL on
the host, streamed through the card). On-disk formats are the JAX
package's: scipy-compatible f16 CSR ``.npz`` and the native ``.ell.npz``,
readable and writable both ways.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.ell import ELLMatrix
from ..utils.profiling import TRACER
from .base import (DenseIndex, IndexType, SearchResults, _resolve_files,
                   _results)

logger = logging.getLogger(__name__)


class SparseIndex(DenseIndex):
    """Sparse vocab-space index over an ELLMatrix.

    search_mode: 'auto' | 'exact' | 'bitproxy' ('auto' takes the proxy
    above ``exact_threshold`` rows)."""

    index_type = IndexType.SPARSE
    _binary = False
    _search_modes = ("auto", "exact", "bitproxy")

    # 'auto' scores exactly up to this many rows and through the
    # binary-support proxy + exact rerank above it
    exact_threshold = 131072
    # scalar gathers of the exact rerank a QUERY (C * nnz_pad), so that a
    # query's results do not depend on how many queries share the call
    # (the serve coalescer merges requests). 196,608 is C=1536 at nnz_pad
    # 128, the JAX package's setting (C=3072 at nnz_pad 64)
    rerank_budget = 196_608

    def __init__(self, index_file: Optional[str] = None,
                 data_file: Optional[str] = None, fp16: bool = True,
                 low_memory: bool = False, shift: int = 0,
                 val_dtype=torch.bfloat16, block_rows: int = 4096,
                 search_mode: str = "auto",
                 selection: Optional[str] = None, device="cuda"):
        if search_mode in ("stream", "block") and not self._binary:
            # the over-size tiers pack blocks to bits: binary only, a
            # real-valued index would silently lose its weights
            raise ValueError(f"search_mode={search_mode!r} supports "
                             "binary bag-of-token indexes only")
        if search_mode not in self._search_modes:
            raise ValueError(
                f"unknown search_mode={search_mode!r} for "
                f"{type(self).__name__} (available: {self._search_modes})")
        self.shift = shift
        self.val_dtype = val_dtype
        # rows of a sharded exact search's scoring chunk / 16
        self.block_rows = block_rows
        self.search_mode = search_mode
        if selection is not None:  # else the class default applies
            self.selection = selection
        self.ell: Optional[ELLMatrix] = None
        self._reset_derived()
        super().__init__(index_file, data_file, fp16,
                         low_memory=low_memory, device=device)

    def _reset_derived(self):
        """Drop everything derived from the ELL: a reload that kept the
        packed support or the shards would answer from the old corpus."""
        self.bitproxy = None  # the support's BitMatrix (bitproxy route)
        self._drop_mesh()
        # what _shards holds under a mesh: 'ell' (exact per shard), 'bits'
        # (BoTIndex: packed shards) or 'block' (BoTIndex: compact ELL
        # shards in _mesh_ell, scored blockwise)
        self._mesh_kind: Optional[str] = None
        self._mesh_ell = None

    def _load_device(self) -> torch.device:
        """Where a freshly loaded ELL lives: the index's device, or the
        host for BoTIndex's over-size tiers."""
        return self.device

    # -- loading -----------------------------------------------------------
    def init_index(self, index_file: Union[str, Sequence[str]],
                   fp16: bool = True):
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
                                        device=self._load_device())

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
                                     self._load_device())

    def set_ell(self, ell: ELLMatrix):
        self.ell = ell
        self._reset_derived()

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
        if v is None or isinstance(v, ELLMatrix):
            self.set_ell(v)
        else:
            self.set_vectors(v)

    def __len__(self) -> int:
        if self.data is not None:
            return len(self.data)
        if self._lazy is not None:
            return len(self._lazy)
        return 0 if self.ell is None else self.ell.shape[0]

    # -- distribution ------------------------------------------------------
    def to_mesh(self, mesh, axis_name: str = "dp"):
        """Row-shard the ELL over the mesh axis; searches then score each
        shard exactly (no binary-support proxy) and merge the shards'
        top-k, as the JAX package does. ``ell`` stays as it is (the
        shards are views of it where they lie on its device)."""
        from ..parallel.sharded_search import shard_ell

        self._shards = shard_ell(mesh, self.ell, axis_name)
        self._mesh, self._true_rows = (mesh, axis_name), self.ell.shape[0]
        self._mesh_kind = "ell"
        return self

    def _mesh_ell_search(self, q: torch.Tensor, k: int) -> SearchResults:
        from ..ops.ell import ell_matvec_chunked
        from ..parallel.sharded_search import make_sharded_ell_search

        mesh, axis_name = self._mesh
        search = make_sharded_ell_search(
            mesh, k, self._shards,
            score_fn=lambda qq, shard: ell_matvec_chunked(
                qq, shard, chunk_rows=self.block_rows * 16),
            axis_name=axis_name, num_rows=self._true_rows)
        return _results(*search(q, self._shards))

    # -- search ------------------------------------------------------------
    def _use_bitproxy(self) -> bool:
        if self.search_mode == "bitproxy":
            return True
        if self.search_mode != "auto":
            return False
        return self.ell.shape[0] > self.exact_threshold

    def search(self, q_embs, k: int,
               num_candidates: Optional[int] = None) -> SearchResults:
        from ..ops.two_stage import binary_proxy_search, exact_search

        q = self._query_tensor(q_embs, self.ell.num_cols)
        n = self.ell.shape[0]
        k = min(k, n)
        if q.shape[0] == 0:
            return SearchResults(np.zeros((0, k), np.int64),
                                 np.zeros((0, k), np.float32))
        if self._mesh_kind == "ell":
            return self._mesh_ell_search(q, k)
        if not self._use_bitproxy():
            return _results(*exact_search(q, self.ell, k=k))
        if num_candidates is None:
            # the per-query budget is a cap, floored only at k
            cap = self.rerank_budget // max(self.ell.nnz_pad, 1)
            num_candidates = min(n, max(k, cap))
        else:
            num_candidates = min(n, max(num_candidates, k))
        if self.bitproxy is None:
            from ..ops.bitpack import pack_ell
            self.bitproxy = pack_ell(self.ell)
        return _results(*binary_proxy_search(
            q, self.ell, self.bitproxy, k=k, num_candidates=num_candidates))

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
    kernels (4 KB a row in device memory, exact scores). An index whose
    packed matrix exceeds the device budget falls to one of two over-size
    tiers: 'block' keeps the compact ELL on the card (uint16 ids: ~5.4 GB
    at wiki21m's 21M rows against ~86 GB packed) and repacks row blocks
    in each search (``ops.bitpack.bitpack_blockwise_topk``, no host
    traffic a query); 'stream' keeps the ELL on the host and streams it
    through the card (``index.streamed``) when even the compact ELL would
    not fit.

    search_mode: 'auto' | 'exact' | 'bitpack' | 'block' | 'stream';
    selection: 'auto' | 'exact' | 'approx' | 'bucketed' |
    'bucketed_approx' (off the TPU the JAX package runs 'approx' as exact
    top-k and 'bucketed_approx' as 'bucketed'; so does the port).
    """

    index_type = IndexType.BAG_OF_TOKEN
    _binary = True
    _search_modes = ("auto", "exact", "bitpack", "block", "stream")
    _selections = ("auto", "exact", "approx", "bucketed", "bucketed_approx")

    # -- over-size tier knobs ---------------------------------------------
    # 'auto' leaves the resident bit-packed path when the packed matrix
    # would not fit this budget; None -> 3/4 of the card's memory, which
    # leaves room for queries, per-block transients and encoder weights
    hbm_budget_bytes: Optional[int] = None
    stream_block_rows = 1 << 18
    # the block tier selects candidates with kernel #4 (int8 scores) and
    # restores exact f32 scores and order by an exact rerank of
    # block_cand_budget survivors (0 -> 2k); False pins kernel #3
    block_int8 = True
    block_cand_budget = 0

    # 'auto' resolves to the fused bucketed kernel above this row count
    # and to exact top-k below it (with only N/8 buckets, top-100 bucket
    # collisions become measurable at small N)
    selection = "auto"
    bucketed_threshold = 131_072

    # host copies (cols, nnz) of the ELL's rows, given to ``set_ell`` by a
    # caller that holds them: the stream tier reads them in place of a
    # copy of the ELL from the card
    _host_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def set_ell(self, ell: ELLMatrix, host_cache=None):
        """The JAX package's ``set_ell(ell, host_cache)``: ``host_cache``
        is numpy ``(cols, nnz)`` of the same rows, or None."""
        super().set_ell(ell)
        self._host_cache = host_cache

    def _reset_derived(self):
        """Also drop the packed bits, the block tier's device ELL and the
        streamer."""
        super()._reset_derived()
        self.bitmat = None
        self._block_ell = None
        self._streamer = None

    def _resolved_selection(self) -> str:
        if self.selection not in self._selections:
            raise ValueError(f"unknown selection {self.selection!r}")
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

    def _budget(self, device: Optional[torch.device] = None) -> int:
        """``hbm_budget_bytes``, else 3/4 of ``device``'s memory (default:
        the index's device)."""
        if self.hbm_budget_bytes is not None:
            return self.hbm_budget_bytes
        return torch.cuda.mem_get_info(device or self.device)[1] * 3 // 4

    def _load_device(self) -> torch.device:
        # the over-size modes keep a loaded ELL on the host: the block
        # tier uploads only its compact copy, the stream tier streams it
        if self.search_mode in ("stream", "block"):
            return torch.device("cpu")
        return self.device

    def _on_card(self) -> bool:
        return self.ell.cols.is_cuda

    def _ell_device_bytes(self) -> int:
        """Device footprint of the compact ELL as the block tier stores
        it (uint16 ids when the vocabulary allows, int32 nnz)."""
        n, nnz_pad = self.ell.cols.shape
        itemsize = 2 if self.ell.num_cols <= 65535 else 4
        return n * (nnz_pad * itemsize + 4)

    def _oversize_tier(self) -> Optional[str]:
        """None (packed fits: the resident paths apply) | 'block' |
        'stream'. 'auto' leaves the resident path only for an ELL on the
        card, preferring the block tier (no host traffic a query) and
        streaming only when even the compact ELL would crowd out the
        per-block transients (one packed block ~1 GiB + selection). None
        under a mesh: its shards hold the rows, each on its own device."""
        if self._mesh is not None:
            return None
        if self.search_mode in ("stream", "block"):
            return self.search_mode
        if (self.search_mode == "auto" and self._on_card()
                and self._packed_bytes() > self._budget()):
            return ("block" if self._ell_device_bytes()
                    <= self._budget() - (3 << 30) else "stream")
        return None

    def _compact_ell(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The compact ELL of the block tier, made where the ELL lives:
        columns past the corpus-wide max nnz (rounded to 8) are trimmed,
        and ids are stored in 16 bits while V <= 65535 (int16 bit patterns
        of uint16, see ``ops.ell.widen_cols``; the sentinel survives, and
        the pack masks anything outside [0, V))."""
        cols, nnz = self.ell.cols, self.ell.nnz.to(torch.int32)
        mx = -(-max(int(nnz.max()), 1) // 8) * 8
        if mx < cols.shape[1]:
            cols = cols[:, :mx]
        dt = torch.int16 if self.ell.num_cols <= 65535 else torch.int32
        return cols.to(dt).contiguous(), nnz.contiguous()

    def _get_block_ell(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-time copy of the compact ELL onto the device for the block
        tier (converted where the ELL lives, then moved: a host ELL
        crosses PCIe once, at half the bytes)."""
        if self._block_ell is None:
            cols, nnz = self._compact_ell()
            self._block_ell = (cols.to(self.device), nnz.to(self.device))
        return self._block_ell

    def _block_selection(self) -> str:
        sel = self._resolved_selection()
        if not sel.startswith("bucketed"):
            return "exact"
        if self.block_int8 and self.ell.vals is None:
            return "bucketed_int8"
        return "bucketed"

    def _block_search(self, q: torch.Tensor, k: int):
        from ..ops.bitpack import bitpack_blockwise_topk

        cols, nnz = self._get_block_ell()
        return bitpack_blockwise_topk(
            q, cols, nnz, num_cols=self.ell.num_cols, k=k,
            block_rows=self.stream_block_rows,
            selection=self._block_selection(),
            cand_budget=self.block_cand_budget)

    def _get_streamer(self):
        from .streamed import StreamedBitpackSearcher

        if self._streamer is None:
            # the caller's host copies, views of a host ELL, or one copy
            # of a device one (the compact ELL, never the packed bits)
            cols, nnz = self._host_cache or (self.ell.cols.cpu().numpy(),
                                             self.ell.nnz.cpu().numpy())
            sel = self._resolved_selection()
            self._streamer = StreamedBitpackSearcher(
                cols, nnz, self.ell.num_cols,
                block_rows=self.stream_block_rows,
                selection=("bucketed" if sel.startswith("bucketed")
                           else "exact"),
                device=self.device)
        return self._streamer

    def _use_bitpack(self) -> bool:
        if self.search_mode == "bitpack":
            return True
        if self.search_mode != "auto":
            return False
        # the JAX package takes the kernel at every size on the TPU; the
        # port does so whenever the index lives on the card
        if self._on_card():
            return True
        return self.ell.shape[0] > self.exact_threshold

    def build_bitpack(self):
        from ..ops.bitpack import pack_ell

        if self._on_card() and self._packed_bytes() > self._budget():
            raise ValueError(
                f"packed matrix of {self._packed_bytes()} bytes exceeds the "
                f"{self._budget()}-byte device budget; search such an index "
                "through the block or stream tier (search_mode='auto' picks "
                "one, or pass search_mode='block' / 'stream')")
        self.bitmat = pack_ell(self.ell)
        return self.bitmat

    # -- distribution ------------------------------------------------------
    def _mesh_use_blockwise(self, mesh, axis_name: str) -> bool:
        """Shard the COMPACT ELL (blockwise per-shard scoring) instead of
        the packed bits when the packed rows of a device's shards would
        not fit it (each device reads its own budget, shared by the
        shards it holds). Explicit 'block'/'stream' modes shard the ELL
        too: both declare an index larger than a device, and under a mesh
        each shard's compact ELL is 1/shards of it, so it belongs on the
        devices."""
        if self.search_mode in ("block", "stream"):
            return True
        if self.search_mode != "auto" or not self._on_card():
            return False
        rows_per = -(-self.ell.shape[0] // mesh.shape[axis_name])
        mine = [d for d, m in zip(mesh.devices(axis_name),
                                  mesh.is_local(axis_name)) if m]
        return any(self._packed_bytes(rows_per) * mine.count(d)
                   > self._budget(d) for d in set(mine))

    def to_mesh(self, mesh, axis_name: str = "dp"):
        """Row-shard over the mesh axis. The packed bits shard (already
        packed bits are split; else kernel #1 packs each shard on its
        device), so each shard keeps the resident kernels #3 or #2; when
        even one shard's packed rows exceed its device, the compact ELL
        shards instead and each device scores its rows blockwise (#1 and
        #4 a block, the mesh form of the block tier). An index the resident paths would
        not take (small, on the host) shards its ELL for exact search."""
        from ..parallel.sharded_search import (pack_shards, shard_bitmat,
                                               shard_ell)

        n = self.ell.shape[0]
        if self._mesh_use_blockwise(mesh, axis_name):
            cols, nnz = self._compact_ell()
            self._mesh_ell = shard_ell(mesh, ELLMatrix(
                cols=cols, nnz=nnz, vals=None, num_cols=self.ell.num_cols,
                sentinel_padded=False), axis_name)
            self._mesh, self._true_rows = (mesh, axis_name), n
            self._mesh_kind = "block"
            return self
        if self._use_bitpack():
            if self.bitmat is None:  # packed shard by shard
                self._shards = pack_shards(mesh, self.ell, axis_name)
            else:
                self._shards = shard_bitmat(mesh, self.bitmat, axis_name)
                if any(d != self.bitmat.words.device
                       for d in mesh.devices(axis_name)):
                    self.bitmat = None  # the shards are copies
            self._mesh, self._true_rows = (mesh, axis_name), n
            self._mesh_kind = "bits"
            return self
        return super().to_mesh(mesh, axis_name)

    def _mesh_blockwise_search(self, q: torch.Tensor, k: int
                               ) -> SearchResults:
        from ..parallel.sharded_search import make_sharded_blockwise_search

        mesh, axis_name = self._mesh
        search = make_sharded_blockwise_search(
            mesh, k, self._true_rows, self._mesh_ell, axis_name,
            selection=self._block_selection(),
            block_rows=self.stream_block_rows,
            cand_budget=self.block_cand_budget)
        return _results(*search(q, self._mesh_ell))

    def _mesh_bitpack_search(self, q: torch.Tensor, k: int
                             ) -> SearchResults:
        from ..parallel.sharded_search import make_sharded_bitpack_search

        mesh, axis_name = self._mesh
        sel = self._resolved_selection()
        search = make_sharded_bitpack_search(
            mesh, k, self._shards, axis_name,
            selection="bucketed" if sel.startswith("bucketed") else "exact")
        return _results(*search(q, self._shards))

    def search(self, q_embs, k: int,
               num_candidates: Optional[int] = None) -> SearchResults:
        if getattr(q_embs, "shape", (1,))[0] == 0:
            # every path has a well-defined empty answer; the kernels
            # would launch an empty grid
            k0 = min(k, self._true_rows or self.ell.shape[0])
            return SearchResults(np.zeros((0, k0), np.int64),
                                 np.zeros((0, k0), np.float32))
        if self._mesh_kind in ("block", "bits"):
            q = self._query_tensor(q_embs, self.ell.num_cols)
            k = min(k, self._true_rows)
            if self._mesh_kind == "block":
                return self._mesh_blockwise_search(q, k)
            return self._mesh_bitpack_search(q, k)
        # spans (``utils.profiling.TRACER``) under the caller's: the
        # tier's choice (``_budget`` reads the card's memory), the query
        # operand, the kernels' launches; ``_results`` is ``to_host``
        with TRACER.span("budget"):
            tier = self._oversize_tier()
        if tier is not None:
            with TRACER.span("query"):
                q = self._query_tensor(q_embs, self.ell.num_cols)
            k = min(k, self.ell.shape[0])
            if tier == "block":
                with TRACER.span("launch"):
                    ids, scores = self._block_search(q, k)
                return _results(ids, scores)
            return SearchResults(*self._get_streamer().search(q, k))
        if self._mesh_kind == "ell" or not self._use_bitpack():
            return super().search(q_embs, k, num_candidates=num_candidates)
        from ..ops.bitpack import bitpack_bucketed_topk, bitpack_topk_search

        with TRACER.span("query"):
            q = self._query_tensor(q_embs, self.ell.num_cols)
        k = min(k, self.ell.shape[0])
        if self.bitmat is None:
            self.build_bitpack()
        with TRACER.span("launch"):
            if self._resolved_selection().startswith("bucketed"):
                ids, scores = bitpack_bucketed_topk(q, self.bitmat, k=k)
            else:
                ids, scores = bitpack_topk_search(q, self.bitmat, k=k)
        return _results(ids, scores)
