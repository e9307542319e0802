"""Index structures: dense vector index + shared machinery
(counterpart of ``vsearch_tpu/index/base.py``).

Vectors live on the device as torch tensors (bf16 by default, f16 on
disk for npz interop); search is a matmul + top-k; texts are held on the
host, with an optional low-memory byte-offset mode for lazy jsonl reads.
"""
from __future__ import annotations

import glob as globlib
import json
import logging
from enum import Enum
from typing import Any, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.search import dense_topk_search
from ..utils.profiling import TRACER

logger = logging.getLogger(__name__)

# rows converted and copied at a time by ``DenseIndex._upload`` (256 MB of
# f32 at 768 dims)
_UPLOAD_ROWS = 1 << 16
# source dtypes cast straight to the index dtype (the rest via f32)
_DIRECT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


class SearchResults(NamedTuple):
    """(ids, scores), each [num_queries, k] numpy arrays."""

    ids: np.ndarray
    scores: np.ndarray


class IndexType(Enum):
    DENSE = "dense"
    SPARSE = "sparse"
    BAG_OF_TOKEN = "bag_of_token"


class _JsonlOffsets:
    """Byte-offset table for lazy line reads from jsonl file(s)."""

    def __init__(self, files: Sequence[str]):
        self.files = list(files)
        self.offsets: List[List[int]] = []
        for path in self.files:
            offs = []
            pos = 0
            with open(path, "rb") as f:
                for line in f:
                    offs.append(pos)
                    pos += len(line)
            self.offsets.append(offs)
        self.counts = [len(o) for o in self.offsets]
        self.total = sum(self.counts)

    def __len__(self):
        return self.total

    def get(self, global_index: int) -> Any:
        cum = 0
        for path, offs, n in zip(self.files, self.offsets, self.counts):
            if global_index < cum + n:
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(offs[global_index - cum])
                    return json.loads(f.readline())
            cum += n
        raise IndexError(global_index)


def _resolve_files(pattern: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(pattern, (list, tuple)):
        return list(pattern)
    files = sorted(globlib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no files match {pattern!r}")
    return files


def _on(device: torch.device, t: torch.Tensor) -> bool:
    """Whether ``t`` lives on ``device`` ("cuda" meaning the current
    card)."""
    if t.device == device:
        return True
    return (device.type == t.device.type == "cuda" and device.index is None
            and t.device.index == torch.cuda.current_device())


def _results(ids: torch.Tensor, scores: torch.Tensor) -> SearchResults:
    """The search's closing copy to the host, a ``to_host`` span."""
    with TRACER.span("to_host"):
        return SearchResults(ids.cpu().numpy(), scores.cpu().numpy())


class DenseIndex:
    """Dense [N, D] vector index with matmul + top-k search."""

    index_type = IndexType.DENSE
    # 'exact' or 'approx' (searched exactly: see ``search``)
    selection = "exact"

    def __init__(self, index_file: Optional[str] = None,
                 data_file: Optional[str] = None, fp16: bool = True,
                 low_memory: bool = False, dtype=torch.bfloat16,
                 device="cuda"):
        # the JAX package's arguments in its order; ``fp16`` is accepted
        # and unused there too (``dtype`` sets the stored type)
        self.device = resolve_device(device)
        self.data: Optional[List[Any]] = None
        self.vector: Optional[torch.Tensor] = None
        self.dtype = dtype
        self.low_memory = low_memory
        self._lazy: Optional[_JsonlOffsets] = None
        self._drop_mesh()
        if index_file:
            self.init_index(index_file, fp16)
        if data_file:
            self.load_data(data_file)

    # -- loading -----------------------------------------------------------
    def init_index(self, index_file: Union[str, Sequence[str]],
                   fp16: bool = True):
        """Load one or more shards (``.npy``, ``.npz``, ``.pt``) in their
        stored dtype and write them into one device tensor shard by
        shard: no concatenated or f32 host copy of the whole index."""
        files = _resolve_files(index_file)
        logger.info("Loading %s index from %d file(s)",
                    self.index_type.value, len(files))
        self._upload(self._load_one(f) for f in files)

    @staticmethod
    def _load_one(path: str):
        """One shard in its stored dtype (``.npy`` memory-mapped)."""
        if path.endswith(".npy"):
            return np.load(path, mmap_mode="r")
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z[list(z.files)[0]]
        if path.endswith(".pt"):
            t = torch.load(path, map_location="cpu", weights_only=True)
            return t.to_dense() if t.is_sparse else t
        raise ValueError(f"unknown dense index format: {path}")

    def set_vectors(self, mat):
        """``mat``: an [N, D] numpy array (any float dtype) or torch tensor,
        stored on the device in ``self.dtype``. Converted in row slices,
        so no f32 copy of the whole matrix is made on the host; a tensor
        already on the device in ``self.dtype`` is kept as it is."""
        self._drop_mesh()
        if (torch.is_tensor(mat) and _on(self.device, mat)
                and mat.dtype == self.dtype and mat.ndim == 2):
            self.vector = mat
        else:
            self._upload([mat if torch.is_tensor(mat) or
                          isinstance(mat, np.ndarray) else np.asarray(mat)])

    def _upload(self, shards):
        """Stack ``shards`` row-wise into one [N, D] ``self.dtype`` tensor
        on the device, ``_UPLOAD_ROWS`` rows at a time. f16 and f32 slices
        convert straight to ``self.dtype`` (f16 -> f32 is exact, so this
        equals the f32 detour); other dtypes pass through f32, as the f32
        detour did."""
        self._drop_mesh()
        shards = list(shards)
        n = sum(int(m.shape[0]) for m in shards)
        d = int(shards[0].shape[1]) if shards else 0
        out = torch.empty((n, d), dtype=self.dtype, device=self.device)
        row = 0
        for mat in shards:
            if mat.ndim != 2 or mat.shape[1] != d:
                raise ValueError(f"index shard of shape {tuple(mat.shape)} "
                                 f"does not stack on [*, {d}]")
            for s in range(0, mat.shape[0], _UPLOAD_ROWS):
                part = mat[s:s + _UPLOAD_ROWS]
                if not torch.is_tensor(part):
                    part = torch.from_numpy(np.array(
                        part, dtype=part.dtype if part.dtype in
                        (np.float16, np.float32) else np.float32))
                elif part.dtype not in _DIRECT_DTYPES:
                    part = part.float()
                out[row:row + part.shape[0]] = part.to(self.device)
                row += part.shape[0]
        self.vector = out

    def load_data(self, data_file: Union[str, Sequence[str]]):
        files = _resolve_files(data_file)
        if self.low_memory:
            self._lazy = _JsonlOffsets(files)
        else:
            data = []
            for path in files:
                with open(path, "r", encoding="utf-8") as f:
                    data.extend(json.loads(l) for l in f)
            self.data = data

    # -- access ------------------------------------------------------------
    def get_sample(self, index: int) -> Any:
        if self._lazy is not None:
            return self._lazy.get(index)
        return self.data[index]

    def __len__(self) -> int:
        if self.data is not None:
            return len(self.data)
        if self._lazy is not None:
            return len(self._lazy)
        if self._mesh is not None:
            return self._true_rows
        return 0 if self.vector is None else int(self.vector.shape[0])

    # -- distribution ------------------------------------------------------
    def move_to_device(self, device=None):
        """Reference-compat shim (src/ir/retriever/index.py:54-57): the
        index already lives on its device; ``to_mesh`` shards it."""
        return self

    def _drop_mesh(self):
        """Forget the sharded state: a reload after ``to_mesh`` must not
        search the old rows or clamp k to the old row count."""
        self._mesh = None  # (Mesh, axis_name) once to_mesh is called
        self._true_rows: Optional[int] = None
        self._shards = None

    def to_mesh(self, mesh, axis_name: str = "dp"):
        """Shard the index rows over the mesh axis; searches then run the
        per-shard top-k and one merge (``parallel.sharded_search``). Where
        every shard lies on the index's device (virtual shards) each is a
        view of ``vector``; else each is a copy on its device and
        ``vector`` is let go."""
        from ..parallel.sharded_search import shard_rows

        n, vec = int(self.vector.shape[0]), self.vector
        self._shards = shard_rows(mesh, vec, axis_name)
        self._mesh, self._true_rows = (mesh, axis_name), n
        if any(d != vec.device for d in mesh.devices(axis_name)):
            self.vector = None
        return self

    def _rows(self) -> torch.Tensor:
        """The index rows as one tensor (gathered from the shards on the
        host when ``to_mesh`` let ``vector`` go)."""
        if self.vector is not None:
            return self.vector
        return torch.cat([p.cpu() for p in self._shards.parts]
                         )[: self._true_rows]

    # -- search ------------------------------------------------------------
    def _query_tensor(self, q_embs, dim: int) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(q_embs, dtype=np.float32)) \
            if not torch.is_tensor(q_embs) else q_embs
        if q.shape[-1] != dim:
            raise ValueError(f"query dim {q.shape[-1]} != index dim {dim}")
        return q.to(self.device, torch.float32)

    def search(self, q_embs, k: int) -> SearchResults:
        """Exact top-k by chunked product (``ops.search.dense_topk_search``).
        ``selection`` 'approx' is the JAX package's TPU-only
        ``approx_max_k``, which it too answers exactly off the TPU."""
        if self.selection not in ("exact", "approx"):
            raise ValueError(f"unknown selection {self.selection!r} "
                             "(dense indexes: 'exact' or 'approx')")
        if self._mesh is not None:
            from ..parallel.sharded_search import make_sharded_dense_search

            mesh, axis_name = self._mesh
            q = self._query_tensor(q_embs,
                                   self._shards.local().shape[1])
            k = min(k, self._true_rows)
            search = make_sharded_dense_search(mesh, k, self._true_rows,
                                               axis_name)
            return _results(*search(q, self._shards))
        q = self._query_tensor(q_embs, self.vector.shape[1])
        k = min(k, int(self.vector.shape[0]))
        ids, scores = dense_topk_search(q.to(self.dtype), self.vector, k)
        return _results(ids, scores)

    # -- persistence -------------------------------------------------------
    def save(self, path: str):
        mat = self._rows().to(torch.float16).cpu().numpy()
        if path.endswith(".npz"):
            np.savez_compressed(path, vectors=mat)
        elif path.endswith(".pt"):
            torch.save(torch.from_numpy(mat), path)
        else:
            np.save(path if path.endswith(".npy") else path + ".npy", mat)
        logger.info("Index saved to %s", path)

    def __str__(self):
        vec = self.vector
        shape = None if vec is None else tuple(vec.shape)
        if vec is None and self._mesh is not None:
            vec = self._shards.local()
            shape = (self._true_rows, vec.shape[1])
        return (f"Index Type        : {type(self).__name__}\n"
                f"Vector Shape      : {shape}\n"
                f"Vector Dtype      : "
                f"{None if vec is None else vec.dtype}\n"
                f"Number of Texts   : {len(self)}\n")


Index = DenseIndex
