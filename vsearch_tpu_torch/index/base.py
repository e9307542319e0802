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

logger = logging.getLogger(__name__)


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


def _results(ids: torch.Tensor, scores: torch.Tensor) -> SearchResults:
    return SearchResults(ids.cpu().numpy(), scores.cpu().numpy())


class DenseIndex:
    """Dense [N, D] vector index with matmul + top-k search."""

    index_type = IndexType.DENSE

    def __init__(self, index_file: Optional[str] = None,
                 data_file: Optional[str] = None, low_memory: bool = False,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.data: Optional[List[Any]] = None
        self.vector: Optional[torch.Tensor] = None
        self.dtype = dtype
        self.low_memory = low_memory
        self._lazy: Optional[_JsonlOffsets] = None
        if index_file:
            self.init_index(index_file)
        if data_file:
            self.load_data(data_file)

    # -- loading -----------------------------------------------------------
    def init_index(self, index_file: Union[str, Sequence[str]]):
        files = _resolve_files(index_file)
        logger.info("Loading %s index from %d file(s)",
                    self.index_type.value, len(files))
        shards = [self._load_one(f) for f in files]
        mat = np.concatenate(shards, axis=0) if len(shards) > 1 else shards[0]
        self.set_vectors(mat)

    @staticmethod
    def _load_one(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z[list(z.files)[0]]
        if path.endswith(".pt"):
            t = torch.load(path, map_location="cpu", weights_only=True)
            return (t.to_dense() if t.is_sparse else t).float().numpy()
        raise ValueError(f"unknown dense index format: {path}")

    def set_vectors(self, mat):
        self.vector = torch.as_tensor(np.asarray(mat, dtype=np.float32)) \
            .to(self.device, self.dtype)

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
        return 0 if self.vector is None else int(self.vector.shape[0])

    # -- search ------------------------------------------------------------
    def _query_tensor(self, q_embs, dim: int) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(q_embs, dtype=np.float32)) \
            if not torch.is_tensor(q_embs) else q_embs
        if q.shape[-1] != dim:
            raise ValueError(f"query dim {q.shape[-1]} != index dim {dim}")
        return q.to(self.device, torch.float32)

    def search(self, q_embs, k: int) -> SearchResults:
        q = self._query_tensor(q_embs, self.vector.shape[1])
        k = min(k, int(self.vector.shape[0]))
        ids, scores = dense_topk_search(q.to(self.dtype), self.vector, k)
        return _results(ids, scores)

    # -- persistence -------------------------------------------------------
    def save(self, path: str):
        mat = self.vector.to(torch.float16).cpu().numpy()
        if path.endswith(".npz"):
            np.savez_compressed(path, vectors=mat)
        elif path.endswith(".pt"):
            torch.save(torch.from_numpy(mat), path)
        else:
            np.save(path if path.endswith(".npy") else path + ".npy", mat)
        logger.info("Index saved to %s", path)

    def __str__(self):
        shape = None if self.vector is None else tuple(self.vector.shape)
        return (f"Index Type        : {type(self).__name__}\n"
                f"Vector Shape      : {shape}\n"
                f"Vector Dtype      : "
                f"{None if self.vector is None else self.vector.dtype}\n"
                f"Number of Texts   : {len(self)}\n")


Index = DenseIndex
