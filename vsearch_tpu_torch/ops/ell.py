"""Static-shape sparse row matrix (ELL format) on torch tensors
(counterpart of ``vsearch_tpu/ops/ell.py``).

  cols : [N, nnz_pad] int32   column indices, padded with the sentinel
                              column ``num_cols`` (or 0 when not
                              ``sentinel_padded``)
  vals : [N, nnz_pad] dtype   values, padded with 0 (None for binary
                              matrices: every weight is 1.0)
  nnz  : [N]          int32   true nonzero count per row

The tensors live on one device. Scoring a dense query batch is a
gather-reduce: ``scores[b, n] = sum_j vals[n, j] * q[b, cols[n, j]]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Padded sparse-row matrix. ``sentinel_padded=True`` means padding
    entries of ``cols`` hold ``num_cols``, so scoring needs no validity
    mask: the gather table carries one zero row at index ``num_cols``."""

    cols: torch.Tensor  # [N, nnz_pad] int32
    nnz: torch.Tensor  # [N] int32
    vals: Optional[torch.Tensor]  # [N, nnz_pad] or None for binary
    num_cols: int
    sentinel_padded: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.cols.shape[0], self.num_cols)

    @property
    def nnz_pad(self) -> int:
        return self.cols.shape[1]

    def __len__(self) -> int:
        return self.cols.shape[0]

    # -- conversion --------------------------------------------------------
    @classmethod
    def from_arrays(cls, cols, nnz, vals, num_cols: int,
                    sentinel_padded: bool, device="cuda") -> "ELLMatrix":
        """Upload numpy (or torch) arrays to ``device``."""
        dev = resolve_device(device)

        def put(x):
            if torch.is_tensor(x):
                return x.to(dev)
            x = np.asarray(x)
            return torch.from_numpy(x if x.flags.writeable
                                    else x.copy()).to(dev)

        return cls(cols=put(np.asarray(cols, np.int32)),
                   nnz=put(np.asarray(nnz, np.int32)),
                   vals=None if vals is None else put(vals),
                   num_cols=int(num_cols),
                   sentinel_padded=sentinel_padded)

    @classmethod
    def from_dense(cls, dense, nnz_pad: Optional[int] = None,
                   val_dtype=None, binary: bool = False,
                   device="cuda") -> "ELLMatrix":
        """Build from a dense [N, V] host array. ``binary=True`` stores no
        vals (required for bag-of-token indexes)."""
        dense = np.asarray(dense)
        n, v = dense.shape
        counts = (dense != 0).sum(axis=1).astype(np.int32)
        max_nnz = int(counts.max()) if n else 0
        if nnz_pad is None:
            nnz_pad = max(_round_up(max_nnz, 128), 128)
        if max_nnz > nnz_pad:
            raise ValueError(f"row nnz {max_nnz} exceeds nnz_pad {nnz_pad}")
        cols = np.full((n, nnz_pad), v, dtype=np.int32)  # sentinel pad
        rows_nz, cols_nz = np.nonzero(dense)
        starts = np.zeros(n, dtype=np.int64)
        if n > 1:
            starts[1:] = np.cumsum(counts[:-1], dtype=np.int64)
        offs = np.arange(rows_nz.size, dtype=np.int64) - starts[rows_nz]
        cols[rows_nz, offs] = cols_nz
        vals = None
        if not binary:
            vals = np.zeros((n, nnz_pad), dtype=val_dtype or dense.dtype)
            vals[rows_nz, offs] = dense[rows_nz, cols_nz]
        return cls.from_arrays(cols, counts, vals, v, True, device)

    @classmethod
    def from_scipy_csr(cls, mat, nnz_pad: Optional[int] = None,
                       val_dtype=np.float32, binary: bool = False,
                       pad_multiple: int = 128,
                       device="cuda") -> "ELLMatrix":
        """Build from a scipy CSR matrix (vectorized, no per-row loop)."""
        indptr = np.asarray(mat.indptr, dtype=np.int64)
        indices = np.asarray(mat.indices, dtype=np.int32)
        data = np.asarray(mat.data)
        n, v = mat.shape
        counts = np.diff(indptr).astype(np.int32)
        max_nnz = int(counts.max()) if n else 0
        if nnz_pad is None:
            nnz_pad = max(_round_up(max_nnz, pad_multiple), pad_multiple)
        if max_nnz > nnz_pad:
            raise ValueError(f"row nnz {max_nnz} exceeds nnz_pad {nnz_pad}")
        cols = np.full((n, nnz_pad), v, dtype=np.int32)  # sentinel pad
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        offs = np.arange(indices.size, dtype=np.int64) - np.repeat(
            indptr[:-1], counts)
        cols[rows, offs] = indices
        vals = None
        if not binary:
            vals = np.zeros((n, nnz_pad), dtype=val_dtype)
            vals[rows, offs] = data.astype(val_dtype)
        return cls.from_arrays(cols, counts, vals, v, True, device)

    def to_scipy_csr(self, dtype=np.float32):
        """Convert back to scipy CSR (host-side) for npz interop."""
        from scipy.sparse import csr_matrix

        cols = self.cols.cpu().numpy()
        nnz = self.nnz.cpu().numpy()
        n, nnz_pad = cols.shape
        keep = np.arange(nnz_pad)[None, :] < nnz[:, None]
        rows = np.repeat(np.arange(n), nnz)
        flat_cols = cols[keep]
        if self.vals is None:
            flat_vals = np.ones(flat_cols.size, dtype=dtype)
        else:
            flat_vals = self.vals.float().cpu().numpy()[keep].astype(dtype)
        return csr_matrix((flat_vals, (rows, flat_cols)),
                          shape=(n, self.num_cols))

    def slice_rows(self, start: int, size: int) -> "ELLMatrix":
        end = start + size
        return ELLMatrix(
            cols=self.cols[start:end], nnz=self.nnz[start:end],
            vals=None if self.vals is None else self.vals[start:end],
            num_cols=self.num_cols, sentinel_padded=self.sentinel_padded)


def ell_from_topk(cols, vals, num_cols: int, pad_multiple: int = 128,
                  device="cuda") -> ELLMatrix:
    """ELLMatrix from top-k output (cols sentinel-padded with
    ``num_cols`` where vals == 0). Pads the nnz axis to lane width."""
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    n, k = cols.shape
    nnz = (vals > 0).sum(axis=1).astype(np.int32)
    k_pad = _round_up(max(k, 1), pad_multiple)
    if k_pad != k:
        cols = np.pad(cols, ((0, 0), (0, k_pad - k)),
                      constant_values=num_cols)
        vals = np.pad(vals, ((0, 0), (0, k_pad - k)))
    return ELLMatrix.from_arrays(cols, nnz, vals, num_cols, True, device)


def ell_matvec_scores(q: torch.Tensor, mat: ELLMatrix) -> torch.Tensor:
    """scores [B, N] = q @ mat.T for dense q [B, V] (f32 gather-reduce).

    q is transposed to [V+1, B] with a zero row at index V, rows are
    gathered by column id (sentinel pads hit the zero row), then reduced
    over the nnz axis. Non-sentinel ELLs are masked by ``nnz``.
    """
    n, nnz_pad = mat.cols.shape
    b = q.shape[0]
    qT = torch.cat([q.T.float(),
                    torch.zeros((1, b), dtype=torch.float32,
                                device=q.device)], dim=0)  # [V+1, B]
    g = qT[mat.cols.reshape(-1).long()].reshape(n, nnz_pad, b)
    if mat.vals is not None:
        g = g * mat.vals[:, :, None].float()
    elif not mat.sentinel_padded:
        valid = (torch.arange(nnz_pad, device=q.device)[None, :]
                 < mat.nnz[:, None]).float()
        g = g * valid[:, :, None]
    return g.sum(dim=1).T


def ell_matvec_chunked(q: torch.Tensor, mat: ELLMatrix,
                       chunk_rows: int = 65536) -> torch.Tensor:
    """Exact scores [B, N] with the [chunk, nnz_pad, B] gather bounded to
    about 2^26 elements per step."""
    n, nnz_pad = mat.cols.shape
    b = max(q.shape[0], 1)
    chunk_rows = max(1, min(chunk_rows, (1 << 26) // (nnz_pad * b)))
    if n <= chunk_rows:
        return ell_matvec_scores(q, mat)
    return torch.cat([ell_matvec_scores(q, mat.slice_rows(s, chunk_rows))
                      for s in range(0, n, chunk_rows)], dim=1)
