"""Host-streamed bit-packed search for indexes whose compact ELL does not
fit the device either (counterpart of ``vsearch_tpu/index/streamed.py``).

The ELL stays in host memory, trimmed to the corpus-wide max nnz and with
uint16 column ids when the vocabulary allows (128-256 bytes a row against
4 KB packed). ``search`` sweeps row blocks through the card: each block is
copied into one of two pinned staging buffers and on to the device on a
side stream, so block i+1 crosses PCIe while block i is packed (kernel
#1), scored and merged; CUDA events order the reuse of each buffer. One
sweep serves the whole query batch.

Exactness: with selection 'exact' every block keeps its own top k and the
running merge keeps the global top k, so ids and scores equal scoring the
whole packed matrix; 'bucketed' uses kernel #3 per block. Every block,
the last one too, has the full block shape: the last is zero-padded on
the host and its rows past the corpus end are masked to -1.0, as in the
JAX package, so tied rows survive as they do there.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bitpack import (BUCKET, ROW_BLOCK, TILE_BITS, _keys_topk,
                           _prepare_bf16, bucket_keys, merge_topk,
                           pack_bits, score_bits)
from ..ops.ell import widen_cols
from ..ops.search import top_k


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class StreamedBitpackSearcher:
    """Exact binary (bag-of-token) search over a host-resident ELL.

    ``cols``/``nnz`` stay on the host (numpy); ``search`` sweeps row
    blocks through ``device``. Column ids are kept as uint16 when the
    vocabulary allows (V <= 65535), which halves the bytes moved.
    """

    def __init__(self, cols, nnz, num_cols: int, block_rows: int = 1 << 18,
                 selection: str = "exact", device="cuda"):
        if selection not in ("exact", "bucketed"):
            raise ValueError(f"unknown selection {selection!r}")
        self.device = resolve_device(device)
        cols = np.asarray(cols)
        n, nnz_pad = cols.shape
        if n == 0:
            raise ValueError("empty index")
        block_rows = min(_round_up(block_rows, ROW_BLOCK),
                         _round_up(n, ROW_BLOCK))
        nnz = np.ascontiguousarray(nnz, dtype=np.int32)
        # trim padding columns beyond the corpus-wide max nnz: the bytes
        # moved are the sweep's cost
        mx = _round_up(max(int(nnz.max()), 1), 8)
        if mx < nnz_pad:
            cols = cols[:, :mx]
        # the sentinel num_cols must fit too, hence <= 65535; ids >= V
        # (and negative ids, which wrap) are masked by the pack
        if num_cols <= 65535:
            dt = np.uint16
        else:
            dt = cols.dtype if cols.dtype == np.int32 else np.int32
        self.cols = np.ascontiguousarray(cols, dtype=dt)
        self.nnz = nnz
        self.num_cols = num_cols
        self.num_rows = n
        self.block_rows = block_rows
        self.n_blocks = -(-n // block_rows)
        self.selection = selection
        # uint16 ids travel as int16 bit patterns (ops.ell.widen_cols)
        self._torch_cols = torch.from_numpy(
            self.cols.view(np.int16) if dt == np.uint16 else self.cols)
        self._torch_nnz = torch.from_numpy(self.nnz)
        self._slots: Optional[List[dict]] = None  # CUDA staging, lazily
        self._copy_stream = None

    @property
    def bytes_per_sweep(self) -> int:
        """Host->device bytes of one sweep (full-shape blocks)."""
        row = self.cols.shape[1] * self.cols.itemsize + 4
        return self.n_blocks * self.block_rows * row

    # -- one block ---------------------------------------------------------
    def _step(self, best_s, best_i, qT, cols_blk, nnz_blk, row0: int,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pack one full-shape block, select its top k, merge as
        [carried, block]."""
        rows = cols_blk.shape[0]
        words = pack_bits(widen_cols(cols_blk), nnz_blk, self.num_cols)
        if self.selection == "bucketed":
            if k * BUCKET > rows:
                # bitpack_bucketed_topk's own exact fallback
                s, ids = top_k(score_bits(words, qT)[:rows].T, k)
            else:
                ids, s = _keys_topk(bucket_keys(words, qT, rows), k, BUCKET)
            # rows past the corpus end (the last block's padding) score 0
            # and can tie into the top k: mask them out
            s = torch.where(row0 + ids < self.num_rows, s, -1.0)
        else:
            scores = score_bits(words, qT)[:rows].T  # [B, rows]
            real = (row0 + torch.arange(rows, device=scores.device)
                    < self.num_rows)
            s, ids = top_k(torch.where(real[None, :], scores, -1.0), k)
        return merge_topk(best_s, best_i, s, ids + row0, k)

    def _host_block(self, blk: int) -> Tuple[int, int]:
        s = blk * self.block_rows
        return s, min(s + self.block_rows, self.num_rows)

    # -- CUDA pipeline -----------------------------------------------------
    def _cuda_slots(self) -> List[dict]:
        """Two pinned host staging buffers and two device buffers of one
        block each, with the events that order their reuse."""
        if self._slots is None:
            shape = (self.block_rows, self.cols.shape[1])
            dt = self._torch_cols.dtype
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [{
                "h_cols": torch.empty(shape, dtype=dt, pin_memory=True),
                "h_nnz": torch.empty(self.block_rows, dtype=torch.int32,
                                     pin_memory=True),
                "d_cols": torch.empty(shape, dtype=dt, device=self.device),
                "d_nnz": torch.empty(self.block_rows, dtype=torch.int32,
                                     device=self.device),
                "copied": torch.cuda.Event(),
                "consumed": torch.cuda.Event(),
            } for _ in range(2)]
        return self._slots

    def _stage(self, blk: int) -> None:
        """Fill block ``blk``'s pinned buffer on the host and start its
        copy to the device on the side stream."""
        slot = self._slots[blk % 2]
        s, e = self._host_block(blk)
        # the host buffer is free once its previous copy has finished
        slot["copied"].synchronize()
        slot["h_cols"][: e - s].copy_(self._torch_cols[s:e])
        slot["h_nnz"][: e - s].copy_(self._torch_nnz[s:e])
        if e - s < self.block_rows:  # last block: zero rows, as in JAX
            slot["h_cols"][e - s:].zero_()
            slot["h_nnz"][e - s:].zero_()
        with torch.cuda.stream(self._copy_stream):
            # the device buffer is free once the step that read it is done
            self._copy_stream.wait_event(slot["consumed"])
            slot["d_cols"].copy_(slot["h_cols"], non_blocking=True)
            slot["d_nnz"].copy_(slot["h_nnz"], non_blocking=True)
            slot["copied"].record(self._copy_stream)

    def _sweep_cuda(self, best_s, best_i, qT, k: int):
        slots = self._cuda_slots()
        main = torch.cuda.current_stream(self.device)
        self._stage(0)
        for blk in range(self.n_blocks):
            slot = slots[blk % 2]
            main.wait_event(slot["copied"])
            best_s, best_i = self._step(best_s, best_i, qT, slot["d_cols"],
                                        slot["d_nnz"],
                                        blk * self.block_rows, k)
            slot["consumed"].record(main)
            if blk + 1 < self.n_blocks:
                # block blk+1 is staged while the card works on block blk
                self._stage(blk + 1)
        return best_s, best_i

    def _sweep_host(self, best_s, best_i, qT, k: int):
        for blk in range(self.n_blocks):
            s, e = self._host_block(blk)
            cols = self._torch_cols[s:e]
            nnz = self._torch_nnz[s:e]
            if e - s < self.block_rows:
                pad = self.block_rows - (e - s)
                cols = torch.cat([cols, cols.new_zeros(pad, cols.shape[1])])
                nnz = torch.cat([nnz, nnz.new_zeros(pad)])
            best_s, best_i = self._step(best_s, best_i, qT,
                                        cols.to(self.device),
                                        nnz.to(self.device), s, k)
        return best_s, best_i

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [B, k] int64, scores [B, k] f32), the top k over
        the whole host-resident index."""
        k = min(k, self.num_rows)
        q = (q if torch.is_tensor(q)
             else torch.as_tensor(np.asarray(q, dtype=np.float32)))
        if q.shape[-1] != self.num_cols:
            raise ValueError(f"query dim {q.shape[-1]} != index dim "
                             f"{self.num_cols}")
        q = q.to(self.device, torch.float32)
        # the bf16 operand is prepared once a sweep, not once a block
        qT = _prepare_bf16(q, _round_up(self.num_cols, TILE_BITS))
        b = q.shape[0]
        best_s = torch.full((b, k), -1.0, device=self.device)
        best_i = torch.zeros((b, k), dtype=torch.int64, device=self.device)
        sweep = (self._sweep_cuda if self.device.type == "cuda"
                 else self._sweep_host)
        best_s, best_i = sweep(best_s, best_i, qT, k)
        return best_i.cpu().numpy(), best_s.cpu().numpy()
