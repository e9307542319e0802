"""Mesh-sharded index search: per-shard top-k, then one merge
(counterpart of ``vsearch_tpu/parallel/sharded_search.py``).

Index rows split over a mesh axis (``dp`` by default). Each device scores
its own rows with the one-device scorer (``dense_topk_search``, the
bit-packed kernels of ``ops.bitpack``, the exact ELL scorer or the block
tier's ``bitpack_blockwise_topk``) and keeps a local top-k. Each shard
offsets its ids by its first row and demotes its padding rows; only the
(ids, scores) ``[B, k_local]`` lists travel, to the mesh's first device
(``collectives.gather_shard_topk``), where ``merge_shard_topk`` makes the
global top-k: shards are gathered in mesh order, so ties go to the lower
id as in one top-k over every row.

The per-shard loop only enqueues work: nothing in it waits for a device,
so the shards of a mesh of several cards run at once, and the gather is
the one point where the first device waits for the others.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from ..ops.ell import ELLMatrix
from ..ops.search import dense_topk_search, merge_shard_topk, top_k
from .collectives import gather_shard_topk
from .mesh import Mesh


@dataclasses.dataclass
class Shards:
    """The row shards of one matrix over a mesh axis: ``parts[i]`` lives
    on the axis' i-th device (None where another process holds it), each
    of ``rows_per`` rows; ``num_rows`` rows are real, the padding is in
    the tail."""

    parts: List[Any]
    rows_per: int
    num_rows: int
    axis_name: str = "dp"

    @property
    def padded_rows(self) -> int:
        return self.rows_per * len(self.parts)

    def local(self) -> Any:
        """The first shard this process holds."""
        return next(p for p in self.parts if p is not None)


def _pad_rows(n: int, shards: int) -> int:
    per = -(-n // shards)
    return per * shards


def _demote_padding(ids: torch.Tensor, scores: torch.Tensor, num_rows: int
                    ) -> torch.Tensor:
    """Scores of padding rows (id >= num_rows) to -inf BEFORE the merge,
    so that they never displace real rows. Padding rows score exactly 0,
    which beats real rows whenever real scores are negative (routine for
    dense DPR embeddings): mask by id range, not by score sign."""
    return torch.where(ids < num_rows, scores,
                       torch.full_like(scores, float("-inf")))


def _split(mesh: Mesh, axis_name: str, n: int, rows_per: int,
           piece: Callable[[int, int, torch.device, bool], Any],
           src_device: torch.device) -> List[Any]:
    """``piece(start, stop, device, view)`` for each position of the axis
    this process holds (None for the others). ``view``: every shard lies
    on the source's own device (virtual shards), so a shard is a view of
    the source; else each is a copy on its device, and the source can be
    freed."""
    devs = mesh.devices(axis_name)
    view = all(d == src_device for d in devs)
    return [piece(min(i * rows_per, n), min((i + 1) * rows_per, n), d, view)
            if mine else None
            for i, (d, mine) in enumerate(zip(devs,
                                              mesh.is_local(axis_name)))]


def _rows_on(t: torch.Tensor, start: int, stop: int, rows: int,
             device: torch.device, view: bool, fill=0) -> torch.Tensor:
    """Rows [start, stop) of ``t`` on ``device``, padded with ``fill`` to
    ``rows`` rows (only the tail shard pads)."""
    part = t[start:stop]
    if view and stop - start == rows:
        return part
    part = part.to(device, copy=True)
    if stop - start == rows:
        return part
    pad = torch.full((rows - (stop - start),) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=device)
    return torch.cat([part, pad])


def shard_rows(mesh: Mesh, arr: torch.Tensor, axis_name: str = "dp"
               ) -> Shards:
    """Split ``arr``'s rows over the mesh axis, the tail shard padded with
    zero rows."""
    n = int(arr.shape[0])
    per = _pad_rows(n, mesh.shape[axis_name]) // mesh.shape[axis_name]
    parts = _split(mesh, axis_name, n, per,
                   lambda a, b, d, v: _rows_on(arr, a, b, per, d, v),
                   arr.device)
    return Shards(parts, per, n, axis_name)


def shard_ell(mesh: Mesh, ell: ELLMatrix, axis_name: str = "dp",
              rows_per: Optional[int] = None) -> Shards:
    """Row-shard an ELLMatrix over the mesh axis (``rows_per`` rows a
    shard, default the fewest that hold every row). Padding rows are
    empty (nnz 0) and carry the template's own padding scheme: the
    sentinel column when ``sentinel_padded``, else column 0 (scorers mask
    by nnz only then, so sentinel pads would gather the wrong column)."""
    n = ell.shape[0]
    per = rows_per or (_pad_rows(n, mesh.shape[axis_name])
                       // mesh.shape[axis_name])
    pad_col = ell.num_cols if ell.sentinel_padded else 0

    def piece(a, b, d, v):
        return ELLMatrix(
            cols=_rows_on(ell.cols, a, b, per, d, v, pad_col),
            nnz=_rows_on(ell.nnz, a, b, per, d, v),
            vals=(None if ell.vals is None
                  else _rows_on(ell.vals, a, b, per, d, v)),
            num_cols=ell.num_cols, sentinel_padded=ell.sentinel_padded)

    return Shards(_split(mesh, axis_name, n, per, piece, ell.cols.device),
                  per, n, axis_name)


def shard_bitmat(mesh: Mesh, bitmat, axis_name: str = "dp") -> Shards:
    """Row-shard a BitMatrix (rows already padded to the kernels' row
    block) over the mesh axis, each shard a whole number of ``ROW_BLOCK``
    rows, so that kernel #3 folds the same buckets as on one device. Each
    shard is a BitMatrix of ``rows_per`` rows; ``num_rows`` stays the
    true row count."""
    from ..ops.bitpack import BitMatrix

    words = bitmat.words
    n_pad = int(words.shape[0])
    per = _bitmat_rows_per(n_pad, mesh.shape[axis_name])
    parts = _split(
        mesh, axis_name, n_pad, per,
        lambda a, b, d, v: BitMatrix(
            words=_rows_on(words, a, b, per, d, v), num_rows=per,
            num_cols=bitmat.num_cols, mean_bits=bitmat.mean_bits),
        words.device)
    return Shards(parts, per, bitmat.num_rows, axis_name)


def _bitmat_rows_per(n: int, shards: int) -> int:
    """Rows a shard of packed bits holds: a whole number of ``ROW_BLOCK``s
    (so kernel #3 folds the buckets of one device), enough for ``n``."""
    from ..ops.bitpack import ROW_BLOCK

    return -(-n // (shards * ROW_BLOCK)) * ROW_BLOCK


def pack_shards(mesh: Mesh, ell: ELLMatrix, axis_name: str = "dp"
                ) -> Shards:
    """The shards ``shard_bitmat`` makes of ``pack_ell(ell)``, packed
    shard by shard on each shard's device (kernel #1 once a shard): the
    whole packed matrix is never held in one place, and each shard's bits
    equal the same rows of the whole one (the pack is row by row)."""
    from ..ops.bitpack import BitMatrix, ell_mean_bits, pack_ell

    per = _bitmat_rows_per(ell.shape[0], mesh.shape[axis_name])
    cells = shard_ell(mesh, ell, axis_name, rows_per=per)
    # the whole index's width: each shard takes its form at its own rows
    width = ell_mean_bits(ell)
    parts = [None if c is None else
             BitMatrix(words=pack_ell(c).words, num_rows=per,
                       num_cols=ell.num_cols, mean_bits=width)
             for c in cells.parts]
    return Shards(parts, per, ell.shape[0], axis_name)


def _search_shards(mesh: Mesh, shards: Shards, q: torch.Tensor,
                   local: Callable, num_rows: int, k: int):
    """Run ``local(q on the shard's device, shard) -> (ids, scores)`` on
    every shard this process holds, offset and demote, gather and merge:
    the global (ids, scores) [B, k] on the first (local) mesh device."""
    axis = shards.axis_name
    devs = mesh.devices(axis)
    pairs, home = [], None
    for s, (part, dev) in enumerate(zip(shards.parts, devs)):
        if part is None:
            continue
        home = dev if home is None else home
        ids, scores = local(q.to(dev, non_blocking=True), part)
        ids = ids + s * shards.rows_per
        pairs.append((ids, _demote_padding(ids, scores, num_rows)))
    all_ids, all_scores = gather_shard_topk(
        pairs, home, mesh.spans_processes(axis))
    return merge_shard_topk(all_ids, all_scores, k)


def make_sharded_dense_search(mesh: Mesh, k: int, num_rows: int,
                              axis_name: str = "dp") -> Callable:
    """``search(q [B, D], shards of shard_rows) -> (ids, scores) [B, k]``.

    ``num_rows`` is the TRUE (unpadded) row count. The local k is widened
    by the pad count (< shards, all in the tail shard) so that padding
    rows in a local top-k can never displace a real global candidate;
    they are then demoted before the merge."""
    shards = mesh.shape[axis_name]
    rows_per = _pad_rows(num_rows, shards) // shards
    k_local = min(k + rows_per * shards - num_rows, rows_per)

    def search(q: torch.Tensor, vec: Shards):
        return _search_shards(
            mesh, vec, q,
            lambda qq, part: dense_topk_search(qq.to(part.dtype), part,
                                               k_local),
            num_rows, k)

    return search


def make_sharded_bitpack_search(mesh: Mesh, k: int, bitmat: Shards,
                                axis_name: str = "dp",
                                selection: str = "bucketed") -> Callable:
    """Sharded bit-packed binary search over ``shard_bitmat`` shards:
    per-shard kernel scoring and local top-k, then the merge.
    ``selection``: 'bucketed' runs the fused score-and-bucket kernel (#3)
    on each shard; 'exact' scores every row (#2) and takes a top-k. A
    shard with fewer valid buckets than k (``k * BUCKET > rows_per``)
    selects exactly, as the one-device guard does."""
    from ..ops.bitpack import (BUCKET, bitpack_bucketed_topk,
                               bitpack_scores)

    rows_per = bitmat.rows_per
    if k > bitmat.num_rows:
        raise ValueError(
            f"k={k} exceeds index rows {bitmat.num_rows}; clamp k "
            "before building the sharded search")
    if selection == "bucketed" and k * BUCKET > rows_per:
        selection = "exact"
    k_local = min(k, rows_per // BUCKET if selection == "bucketed"
                  else rows_per)

    def local(q, shard):
        # padding rows (zero bits) score 0 and sort after every real row
        # of their shard; they are demoted by id before the merge
        if selection == "bucketed":
            return bitpack_bucketed_topk(q, shard, k=k_local)
        s, i = top_k(bitpack_scores(q, shard), k_local)
        return i, s

    def search(q: torch.Tensor, bm: Shards):
        return _search_shards(mesh, bm, q.float(), local, bm.num_rows, k)

    return search


def make_sharded_ell_search(mesh: Mesh, k: int, ell_template: Shards,
                            score_fn: Callable, axis_name: str = "dp",
                            num_rows: Optional[int] = None) -> Callable:
    """Sharded sparse search over ``shard_ell`` shards.
    ``score_fn(q, ell_shard) -> [B, rows_per]`` is the one-device scorer;
    ``num_rows`` (default: the template's true rows) is the row count
    past which ids are padding."""
    if num_rows is None:
        num_rows = ell_template.num_rows
    rows_per = ell_template.rows_per
    k_local = min(k + ell_template.padded_rows - num_rows, rows_per)

    def local(q, shard):
        s, i = top_k(score_fn(q, shard), k_local)
        return i, s

    def search(q: torch.Tensor, ell: Shards):
        return _search_shards(mesh, ell, q.float(), local, num_rows, k)

    return search


def make_sharded_blockwise_search(mesh: Mesh, k: int, num_rows: int,
                                  ell_template: Shards,
                                  axis_name: str = "dp",
                                  selection: str = "bucketed",
                                  block_rows: int = 1 << 18,
                                  cand_budget: int = 0) -> Callable:
    """The block tier under a mesh: each shard holds its rows as a compact
    ELL on its device and scores them block by block
    (``ops.bitpack.bitpack_blockwise_topk``: the pack #1, then #2, #3 or
    #4 a block), then the merge. Serves indexes whose packed form exceeds
    even one shard's device. ``ell_template``: ``shard_ell`` shards of a
    binary ELL (no vals); ``num_rows`` the true row count."""
    from ..ops.bitpack import bitpack_blockwise_topk

    if ell_template.local().vals is not None:
        raise ValueError("blockwise sharded search is binary "
                         "(bag-of-token) only")
    if k > num_rows:
        raise ValueError(f"k={k} exceeds index rows {num_rows}; clamp "
                         "k before building the sharded search")
    rows_per = ell_template.rows_per
    k_local = min(k + ell_template.padded_rows - num_rows, rows_per)
    num_cols = ell_template.local().num_cols

    def local(q, shard):
        return bitpack_blockwise_topk(
            q, shard.cols, shard.nnz, num_cols=num_cols, k=k_local,
            block_rows=block_rows, selection=selection,
            cand_budget=cand_budget)

    def search(q: torch.Tensor, ell: Shards):
        return _search_shards(mesh, ell, q.float(), local, num_rows, k)

    return search
