"""Deterministic sharded data iterators (a copy of
``vsearch_tpu/data/iterators.py``).

Behavioral counterpart of reference src/ir/data/ddp_iterators.py:10-305
(re-designed internals, same contract): every shard derives the same
seeded epoch permutation and takes a contiguous slice of it; the number
of iterations per epoch is fixed by the largest shard, short shards and
short final batches pad from the shard head; ``offset`` resumes
mid-epoch; multi-dataset interleaving draws each batch from exactly one
dataset on a seeded schedule. A shard is one process's part of the
data; the port's trainer runs one process on one card (shard 0 of 1).

Permutations come from numpy Generators keyed by (seed + epoch) — the
determinism contract is ours, not bit-parity with torch's shuffle.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def epoch_permutation(n: int, seed: int, epoch: int,
                      shuffle: bool = True) -> np.ndarray:
    """The shared epoch permutation every shard slices from."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(seed + epoch).permutation(n)


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    """Pure shard arithmetic: bounds and per-epoch iteration count."""

    total: int
    shard_id: int
    num_shards: int
    batch_size: int
    strict: bool

    @property
    def per_shard(self) -> int:
        return -(-self.total // self.num_shards)  # ceil

    @property
    def lo(self) -> int:
        return self.shard_id * self.per_shard

    @property
    def hi(self) -> int:
        return min(self.lo + self.per_shard, self.total)

    @property
    def max_iterations(self) -> int:
        q, r = divmod(self.per_shard, self.batch_size)
        return q + 1 if (self.strict and r) else q


def _batch_plan(n: int, batch_size: int, start_iteration: int,
                max_iterations: int, strict: bool
                ) -> Iterator[Tuple[int, int, int]]:
    """Yield (lo, hi, head_pad) ranges over a length-n index list.

    Walks the list in batch_size strides from the resume point; in
    strict mode a short final batch is topped up with head_pad items
    from the head. Afterwards, if this shard has fewer natural batches
    than the epoch's fixed iteration count (it is smaller than the
    largest shard), keep emitting head batches until the count is met.
    """
    emitted = start_iteration
    for lo in range(start_iteration * batch_size, n, batch_size):
        hi = min(lo + batch_size, n)
        pad = batch_size - (hi - lo) if strict else 0
        yield lo, hi, pad
        emitted += 1
    while emitted < max_iterations:
        yield 0, min(batch_size, n), 0
        emitted += 1


class ShardedDataIterator:
    """One dataset, one shard (reference ddp_iterators.py:10-129 —
    including the intended behavior of its strict-batch bug)."""

    def __init__(self, dataset, shard_id: int = 0, num_shards: int = 1,
                 batch_size: int = 1, shuffle: bool = True,
                 shuffle_seed: int = 0, offset: int = 0,
                 strict_batch_size: bool = False,
                 total: Optional[int] = None):
        self.dataset = dataset
        # ``total`` overrides len(dataset) for local-shard loading,
        # where geometry must be computed from the FULL row count
        # before each process loads only its own slice
        self.geometry = ShardGeometry(
            total=total if total is not None else len(dataset),
            shard_id=max(shard_id, 0),
            num_shards=max(num_shards, 1), batch_size=batch_size,
            strict=strict_batch_size)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self.strict_batch_size = strict_batch_size
        self.iteration = offset

    # -- introspection (surface used by the trainer/tests) -----------------
    @property
    def max_iterations(self) -> int:
        return self.geometry.max_iterations

    @property
    def shard_start_idx(self) -> int:
        return self.geometry.lo

    @property
    def shard_end_idx(self) -> int:
        return self.geometry.hi

    def total_data_len(self) -> int:
        return len(self.dataset)

    def iterations_num(self) -> int:
        return self.max_iterations - self.iteration

    def max_iterations_num(self) -> int:
        return self.max_iterations

    def get_iteration(self) -> int:
        return self.iteration

    def get_dataset(self):
        return self.dataset

    # -- iteration ----------------------------------------------------------
    def get_shard_indices(self, epoch: int) -> np.ndarray:
        perm = epoch_permutation(len(self.dataset), self.shuffle_seed,
                                 epoch, self.shuffle)
        return perm[self.geometry.lo: self.geometry.hi]

    def _materialize(self, indices: np.ndarray, lo: int, hi: int,
                     pad: int) -> List:
        rows = np.concatenate([indices[lo:hi], indices[:pad]]) if pad \
            else indices[lo:hi]
        return [self.dataset[int(i)] for i in rows]

    def iterate_ds_data(self, epoch: int = 0) -> Iterator[List]:
        indices = self.get_shard_indices(epoch)
        for lo, hi, pad in _batch_plan(len(indices), self.batch_size,
                                       self.iteration,
                                       self.max_iterations,
                                       self.strict_batch_size):
            self.iteration += 1
            yield self._materialize(indices, lo, hi, pad)
        self.iteration = 0

    def iterate_ds_sampled_data(self, num_iterations: int,
                                epoch: int = 0, skip: int = 0
                                ) -> Iterator[List]:
        """Exactly ``num_iterations - skip`` batches, cycling through the
        shard; ``skip`` fast-forwards past the first batches of the
        epoch (mid-epoch resume) without materializing them."""
        self.iteration = skip
        indices = self.get_shard_indices(epoch)
        n = len(indices)
        pos = (skip * self.batch_size) % n if n else 0
        for _ in range(num_iterations - skip):
            rows = np.arange(pos, pos + self.batch_size) % n
            pos = (pos + self.batch_size) % n
            self.iteration += 1
            yield [self.dataset[int(indices[r])] for r in rows]
        self.iteration = 0


class LocalShardedDataIterator(ShardedDataIterator):
    """Loads only the local shard's rows; indices are then shard-local
    (reference ddp_iterators.py:132-146)."""

    def load_data(self, require_positive: bool = True,
                  require_hard_negative: bool = True):
        self.dataset.load_data(require_positive, require_hard_negative,
                               start_pos=self.geometry.lo,
                               end_pos=self.geometry.hi)
        logger.info("local shard loaded: rows [%d, %d) -> %d samples",
                    self.geometry.lo, self.geometry.hi,
                    len(self.dataset))

    def get_shard_indices(self, epoch: int) -> np.ndarray:
        return epoch_permutation(len(self.dataset), self.shuffle_seed,
                                 epoch, self.shuffle)


class MultiSetDataIterator:
    """Interleaves multiple datasets; each batch comes from exactly one
    dataset on a seeded schedule (reference ddp_iterators.py:150-253)."""

    def __init__(self, datasets: List[ShardedDataIterator],
                 shuffle_seed: int = 0, shuffle: bool = True,
                 sampling_rates: Optional[Sequence[float]] = None,
                 rank: int = 0, offset: int = 0):
        self.iterables = datasets
        self.shuffle_seed = shuffle_seed
        self.shuffle = shuffle
        self.iteration = 0
        self.rank = rank
        # one-shot mid-epoch resume point: consumed by the FIRST
        # iterate_ds_data call, later epochs start at 0
        self.start_iteration = offset
        rates = sampling_rates or [1.0] * len(datasets)
        self.max_its_pr_ds = [int(ds.max_iterations_num() * r)
                              for ds, r in zip(datasets, rates)]
        self.max_iterations = sum(self.max_its_pr_ds)

    def total_data_len(self) -> int:
        return sum(it.total_data_len() for it in self.iterables)

    @property
    def total_data(self) -> int:
        return self.total_data_len()

    def get_max_iterations(self) -> int:
        return self.max_iterations

    def get_iteration(self) -> int:
        return self.iteration

    def _schedule(self, epoch: int) -> np.ndarray:
        """Source id per step: each source appears exactly its quota."""
        schedule = np.repeat(np.arange(len(self.iterables)),
                             self.max_its_pr_ds)
        if self.shuffle:
            rng = np.random.default_rng(self.shuffle_seed + epoch)
            schedule = rng.permutation(schedule)
        return schedule

    def set_start_iteration(self, offset: int):
        """Arm a one-shot mid-epoch resume point for the next epoch."""
        self.start_iteration = offset

    def iterate_ds_data(self, epoch: int = 0
                        ) -> Iterator[Tuple[List, int]]:
        schedule = self._schedule(epoch)
        start = min(self.start_iteration, len(schedule))
        self.start_iteration = 0
        # fast-forward: each source skips as many batches as it owns in
        # the consumed prefix of the schedule — identical downstream
        # batches to a straight-through run, without materializing the
        # skipped ones
        skips = (np.bincount(schedule[:start].astype(np.int64),
                             minlength=len(self.iterables))
                 if start else np.zeros(len(self.iterables), np.int64))
        streams = [it.iterate_ds_sampled_data(quota, epoch=epoch,
                                              skip=int(s))
                   for it, quota, s in zip(self.iterables,
                                           self.max_its_pr_ds, skips)]
        self.iteration = start
        for source in schedule[start:]:
            batch = next(streams[int(source)], None)
            if batch is not None:
                self.iteration += 1
                yield batch, int(source)
        for it in self.iterables:
            it.iteration = 0
        self.iteration = 0

    def get_dataset(self, ds_id: int):
        return self.iterables[ds_id].get_dataset()

    def get_datasets(self):
        return [it.get_dataset() for it in self.iterables]


def get_data_iterator(datasets: Sequence, batch_size: int,
                      is_train_set: bool = True, shuffle: bool = True,
                      shuffle_seed: int = 0, offset: int = 0,
                      rank: int = 0, num_shards: int = 1,
                      shard_id: int = 0,
                      sampling_rates: Optional[Sequence[float]] = None,
                      require_positive: bool = True,
                      require_hard_negative: bool = True,
                      local_shards: bool = False) -> MultiSetDataIterator:
    """Factory (reference ddp_iterators.py:257-305): loads data in a
    rank-randomized order (avoids FS congestion), wraps each dataset in a
    sharded iterator, interleaves."""
    load_order = np.random.default_rng(rank).permutation(len(datasets))
    if local_shards:
        # memory-reduction mode (the point of LocalShardedDataIterator,
        # reference ddp_iterators.py:132-146): geometry comes from the
        # full line count, then each process parses ONLY its own slice.
        # The reference factory full-loaded every dataset and never
        # invoked the local load — every shard then iterated the same
        # head slice of one shared permutation (implement as intended).
        sharded = []
        for ds in datasets:
            it = LocalShardedDataIterator(
                ds, shard_id=shard_id, num_shards=num_shards,
                batch_size=batch_size, shuffle=shuffle,
                shuffle_seed=shuffle_seed, offset=offset,
                total=ds.calc_total_data_len())
            if is_train_set:
                it.load_data(require_positive, require_hard_negative)
            else:
                # same filter defaults as the non-local eval branch
                # (ds.load_data() keeps require_positive=True) — a
                # divergence here would both skew eval sample sets by
                # flag and crash batch creation on positive-less rows
                it.load_data()
            sharded.append(it)
    else:
        for i in load_order:
            ds = datasets[int(i)]
            if is_train_set:
                ds.load_data(require_positive, require_hard_negative)
            else:
                ds.load_data()
        sharded = [ShardedDataIterator(
            ds, shard_id=shard_id, num_shards=num_shards,
            batch_size=batch_size, shuffle=shuffle,
            shuffle_seed=shuffle_seed, offset=offset)
            for ds in datasets]
    # eval: every dataset iterates fully (the reference passed the
    # literal [1], which zip-truncated the quota list to ONE dataset)
    return MultiSetDataIterator(
        sharded, shuffle_seed, shuffle,
        sampling_rates=sampling_rates if is_train_set else None,
        rank=rank, offset=offset)
