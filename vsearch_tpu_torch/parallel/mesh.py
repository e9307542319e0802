"""Device meshes (counterpart of ``vsearch_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``(dp, tp)`` grid of ``torch.device``s. Sharded code
walks the devices of one axis: index rows split over ``dp`` (or ``tp``)
and each device scores its own rows (``parallel.sharded_search``); embed
batches split row-wise over ``dp`` (``models.encoder_base``).

A mesh lives in one process unless a ``torch.distributed`` group is up
when ``make_mesh`` is called without ``devices``:
the mesh then spans the ranks, one device each, and every rank holds and
scores only its own shards (``Mesh.is_local``); the candidates travel
between ranks by ``collectives.gather_shard_topk``. An explicit
``devices`` list always makes a mesh of this process, and may name one
device more than once: such virtual shards (the tests' ``["cpu"] * 8``,
``chip_smoke.py``'s ``[cuda:0] * 4``) are what the JAX tests' virtual CPU
devices are.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Union

import torch

logger = logging.getLogger(__name__)

AXES = ("dp", "tp")
DeviceLike = Union[str, torch.device]


def _device(d: DeviceLike) -> torch.device:
    """``d`` as a ``torch.device``, ``cuda`` with its index (the current
    card), so that a repeated device compares equal to its tensors'."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``(dp, tp)`` grid of devices. ``ranks`` (same grid) names the
    process that owns each position; None means this process owns all."""

    def __init__(self, grid: Sequence[Sequence[DeviceLike]],
                 ranks: Optional[Sequence[Sequence[int]]] = None,
                 rank: int = 0):
        self.grid = [[_device(d) for d in row] for row in grid]
        self.ranks = ([[rank] * len(row) for row in self.grid]
                      if ranks is None else [list(r) for r in ranks])
        self.rank = rank

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.grid), "tp": len(self.grid[0])}

    def _line(self, grid, axis_name: str) -> list:
        if axis_name == "dp":
            return [row[0] for row in grid]
        if axis_name == "tp":
            return list(grid[0])
        raise ValueError(f"unknown mesh axis {axis_name!r} (axes {AXES})")

    def devices(self, axis_name: str = "dp") -> List[torch.device]:
        """The devices along ``axis_name`` (the first row or column of the
        grid: an index sharded over ``tp`` is replicated over ``dp``)."""
        return self._line(self.grid, axis_name)

    def is_local(self, axis_name: str = "dp") -> List[bool]:
        """Whether this process holds each position along ``axis_name``."""
        return [r == self.rank for r in self._line(self.ranks, axis_name)]

    @property
    def multiprocess(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"devices={[str(d) for row in self.grid for d in row]}"
                + (", ranks=" + str(self.ranks) if self.multiprocess
                   else "") + ")")


def _default_devices() -> tuple:
    """(devices, ranks, rank): one device per rank of an initialised
    process group (this rank's own device is
    ``collectives.local_device()``), else every CUDA device of this
    process."""
    from . import collectives

    world = collectives.get_world_size()
    if collectives.group_up():
        own = collectives.local_device()
        return [own] * world, list(range(world)), collectives.get_rank()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)], None, 0


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Create a (dp, tp) mesh over ``devices`` (default: this machine's
    CUDA devices, or one device per rank of a process group)."""
    ranks, rank = None, 0
    if devices is None:
        devices, ranks, rank = _default_devices()
    devices = list(devices)
    n = len(devices)
    if n == 0 and dp is None:
        raise ValueError("make_mesh: no CUDA device; pass devices=[...] "
                         "(e.g. ['cpu'] * 8 for virtual shards on the host)")
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        # fail with the mesh arithmetic
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {dp * tp} devices but only "
            f"{n} are available")
    if dp * tp != n:
        logger.warning("mesh dp=%d x tp=%d uses %d of %d devices; the rest "
                       "stay idle", dp, tp, dp * tp, n)
        devices = devices[: dp * tp]
        ranks = None if ranks is None else ranks[: dp * tp]
    grid = [devices[i * tp:(i + 1) * tp] for i in range(dp)]
    rgrid = (None if ranks is None
             else [ranks[i * tp:(i + 1) * tp] for i in range(dp)])
    return Mesh(grid, rgrid, rank)


def shard_batch(mesh: Mesh, x: torch.Tensor, axis_name: str = "dp"
                ) -> List[torch.Tensor]:
    """Split ``x``'s leading (batch) axis evenly over the mesh axis: one
    piece per device, each on its device (a view where the device is
    ``x``'s own)."""
    shards = mesh.shape[axis_name]
    if shards > 1 and x.shape[0] % shards:
        raise ValueError(
            f"batch dim {x.shape[0]} is not divisible by the mesh's "
            f"{axis_name}={shards}; pick a batch size that is a multiple "
            f"of {axis_name} (the batch is split across the {axis_name} "
            "axis)")
    per = x.shape[0] // shards
    return [x[i * per:(i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices(axis_name))]
