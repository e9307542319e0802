"""Device meshes (counterpart of ``vsearch_tpu/parallel/mesh.py``).

A ``Mesh`` is a ``(dp, tp)`` grid of ``torch.device``s. Sharded code
walks the devices of one axis: index rows split over ``dp`` (or ``tp``)
and each device scores its own rows (``parallel.sharded_search``); embed
batches split row-wise over ``dp`` (``models.encoder_base``).

A mesh lives in one process unless a ``torch.distributed`` group is up
when ``make_mesh`` is called without ``devices``:
the mesh then spans the ranks, one grid row (a line of ``tp`` devices)
each, and every rank holds and scores only its own shards
(``Mesh.is_local``); the candidates travel between ranks by
``collectives.gather_shard_topk``. A rank's ``tp`` line is its own
(``Mesh.devices("tp")``): under NCCL rank r of a node holds cards
``r*tp .. r*tp+tp-1``, under gloo the CPU ``tp`` times, so a search over
``tp`` stays in the rank (``Mesh.spans_processes``). Alone, ``make_mesh``'s
``device`` starts the line. Training splits the VDR head's vocabulary
over that line (``train/step.py``). An explicit
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
            # this process's row: its dp rank's line (row 0 in one process)
            own = next((i for i, r in enumerate(self.ranks)
                        if r[0] == self.rank), 0)
            return list(grid[own])
        raise ValueError(f"unknown mesh axis {axis_name!r} (axes {AXES})")

    def devices(self, axis_name: str = "dp") -> List[torch.device]:
        """The devices along ``axis_name``: the grid's first column for
        ``dp`` (an index sharded over ``dp`` is replicated over ``tp``),
        this process's row for ``tp`` (the first row in a mesh of one
        process: an index sharded over ``tp`` is replicated over ``dp``)."""
        return self._line(self.grid, axis_name)

    def is_local(self, axis_name: str = "dp") -> List[bool]:
        """Whether this process holds each position along ``axis_name``."""
        return [r == self.rank for r in self._line(self.ranks, axis_name)]

    @property
    def multiprocess(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)

    def spans_processes(self, axis_name: str = "dp") -> bool:
        """Whether other processes hold positions along ``axis_name`` (a
        search over it then gathers their candidates): a group's ``dp``
        does, a rank's own ``tp`` line does not."""
        return not all(self.is_local(axis_name))

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, "
                f"devices={[str(d) for row in self.grid for d in row]}"
                + (", ranks=" + str(self.ranks) if self.multiprocess
                   else "") + ")")


def _tp_line(lead: torch.device, tp: int) -> List[torch.device]:
    """``tp`` devices from ``lead``: the next cards after a card, else
    ``lead`` ``tp`` times (the CPU)."""
    if lead.type == "cuda":
        return [torch.device("cuda", lead.index + j) for j in range(tp)]
    return [lead] * tp


def _default_devices(tp: int = 1, device: Optional[DeviceLike] = None
                     ) -> tuple:
    """(devices, ranks, rank): in an initialised process group, a line of
    ``tp`` devices per rank in rank order, ``ranks`` naming each one's
    owner; this rank's line starts at ``collectives.local_device(tp)``,
    and the other ranks' lines repeat it, as only their owners use them.
    Without a group: the line of ``tp`` devices that starts at ``device``
    when one is asked for, else every CUDA device of this process."""
    from . import collectives

    if collectives.group_up():
        line = _tp_line(collectives.local_device(tp), tp)
        world = collectives.get_world_size()
        return (line * world, [r for r in range(world) for _ in line],
                collectives.get_rank())
    if device is not None:
        return _tp_line(_device(device), tp), None, 0
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)], None, 0


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None,
              device: Optional[DeviceLike] = None) -> Mesh:
    """Create a (dp, tp) mesh over ``devices`` (default: a line of ``tp``
    devices per rank of a process group; alone, the line from ``device``,
    else this machine's CUDA devices). Too few devices, or a default line
    past the last card, raise with the mesh arithmetic; an explicit
    ``devices`` may repeat one (virtual shards)."""
    ranks, rank = None, 0
    if devices is None:
        devices, ranks, rank = _default_devices(tp, device)
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n == 0 and dp is None:
        raise ValueError("make_mesh: no CUDA device; pass devices=[...] "
                         "(e.g. ['cpu'] * 8 for virtual shards on the host)")
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    absent = [str(d) for d in devices[: dp * tp]
              if d.type == "cuda" and d.index >= cards]
    if dp * tp > n or absent:
        # fail with the mesh arithmetic
        raise ValueError(
            f"mesh dp={dp} x tp={tp} needs {dp * tp} devices but only "
            f"{cards if absent else n} are available"
            + (f" ({absent[0]} is not there)" if absent else ""))
    if dp * tp != len(devices):
        logger.warning("mesh dp=%d x tp=%d uses %d of %d devices; the rest "
                       "stay idle", dp, tp, dp * tp, len(devices))
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
