"""Collectives on ``torch.distributed`` (counterpart of
``vsearch_tpu/parallel/collectives.py``, after the reference's
src/ir/training/ddp_utils.py).

- ``initialize_distributed``: the process group of a ``torchrun`` launch
  (NCCL on CUDA devices; gloo only when the caller asks for the CPU).
- ``differentiable_all_gather``: the reference's ``GatherLayer``: every
  rank's rows in rank order, with a backward pass that sums the incoming
  gradients over the ranks and returns this rank's slice.
- ``all_gather_objects``: picklable objects from every rank.
- ``gather_shard_topk``: the (ids, scores) candidates of sharded search,
  by peer copies within a process and ``all_gather_into_tensor`` across
  processes.

Without an initialised group every function is its one-process identity:
rank 0 of 1. In a group of one rank the collectives still run (a
``torchrun`` launch of one process exercises NCCL on its card).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def group_up() -> bool:
    """Whether a ``torch.distributed`` process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """Process rank (reference ddp_utils.py:9-15); 0 without a group."""
    return dist.get_rank() if group_up() else 0


def get_world_size() -> int:
    return dist.get_world_size() if group_up() else 1


def is_master() -> bool:
    return get_rank() == 0


def local_device(tp: int = 1) -> torch.device:
    """This rank's device, the lead of its line of ``tp``: ``cuda:LOCAL_RANK
    * tp`` under NCCL (rank r of a node holds cards ``r*tp .. r*tp+tp-1``;
    ``mesh.make_mesh`` checks that they are there), the CPU under gloo (and
    without a group, the same card when there is one)."""
    if group_up() and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) * tp)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Form the process group of a multi-process launch (replaces the
    reference's init_process_group(backend='nccl'), conf_utils.py:19-49).

    Arguments fall back to ``torchrun``'s environment, as the JAX
    package's do: ``COORDINATOR_ADDRESS`` (or ``MASTER_ADDR:MASTER_PORT``),
    ``WORLD_SIZE``, ``RANK``. The backend is NCCL for a CUDA ``device``
    (set as this process's current device) and gloo only for
    ``device="cpu"``; a missing CUDA raises. Returns True when running
    distributed (formed now or earlier), False for a single process (no
    coordinator address)."""
    from ..device import resolve_device

    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "1234")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return False  # single process
    if group_up():
        return True
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the world "
            "size and rank: pass num_processes and process_id, or set "
            "WORLD_SIZE and RANK")
    dev = resolve_device(device)
    if dev.type == "cuda":  # a bare "cuda" is this rank's card
        torch.cuda.set_device(dev if dev.index is not None
                              else local_device())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


class _GatherLayer(torch.autograd.Function):
    """all_gather whose gradient reaches every rank's own rows."""

    @staticmethod
    def forward(ctx, x):
        out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(out, x.contiguous())
        return torch.stack(out)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads every rank's rows: the gradient of this
        # rank's rows is the sum of what each rank's loss sends back
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad[dist.get_rank()]


def differentiable_all_gather(x: torch.Tensor) -> torch.Tensor:
    """[world, *x.shape]: every rank's ``x`` in rank order (the JAX
    package's ``jax.lax.all_gather``). Gradients flow back to each rank's
    own ``x``, summed over the ranks' losses: with every rank computing
    the same global loss, that is ``world`` times its gradient, which the
    average of the gradients over ranks (``average_gradients``) divides
    out again. Without a group: ``x[None]``."""
    if not group_up():
        return x[None]
    if not x.is_floating_point():  # token ids: no gradient
        out = [torch.empty_like(x) for _ in range(get_world_size())]
        dist.all_gather(out, x.contiguous())
        return torch.stack(out)
    return _GatherLayer.apply(x)


def average_gradients(params: Sequence[torch.Tensor]) -> None:
    """Average the ``.grad`` of ``params`` over the ranks in place: one
    all-reduce of one flat buffer (what DDP's buckets do)."""
    if not group_up():
        return
    world = get_world_size()
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_from_master(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's (what DDP does to a
    module's weights when it wraps it)."""
    if not group_up():
        return
    for t in tensors:
        dist.broadcast(t, src=0)


def all_gather_objects(obj: Any, max_bytes: int = 1 << 20) -> List[Any]:
    """Gather picklable objects from every rank; ``[obj]`` for one
    process. The size check is collective: were one rank to raise on its
    own while the others entered the gather, they would wait forever."""
    if get_world_size() == 1:
        return [obj]
    payload = pickle.dumps(obj)
    sizes = [None] * get_world_size()
    dist.all_gather_object(sizes, len(payload) + 8)
    max_size = max(sizes)
    if max_size > max_bytes:
        raise ValueError(
            f"an object of {max_size - 8} bytes (largest across "
            f"processes) exceeds max_bytes {max_bytes}; pass a larger "
            "max_bytes")
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_shard_topk(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      device: torch.device, multiprocess: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack the (ids, scores) [B, k_local] of this process's shards on
    ``device``: [S_local, B, k_local] each, by peer copies (no copy where
    a shard lives on ``device``). ``multiprocess``: the searched axis spans
    the ranks (``Mesh.spans_processes``), every rank holds the
    same number of shards of the same shape, and the ranks' stacks are
    concatenated in rank order by ``all_gather_into_tensor``, as the JAX
    package's cross-process mesh gathers them."""
    ids = torch.stack([i.to(device, non_blocking=True) for i, _ in pairs])
    scores = torch.stack([s.to(device, non_blocking=True)
                          for _, s in pairs])
    if not multiprocess:
        return ids, scores
    world = get_world_size()
    out = []
    for t in (ids, scores):
        full = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=device)
        dist.all_gather_into_tensor(full, t.contiguous())
        out.append(full)
    return out[0], out[1]
