"""The training step (counterpart of ``vsearch_tpu/train/step.py``).

One call runs both encoder forwards in train mode, the bag-of-words
masks, the 4-term semi-parametric InfoNCE over in-batch and hard
negatives, the backward pass, the global norm and its clip, and the AdamW
update. PyTorch runs it eagerly; nothing in it waits for the device, so
consecutive steps queue on the card.

Weights are f32 (the optimizer's master copy); the forward computes in the
encoder's configured dtype under ``torch.autocast`` (``models.encoder_base
.compute_context``). Unlike flax's ``dtype=bfloat16``, which runs every
layer in bf16, autocast keeps LayerNorm, softmax and the residual stream in
f32 and casts the inputs of each matmul to bf16.

Dropout draws from the global generator, forked and seeded for each step
from the caller's integer (the trainer derives it from
``(seed, epoch, iteration, rank)``), so a step is repeatable, a resumed run
repeats the masks of an uninterrupted one, and ``remat`` recomputes the
same masks (``torch.utils.checkpoint`` restores the generator's state).

Data parallel (a ``torch.distributed`` group of W ranks, one card each, as
``torchrun`` starts them): each rank embeds its own batch, and the
embeddings and token ids of every rank are gathered
(``parallel.collectives.differentiable_all_gather``, the reference's
``GatherLayer``) into the global batch, positives of every rank first, so
that every rank computes the loss of the JAX step under SPMD over the
global batch. The gather's backward pass sums the W ranks' (equal) losses'
gradients, W times the global gradient of this rank's rows; averaging the
gradients over the ranks (``average_gradients``) divides W out again, so
every rank clips and updates with the gradient of the global-batch loss.

Tensor parallel (the mesh's ``tp`` axis, the JAX package's "vocab/tensor"
axis): the JAX step lays the [B, V'] embeddings out ``P("dp", "tp")``,
which splits the VDR head's vocabulary, and with it the [B*L, V']
projection logits (the step's largest activation, ~1.9 GB a side at 64
passages of 256 tokens), over the tp devices. Here a process's tp line
(``mesh.devices("tp")``, its first device the module's own, the "lead")
does the same: the BERT trunk runs once on the lead, each tp device pools
its contiguous slice of the vocabulary from a copy of the trunk's output
(``models/vdr.py``, ``encoder_base.set_tp``), the slices come back to
the lead in vocabulary order, and the norm, the loss, the backward pass
and the update run there as at ``tp=1``. The copies are plain
differentiable ``.to``s, so no collective runs on the tp axis, and on
virtual shards of one device they are no-ops. Dropout lives in the trunk
alone, so ``tp`` changes no mask. DPR has no vocabulary head: at
``tp > 1`` it computes on the lead what ``tp=1`` computes (the JAX layout
of its [B, 768] output moves no arithmetic). A process is one dp rank
whatever its tp: data shards and dropout seeds follow the process rank.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..models.encoder_base import (compute_context, compute_dtype,
                                   set_remat, set_tp)
from ..ops.sparse import build_bow_mask
from ..parallel.collectives import (average_gradients,
                                    differentiable_all_gather,
                                    get_world_size, group_up)
from .loss import VDRLossConfig, compute_dpr_loss, compute_vdr_loss
from .optim import Optimizer

logger = logging.getLogger(__name__)


class TrainBatch(NamedTuple):
    """Device-side batch: queries [N, Lq], passages [M, Lp] (int64, 0 is
    padding) with positives in the first N rows (reference
    biencoder_utils.py:86-87)."""

    q_ids: torch.Tensor
    p_ids: torch.Tensor


class TrainState:
    """The step count, the trained module (one encoder's module when it is
    shared, else an ``nn.ModuleDict`` of ``q`` and ``p``: its parameters
    are the f32 weights) and the optimizer over it."""

    def __init__(self, module: nn.Module, tx: Optimizer, step: int = 0):
        self.module = module
        self.tx = tx
        self.step = step

    @classmethod
    def create(cls, module: nn.Module, tx: Optimizer) -> "TrainState":
        return cls(module, tx)

    @property
    def params(self):
        """The f32 weights by name (``q.``/``p.`` prefixes unless the
        encoder is shared)."""
        return self.module.state_dict()


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    encoder_type: str = "vdr"  # 'vdr' | 'dpr'
    vocab_size: int = 30522
    shift_vocab_num: int = 999
    norm_bow: bool = False
    loss: VDRLossConfig = dataclasses.field(default_factory=VDRLossConfig)


def step_seed(seed: int, epoch: int, iteration: int, rank: int = 0) -> int:
    """A 63-bit seed for the step's dropout, distinct for every
    ``(seed, epoch, iteration, rank)`` (rank 0's is the one-process
    seed)."""
    import numpy as np

    entropy = [seed, epoch, iteration] + ([rank] if rank else [])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & ((1 << 63) - 1)


def _fork_devices(t: torch.Tensor):
    return [t.device.index or 0] if t.device.type == "cuda" else []


def check_mesh(mesh) -> None:
    """A training mesh is the process group along ``dp`` (its world size,
    one process a rank) and this process's devices along ``tp`` (module
    docstring)."""
    if mesh is None:
        return
    if mesh.shape["dp"] != get_world_size():
        raise ValueError(
            f"mesh dp={mesh.shape['dp']} != world size {get_world_size()}: "
            "data-parallel training runs one process a card, or a tp line "
            "of cards (torchrun --nproc_per_node N, WORLD_SIZE=N)")


def _global_rows(emb: torch.Tensor, n_local: int) -> torch.Tensor:
    """Every rank's rows of ``emb`` (queries, or passages with the rank's
    positives in its first ``n_local`` rows) in the layout of one batch
    over all ranks: positives of every rank in rank order, then the other
    rows of every rank in rank order."""
    if not group_up():
        return emb
    pos = differentiable_all_gather(emb[:n_local]).flatten(0, 1)
    if emb.shape[0] == n_local:  # queries: no other rows
        return pos
    rest = differentiable_all_gather(emb[n_local:]).flatten(0, 1)
    return torch.cat([pos, rest])


def make_train_step(apply_q: Callable, apply_p: Callable,
                    cfg: TrainStepConfig, mesh=None,
                    shared_params: bool = False) -> Callable:
    """Build the train step ``step_fn(state, batch, seed) -> (state,
    metrics)``; ``state`` is updated in place and returned. Metrics are
    device scalars: ``loss``, ``grad_norm`` (the unclipped global norm),
    ``correct_parametric``, ``correct_semiparametric``, ``batch_size``.

    apply_q/apply_p: fns (module, ids) -> embeddings (``make_encoder_apply``).
    With ``shared_params`` both run the state's one module (reference
    shared_encoder, biencoder.py:57-59), else its ``q`` and ``p``.

    In a process group of more than one rank each rank passes its own
    batch, and the loss, metrics and update are those of the global batch
    (module docstring); ``mesh`` (optional) must match the group
    (``check_mesh``).
    """
    check_mesh(mesh)
    if (mesh is not None and mesh.shape["tp"] > 1
            and cfg.encoder_type != "vdr"):
        logger.info("mesh tp=%d: the %s encoder has no vocabulary head; it "
                    "computes on the lead device what tp=1 computes",
                    mesh.shape["tp"], cfg.encoder_type)

    def loss_fn(state: TrainState, batch: TrainBatch):
        m_q = state.module if shared_params else state.module["q"]
        m_p = state.module if shared_params else state.module["p"]
        n = batch.q_ids.shape[0]
        q_emb = _global_rows(apply_q(m_q, batch.q_ids), n)
        p_emb = _global_rows(apply_p(m_p, batch.p_ids), n)
        q_ids = _global_rows(batch.q_ids, n)
        p_ids = _global_rows(batch.p_ids, n)
        if cfg.encoder_type == "vdr":
            q_bin, p_bin = (build_bow_mask(ids, vocab_size=cfg.vocab_size,
                                           shift_num=cfg.shift_vocab_num,
                                           norm=cfg.norm_bow,
                                           dtype=emb.dtype)
                            for ids, emb in ((q_ids, q_emb),
                                             (p_ids, p_emb)))
            return compute_vdr_loss(q_emb, p_emb, q_bin, p_bin, cfg.loss)
        if cfg.encoder_type == "dpr":
            return compute_dpr_loss(q_emb, p_emb, cfg.loss)
        raise NotImplementedError(cfg.encoder_type)

    def step_fn(state: TrainState, batch: TrainBatch, seed: int):
        state.tx.zero_grad()
        state.module.train()
        try:
            with torch.random.fork_rng(devices=_fork_devices(batch.q_ids),
                                       device_type="cuda"):
                torch.manual_seed(seed)
                loss, metrics = loss_fn(state, batch)
                loss.backward()
        finally:
            state.module.eval()
        average_gradients(list(state.module.parameters()))
        norm = state.tx.step()
        state.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        return state, metrics

    return step_fn


def make_encoder_apply(module: nn.Module, deterministic: bool = False,
                       remat: bool = False, mesh=None) -> Callable:
    """The ``(module, ids) -> embeddings`` function of the train step for
    an encoder ``module``. Attention mask and token types are derived from
    the ids (ids != 0, zeros — reference loss_utils.py:38-41); the forward
    computes in the module's configured dtype. ``deterministic`` turns
    dropout off.

    ``remat=True`` checkpoints ``module``'s BERT layers and the VDR head's
    pooling chunks (``torch.utils.checkpoint``, non-reentrant), so the
    backward pass recomputes them instead of keeping every layer's
    activations and the [B*L, chunk] f32 projection logits of the
    max-pool (~1.9 GB for 64 passages of 256 tokens at V'=29,523).

    ``mesh``: the VDR head's vocabulary splits over this process's tp line
    (module docstring), whose first device must hold ``module``, in each
    forward of ``apply``; without a mesh there is no split.
    """
    set_remat(module, remat)
    devices = None
    if mesh is not None and mesh.shape["tp"] > 1:
        devices = mesh.devices("tp")
        home = next(module.parameters()).device
        if devices[0] != home:
            raise ValueError(
                f"the tp line {[str(d) for d in devices]} must start at the "
                f"module's device {home}: the trunk runs there")
    dtype = compute_dtype(module.config)

    def apply(mod: nn.Module, ids: torch.Tensor) -> torch.Tensor:
        mod.train(not deterministic)
        # the split holds for this forward alone (its backward pass reads
        # only what the forward recorded): embed and mining outside the
        # step run unsplit
        set_tp(mod, devices)
        try:
            with compute_context(mod, dtype):
                return mod(ids, torch.zeros_like(ids), (ids != 0).long())
        finally:
            set_tp(mod, None)

    return apply


__all__ = ["TrainBatch", "TrainState", "TrainStepConfig", "make_train_step",
           "make_encoder_apply", "step_seed", "check_mesh"]
