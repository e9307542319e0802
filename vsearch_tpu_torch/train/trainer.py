"""RetrieverTrainer: the host-side training loop (counterpart of
``vsearch_tpu/train/trainer.py``).

The loop draws sample batches, tokenizes them to static shapes, uploads
them and runs the train step (``train/step.py``) on one device. Under a
``torch.distributed`` group (``torchrun``, one process a card) each rank
reads its own shard of the data, ``batch_size`` samples a step, and the
step trains on the global batch of every rank; rank 0 alone writes the
checkpoints, which every rank can resume from. A mesh with a ``tp``
axis splits the VDR head's vocabulary over this process's tp devices
(``train/step.py``). Metric
sums stay on the device and are read only at log points, so steps queue
on the card without the host waiting for each. Train-state checkpoints
(weights, optimizer, step, iterator offset) give mid-epoch resume.

The encoders' modules are trained in place: their weights become f32
master weights when the trainer is made, and ``embed`` (negative mining,
the info card, evaluation) runs on those live weights in the configured
compute dtype.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import random as pyrandom
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.batching import _encode_fixed, create_biencoder_batch
from ..data.iterators import MultiSetDataIterator, get_data_iterator
from ..parallel.collectives import (broadcast_from_master, get_rank,
                                    get_world_size, is_master)
from ..retriever import Retriever
from .checkpoint import (load_checkpoint, resolve_checkpoint_dir,
                         save_checkpoint)
from .info_card import InfoCard
from .loss import VDRLossConfig
from .optim import get_optimizer, get_schedule_linear
from .step import (TrainBatch, TrainState, TrainStepConfig, check_mesh,
                   make_encoder_apply, make_train_step, step_seed)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    """Counterpart of reference conf/train/*.yaml fields."""

    batch_size: int = 32
    num_train_epochs: int = 80
    adam_eps: float = 1e-8
    learning_rate: float = 2e-5
    max_grad_norm: float = 2.0
    weight_decay: float = 0.0
    num_warmup_epochs: int = 1
    num_epoch_to_save: int = 10
    sym_loss: bool = True
    semi: bool = True
    scaled_loss: bool = False
    temperature: float = 1.0  # softmax temperature (loss_utils.py:358)
    # negatives
    hard_negatives: int = 1
    other_negatives: int = 0
    ret_negatives: int = 0
    ret_topk: int = 20
    ret_dropout: float = 0.0
    negative_pool_size: int = 100
    # data
    train_insert_title: bool = True
    require_positive: bool = True
    require_hard_negative: bool = True
    train_sampling_rates: Optional[List[float]] = None
    # cts mask
    cts_mask: bool = False
    cts_mask_weight: float = 1.0
    cts_mask_norm: bool = False
    # memory
    remat: bool = False  # recompute BERT layers / pooling in backward
    # input pipeline: batches prepared ahead on a producer thread
    # (tokenize + host->device upload overlap step compute); 0 = produce
    # inline. Ignored when ret_negatives is on (mining must see the
    # current weights every batch).
    prefetch_batches: int = 2
    # logging / bookkeeping
    log_batch_step: int = 100
    train_rolling_loss_step: int = 100
    # mid-epoch train-state saves every N steps (0 = epoch-end only);
    # each save records the iterator offset so resume restarts on the
    # exact next batch
    save_steps: int = 0
    seed: int = 12345
    output_dir: str = "./output"
    save_name_prefix: str = "checkpoint"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        clean = {k: v for k, v in d.items() if k in known and v is not None}
        return cls(**clean)


class RetrieverTrainer:
    def __init__(self, retriever: Retriever, train_cfg: TrainConfig,
                 datasets: Sequence, mesh=None,
                 dev_datasets: Optional[Sequence] = None):
        check_mesh(mesh)
        self.mesh = mesh
        self.retriever = retriever
        self.cfg = train_cfg
        self.datasets = list(datasets)
        self.dev_datasets = list(dev_datasets or [])
        self.start_epoch = 0
        self.start_batch = 0
        self.device = retriever.device

        enc_q = retriever.encoder_q
        enc_p = retriever.encoder_p
        self.shared = retriever.config.shared_encoder
        self.enc_type = getattr(enc_q.config, "type", "vdr")
        # f32 master weights, trained in place: the encoders keep
        # computing in their configured dtype (autocast) on these weights
        for enc in (enc_q, enc_p):
            enc.module.float()
        self.module: nn.Module = (
            enc_q.module if self.shared
            else nn.ModuleDict({"q": enc_q.module, "p": enc_p.module}))
        # every rank starts from rank 0's weights
        broadcast_from_master(list(self.module.state_dict().values()))

        loss_cfg = VDRLossConfig(
            semi=train_cfg.semi, sym_loss=train_cfg.sym_loss,
            scaled_loss=train_cfg.scaled_loss,
            temperature=train_cfg.temperature,
            topk=getattr(enc_q.config, "topk", 768) or 768,
            cts_mask=train_cfg.cts_mask,
            cts_mask_weight=train_cfg.cts_mask_weight,
            cts_mask_norm=train_cfg.cts_mask_norm)
        self.step_cfg = TrainStepConfig(
            encoder_type=self.enc_type,
            vocab_size=getattr(enc_q.config, "vocab_size", 30522),
            shift_vocab_num=getattr(enc_q.config, "shift_vocab_num", 0),
            norm_bow=getattr(enc_q.config, "norm", False),
            loss=loss_cfg)
        self._apply_q = make_encoder_apply(enc_q.module,
                                           deterministic=False,
                                           remat=train_cfg.remat, mesh=mesh)
        self._apply_p = make_encoder_apply(enc_p.module,
                                           deterministic=False,
                                           remat=train_cfg.remat, mesh=mesh)
        self.state: Optional[TrainState] = None
        self._step_fn = None

    # -- setup -------------------------------------------------------------
    def _build_iterator(self, offset: int = 0) -> MultiSetDataIterator:
        # each rank reads only its own shard of the data (the reference's
        # per-rank ShardedDataIterator, src/ir/data/ddp_iterators.py:78-85);
        # cfg.batch_size is the PER-RANK batch. A process is one dp rank
        # whatever the mesh's tp (its tp devices are its own), so the shard
        # and the step seeds follow the process rank.
        assert self.mesh is None or self.mesh.shape["dp"] == get_world_size()
        return get_data_iterator(
            self.datasets, self.cfg.batch_size, is_train_set=True,
            shuffle=True, shuffle_seed=self.cfg.seed, offset=offset,
            rank=get_rank(), num_shards=get_world_size(),
            shard_id=get_rank(),
            sampling_rates=self.cfg.train_sampling_rates,
            require_positive=self.cfg.require_positive,
            require_hard_negative=self.cfg.require_hard_negative)

    def _init_state(self, updates_per_epoch: int):
        total_updates = updates_per_epoch * self.cfg.num_train_epochs
        warmup = self.cfg.num_warmup_epochs * updates_per_epoch
        schedule = get_schedule_linear(warmup, total_updates,
                                       self.cfg.learning_rate)
        self._schedule = schedule
        tx = get_optimizer([self.module],
                           learning_rate=self.cfg.learning_rate,
                           adam_eps=self.cfg.adam_eps,
                           weight_decay=self.cfg.weight_decay,
                           max_grad_norm=self.cfg.max_grad_norm,
                           schedule=schedule)
        self.state = TrainState.create(self.module, tx)
        self._step_fn = make_train_step(
            self._apply_q, self._apply_p, self.step_cfg, mesh=self.mesh,
            shared_params=self.shared)

    def resume(self, directory: Optional[str] = None) -> bool:
        """Restore the full train state written by
        ``save_train_checkpoint`` (``output_dir/train_state`` — NOT the
        model-only ``checkpoint_<n>`` dirs, which hold HF weights
        without optimizer/step state). Returns True when a checkpoint
        was loaded."""
        if directory is None:
            directory = resolve_checkpoint_dir(
                os.path.join(self.cfg.output_dir, "train_state"))
            if directory is None:
                logger.info("no train_state checkpoint under %s — "
                            "starting fresh", self.cfg.output_dir)
                return False
        if self.state is None:
            return False
        self.state, meta = load_checkpoint(directory, self.state)
        self.start_epoch = int(meta.get("epoch", 0))
        self.start_batch = int(meta.get("offset", 0))
        logger.info("resumed from %s at epoch=%d offset=%d", directory,
                    self.start_epoch, self.start_batch)
        return True

    # -- training ----------------------------------------------------------
    def run_train(self, resume: bool = False):
        cfg = self.cfg
        it = self._build_iterator(offset=self.start_batch)
        updates_per_epoch = it.get_max_iterations()
        if updates_per_epoch == 0:
            logger.warning("no data found for training")
            return
        self._init_state(updates_per_epoch)
        resumed = self.resume() if resume else False
        if resumed:
            # the iterator above was built before the checkpoint meta
            # was known; arm its one-shot mid-epoch offset now (epoch
            # permutations are keyed by (seed, epoch), so no reload is
            # needed — only the resume point changes)
            it.set_start_iteration(self.start_batch)
        logger.info("total updates=%d",
                    updates_per_epoch * cfg.num_train_epochs)
        if not resumed:
            self.save_model_checkpoint("0")
        for epoch in range(self.start_epoch + 1,
                           cfg.num_train_epochs + 1):
            logger.info("***** Epoch %d *****", epoch)
            self._train_epoch(epoch, it)
        if (cfg.num_train_epochs > self.start_epoch
                and cfg.num_train_epochs % cfg.num_epoch_to_save != 0):
            # the epoch loop only saves on the num_epoch_to_save cadence;
            # without a final save the trailing epochs (e.g. 71-75 with
            # cadence 10) would be silently discarded on process exit
            self.save_model_checkpoint(str(cfg.num_train_epochs))
            self.save_train_checkpoint(cfg.num_train_epochs)
        self._sync_params_to_retriever()
        logger.info("***** Training Finished *****")

    def _make_device_batch(self, samples, epoch: int, iteration: int,
                           source: int = 0):
        cfg = self.cfg
        # reseed per batch for resumable ctx-pool shuffling; the epoch
        # stride keeps (epoch, iteration) pairs from colliding, as in the
        # JAX package (the reference's seed+epoch+iteration collides)
        rng = pyrandom.Random(cfg.seed + epoch * 1_000_003 + iteration)
        enc_q = self.retriever.encoder_q
        enc_p = self.retriever.encoder_p
        ds = (self.datasets[source]
              if 0 <= source < len(self.datasets) else None)
        b = create_biencoder_batch(
            enc_q.tokenizer, enc_p.tokenizer, samples,
            q_max_len=enc_q.config.max_len,
            p_max_len=enc_p.config.max_len,
            insert_title=cfg.train_insert_title,
            num_hard_negatives=cfg.hard_negatives,
            num_other_negatives=cfg.other_negatives,
            shuffle=True,
            shuffle_positives=bool(getattr(ds, "shuffle_positives",
                                           False)),
            rng=rng)
        p_tensor = b.p_tensor
        if cfg.ret_negatives and self.retriever.index is not None:
            self._sync_params_to_retriever()
            q_emb = self.retriever.process_query(b.q_texts,
                                                 batch_size=len(b.q_texts))
            negs = self.retriever.retrieve_negatives(
                q_emb, answers=b.answers, ret_neg_num=cfg.ret_negatives,
                ret_topk=cfg.ret_topk, pool_size=cfg.negative_pool_size,
                ret_dropout=cfg.ret_dropout,
                seed=cfg.seed + epoch + iteration)
            # mined negatives are bare texts (get_sample titles are
            # dropped by the mining path), so no title pair here
            flat = [t for sample_negs in negs for t in sample_negs]
            extra = np.stack([
                _encode_fixed(enc_p.tokenizer, text, p_tensor.shape[1])
                for text in flat])
            p_tensor = np.concatenate([p_tensor, extra], axis=0)
        batch = TrainBatch(
            q_ids=torch.from_numpy(b.q_tensor.astype(np.int64))
            .to(self.device),
            p_ids=torch.from_numpy(p_tensor.astype(np.int64))
            .to(self.device))
        return batch, b

    def _batches(self, epoch: int, it: MultiSetDataIterator):
        """Yield (i, iteration, device_batch, host_batch, seed) for one
        epoch. Without retrieved-negative mining (which must see the
        current weights every batch), production runs on a background
        thread ``prefetch_batches`` ahead, overlapping tokenization and
        host->device uploads with the device's step compute."""
        cfg = self.cfg

        def produce(i, samples, source):
            iteration = it.get_iteration()
            batch, host_batch = self._make_device_batch(samples, epoch,
                                                        iteration,
                                                        source=source)
            return (i, iteration, batch, host_batch,
                    step_seed(cfg.seed, epoch, iteration, get_rank()))

        if cfg.prefetch_batches < 1 or (
                cfg.ret_negatives and self.retriever.index is not None):
            for i, (samples, source) in enumerate(
                    it.iterate_ds_data(epoch=epoch)):
                yield produce(i, samples, source)
            return

        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_batches)
        stop = threading.Event()

        def put(item) -> bool:
            """Blocking put that aborts when the consumer is gone —
            without the stop check an exception mid-epoch would leave
            the worker tokenizing and uploading the entire remaining
            epoch before the error could surface."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for i, (samples, source) in enumerate(
                        it.iterate_ds_data(epoch=epoch)):
                    if stop.is_set() or not put(produce(i, samples,
                                                        source)):
                        return
            except BaseException as exc:  # surface in the main thread
                put(exc)
                return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a put() blocked before stop was set can finish
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.2)

    def _train_epoch(self, epoch: int, it: MultiSetDataIterator):
        cfg = self.cfg
        epoch_batches = it.get_max_iterations()
        # metric sums accumulate ON DEVICE; the host reads a step's
        # result only at logging points, so consecutive steps queue on
        # the card
        sums = None
        rolling_sum = None
        rolling_n = 0
        t0 = time.time()
        for i, iteration, batch, host_batch, seed in self._batches(
                epoch, it):
            self.state, metrics = self._step_fn(self.state, batch, seed)
            sums = (metrics if sums is None
                    else {k: sums[k] + v for k, v in metrics.items()})
            rolling_sum = (metrics["loss"] if rolling_sum is None
                           else rolling_sum + metrics["loss"])
            rolling_n += 1
            n = len(host_batch.q_texts)
            if i % cfg.log_batch_step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    "Epoch: %d: Step: %d/%d, loss=%.4f, lr=%.6f, "
                    "acc@1[semi]=%.0f/%d acc@1[para]=%.0f/%d "
                    "(%.2f s/step)", epoch, iteration, epoch_batches,
                    m["loss"], self.state.tx.lr(),
                    m["correct_semiparametric"], n,
                    m["correct_parametric"], n,
                    (time.time() - t0) / (i + 1))
                if self.enc_type == "vdr" and is_master():
                    self._log_info_card(host_batch)
            if (i + 1) % cfg.train_rolling_loss_step == 0:
                logger.info("Avg. loss per last %d batches: %f",
                            cfg.train_rolling_loss_step,
                            float(rolling_sum) / rolling_n)
                rolling_sum, rolling_n = None, 0
            if cfg.save_steps and iteration % cfg.save_steps == 0:
                # mid-epoch: `epoch` is in progress, so the last
                # COMPLETED epoch is epoch-1 and `iteration` batches of
                # this epoch are consumed — resume() restarts on the
                # exact next batch (use the yielded iteration, not
                # it.get_iteration(): the prefetch thread runs ahead)
                self.save_train_checkpoint(epoch - 1, offset=iteration)
        if epoch % cfg.num_epoch_to_save == 0:
            self.save_model_checkpoint(str(epoch))
            self.save_train_checkpoint(epoch)
        if sums is not None and epoch_batches:
            s = {k: float(v) for k, v in sums.items()}  # one read an epoch
            logger.info("Av Loss per epoch=%f", s["loss"] / epoch_batches)
            logger.info("epoch total semi correct=%d",
                        int(s["correct_semiparametric"]))
            logger.info("epoch total para correct=%d",
                        int(s["correct_parametric"]))

    # -- info card ---------------------------------------------------------
    def _log_info_card(self, host_batch):
        enc_q = self.retriever.encoder_q
        self._sync_params_to_retriever()
        q_emb = enc_q.embed([host_batch.q_texts[0]], topk=None)
        p_emb = self.retriever.encoder_p.embed([host_batch.p_texts[0]],
                                               topk=None)
        try:
            card = InfoCard(
                tokenizer=enc_q.tokenizer,
                shift_vocab_num=getattr(enc_q.config, "shift_vocab_num",
                                        0))
            card.add_stat_info(q_emb, title=" q_emb ")
            card.add_stat_info(p_emb, title=" p_emb ")
            card.add_texts_info(
                texts=[host_batch.q_texts[0], host_batch.p_texts[0]],
                descs=["[Q_TEXT]", "[P_TEXT1]"], title=" EXAMPLE ")
            card.add_interaction_info(q_emb[0], p_emb[0], k=20)
            card.wrap_info()
            logger.info(card.info)
        except Exception as exc:  # never let logging kill training
            logger.warning("info card failed: %s", exc)

    # -- checkpointing -----------------------------------------------------
    def _sync_params_to_retriever(self):
        """The encoders hold the trained modules themselves, so ``embed``
        and ``save_pretrained`` already see the live f32 weights; this
        only makes sure the modules are in eval mode for them."""
        self.module.eval()

    def save_model_checkpoint(self, suffix: str) -> str:
        self._sync_params_to_retriever()
        path = os.path.join(self.cfg.output_dir,
                            f"{self.cfg.save_name_prefix}_{suffix}")
        # the weights are the same on every rank: one writes the HF files
        if is_master():
            self.retriever.save_pretrained(path)
        return path

    def save_train_checkpoint(self, epoch: int, offset: int = 0):
        """The train state is the same on every rank (averaged gradients,
        equal updates, equal iterator offsets): rank 0 writes it, and a
        resume reads it on every rank."""
        path = os.path.join(self.cfg.output_dir, "train_state")
        if is_master():
            save_checkpoint(path, self.state, epoch=epoch, offset=offset)
        return path
