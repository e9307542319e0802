"""Host-side encoder wrapper: tokenize -> length-bucketed batches ->
forward on the device (counterpart of
``vsearch_tpu/models/encoder_base.py``; PyTorch runs eagerly, so there
is no jit cache). Under ``to_mesh`` each batch splits row-wise over the
mesh's devices, one replica of the module on each.

CUDA launches are asynchronous: the batch loop keeps every output on the
device and copies once at the end, so the host tokenizes the next batch
while the card runs the current one.

A module's weights are stored in its compute dtype for inference
(``build_module``); training keeps them in f32 (the trainer's master
copy) and computes in the configured dtype under ``torch.autocast``
(``compute_context``), and ``embed`` then does the same on the live
weights.
"""
from __future__ import annotations

import collections
import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import TRACER

# ``pipeline_window``'s default in-flight window (the JAX package's)
PIPELINE_DEPTH = 8


def pipeline_window(device_results, fetch, depth: Optional[int] = None):
    """Drain an iterator of asynchronous device results with a bounded
    in-flight window: ``fetch(item)`` converts one result to host arrays
    once ``depth`` later results are queued (the JAX package's helper;
    the port's own embed loops copy once at the end instead)."""
    if depth is None:
        depth = PIPELINE_DEPTH
    pending: collections.deque = collections.deque()
    results = []
    for item in device_results:
        pending.append(item)
        if len(pending) > depth:
            results.append(fetch(pending.popleft()))
    while pending:
        results.append(fetch(pending.popleft()))
    return results


def build_module(module_cls, config, init: Callable, seed: int,
                 device: torch.device, dtype: torch.dtype,
                 state_dict=None) -> nn.Module:
    """``module_cls(config)`` built without storage (meta device), then
    materialised on ``device``, initialised by ``init(module, generator)``
    from ``seed`` (an explicit generator), cast to ``dtype`` and put in
    eval mode; ``state_dict`` (the port's layout) then loads over it."""
    with torch.device("meta"):
        module = module_cls(config)
    module = module.to_empty(device=device)
    init(module, torch.Generator(device=device).manual_seed(seed))
    module = module.to(dtype).eval()
    if state_dict is not None:  # cast to the compute dtype on load
        module.load_state_dict(state_dict)
    return module


def compute_dtype(config) -> torch.dtype:
    """The dtype an encoder computes in: its trunk's (``config.bert``'s)
    ``dtype``; f32 for encoders without one, such as the image encoder."""
    return getattr(getattr(config, "bert", None), "dtype", torch.float32)


def compute_context(module: nn.Module, dtype: torch.dtype):
    """``torch.autocast`` to ``dtype`` when ``module`` stores wider weights
    than it computes in (f32 weights of a bf16 encoder under training),
    else a no-op context."""
    p = next(module.parameters())
    if dtype == torch.float32 or p.dtype == dtype:
        return contextlib.nullcontext()
    return torch.autocast(p.device.type, dtype=dtype)


def set_remat(module: nn.Module, on: bool) -> None:
    """Turn activation checkpointing on or off in every submodule that
    offers it (a ``remat`` attribute: BERT's layer stack, the VDR head's
    pooling). It applies only where gradients are being recorded."""
    for sub in module.modules():
        if hasattr(sub, "remat"):
            sub.remat = on


def set_tp(module: nn.Module, devices) -> None:
    """Split the vocabulary head of every submodule that offers it (a
    ``tp_devices`` attribute: the VDR head) over ``devices``, the process's
    tp line with the module's own device first; None or one device turns
    the split off. An encoder without a vocabulary head is left as it is."""
    devices = list(devices) if devices is not None and len(devices) > 1 \
        else None
    for sub in module.modules():
        if hasattr(sub, "tp_devices"):
            sub.tp_devices = devices


def length_buckets(max_len: int, min_bucket: int = 32) -> List[int]:
    """Doubling buckets: 32, 64, ..., max_len (always includes max_len)."""
    buckets = []
    b = min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class TextEncoderBase:
    """Shared host-side machinery for VDR-style text encoders."""

    def __init__(self, config, tokenizer, device="cuda"):
        self.config = config
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self._mesh = None  # (Mesh, axis_name) once to_mesh is called
        self._replicas: Dict[torch.device, nn.Module] = {}

    def to_mesh(self, mesh, axis_name: str = "dp"):
        """Split every embed batch row-wise over the mesh axis, each piece
        through a replica of the module on its device; outputs come back
        in row order on the mesh's first device. The module serves its own
        device and a repeated device shares one replica; the others are
        copies of the weights as they are now (used by the sharded
        beta-search rerank: candidates are per-query disjoint)."""
        if mesh.spans_processes(axis_name):
            raise ValueError("embed splits its batches over the devices of "
                             f"this process; the mesh's {axis_name} spans "
                             "processes")
        home = next(self.module.parameters()).device
        self._replicas = {}
        for d in mesh.devices(axis_name):
            if d not in self._replicas:
                self._replicas[d] = (self.module if d == home else
                                     copy.deepcopy(self.module).to(d))
        self._mesh = (mesh, axis_name)
        return self

    @contextlib.contextmanager
    def _on_replica(self, device: torch.device):
        """``self.module`` and ``self.device`` are ``device``'s replica
        and ``device`` inside the block."""
        module, dev = self.module, self.device
        self.module, self.device = self._replicas[device], device
        try:
            yield
        finally:
            self.module, self.device = module, dev

    def _forward(self, fn: Callable, t: List[torch.Tensor]):
        """``fn(*t)`` on the device, or split over the mesh: one piece a
        device, the outputs (tensors or tuples of them) concatenated in
        row order on the mesh's first device. No piece waits for another:
        the copies to the first device are the only cross-device work."""
        if self._mesh is None:
            # a copy from pageable host memory waits for the stream: the
            # previous batch's forward
            with TRACER.span("upload"):
                t = [x.to(self.device) for x in t]
            return fn(*t)
        from ..parallel.mesh import shard_batch

        mesh, axis_name = self._mesh
        devs = mesh.devices(axis_name)
        pieces = [shard_batch(mesh, x, axis_name) for x in t]
        outs = []
        for j, dev in enumerate(devs):
            with self._on_replica(dev):
                outs.append(fn(*(p[j] for p in pieces)))
        home = devs[0]
        if torch.is_tensor(outs[0]):
            return torch.cat([o.to(home, non_blocking=True) for o in outs])
        return tuple(torch.cat([o[i].to(home, non_blocking=True)
                                for o in outs])
                     for i in range(len(outs[0])))

    def encode(self, texts: Union[str, List[str]],
               max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Tokenize to [N, bucket] int32 arrays padded to the smallest
        length bucket that holds the longest row."""
        max_len = max_len or self.config.max_len
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise ValueError("cannot encode an empty list of texts")
        id_lists = self.tokenizer.encode_batch(texts, max_length=max_len)
        longest = max(len(ids) for ids in id_lists)
        bucket = pick_bucket(longest, length_buckets(max_len))
        n = len(texts)
        # pad positions hold the real pad id; the mask comes from lengths
        ids = np.full((n, bucket), self.tokenizer.pad_id, dtype=np.int32)
        attn = np.zeros((n, bucket), dtype=np.int32)
        for i, row in enumerate(id_lists):
            ids[i, : len(row)] = row
            attn[i, : len(row)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                "attention_mask": attn}

    def _pad_batch(self, enc: Dict[str, np.ndarray], batch_size: int
                   ) -> Dict[str, np.ndarray]:
        pad = batch_size - enc["input_ids"].shape[0]
        if pad <= 0:
            return enc
        return {k: np.pad(v, ((0, pad), (0, 0))) for k, v in enc.items()}

    def _run_batches(self, texts: List[str], batch_size: int, max_len: int,
                     fn: Callable) -> List[Tuple[object, int]]:
        """``fn(ids, token_types, mask)`` on each batch of ``batch_size``
        texts (the last one padded with empty rows). Returns
        ``(device output, real row count)`` per batch. Each batch is a
        ``tokenize`` and a ``forward`` span (``utils.profiling.TRACER``)
        under the caller's, and the forward counts its batch's real
        tokens (``forward/tokens``) and the padding it runs besides
        (``forward/pad_tokens``: the rest of its rows' length bucket, and
        its empty rows) in the call record's counts."""
        outs = []
        ctx = compute_context(self.module, compute_dtype(self.config))
        for start in range(0, len(texts), batch_size):
            chunk = texts[start: start + batch_size]
            with TRACER.span("tokenize"):
                enc = self._pad_batch(self.encode(chunk, max_len=max_len),
                                      batch_size)
                t = [torch.from_numpy(enc[k]).long() for k in
                     ("input_ids", "token_type_ids", "attention_mask")]
                real = int(enc["attention_mask"].sum())
            with TRACER.span("forward"), ctx:
                TRACER.count("tokens", real)
                TRACER.count("pad_tokens", enc["attention_mask"].size - real)
                outs.append((self._forward(fn, t), len(chunk)))
        return outs
