"""Bi-encoder: a query encoder + a passage encoder behind one config
(counterpart of ``vsearch_tpu/biencoder.py``).

Checkpoints are directories in the reference's HF layout, which the JAX
package reads too (its ``_from_torch_dir``): ``config.json`` (the
``BiEncoderConfig`` dict), ``vocab.txt`` (one token a line, the line
number is the id) and ``pytorch_model.bin`` (a ``torch.save``d state dict,
keys ``encoder_q.``/``encoder_p.`` + the HF ``BertModel`` names under
``bert_model.`` and the head's ``ln.``). A ``model.safetensors`` with the
same keys is read in its place when present (``read_safetensors``, the
JAX package's order). The JAX package's own checkpoints (flax msgpack)
cannot be read without flax.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .models.registry import get_encoder_classes

logger = logging.getLogger(__name__)

_JAX_NATIVE_CONFIG = "vsearch_tpu_config.json"
_WEIGHTS = "pytorch_model.bin"
_SAFETENSORS = "model.safetensors"
# safetensors dtypes read, as little-endian numpy dtypes; BF16 is read as
# its int16 bit patterns and viewed as torch.bfloat16 (numpy has no bf16)
_ST_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<i2", "I64": "<i8"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors by name, read without the
    ``safetensors`` package: an 8-byte little-endian header length, a JSON
    header (per tensor ``dtype``, ``shape`` and ``data_offsets`` into the
    byte buffer that follows, plus an optional ``__metadata__``), then the
    raw little-endian bytes. F32, F16, BF16 and I64 are read; any other
    dtype raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _ST_DTYPES:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {spec['dtype']}; only "
                f"{sorted(_ST_DTYPES)} are read")
        lo, hi = spec["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_ST_DTYPES[spec["dtype"]])
        t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("=")))
        if spec["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t.reshape(spec["shape"])
    return out


def join_corpus(corpus) -> List[str]:
    """Normalize corpus entries to strings: dicts with title/text join as
    "title [SEP] text"."""
    processed = []
    for p in corpus:
        if isinstance(p, str):
            processed.append(p)
        elif isinstance(p, dict):
            body = p.get("text") or p.get("contents") or ""
            if p.get("title"):
                processed.append(f"{p['title']} [SEP] {body}")
            else:
                processed.append(body)
        else:
            raise TypeError(
                f"corpus entries must be str or dict, got {type(p)}")
    return processed


def takes_images(encoder) -> bool:
    """Whether ``encoder`` embeds images (the cross-modal image encoder):
    its corpus is image paths, PIL images or pixel arrays, handed to it as
    they are. The JAX package joins every corpus as text, so there only
    image paths pass."""
    return getattr(encoder.config, "type", "") == "vdr_crossmodal_image"


@dataclasses.dataclass
class BiEncoderConfig:
    encoder_q: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder_p: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_len: int = 512
    shared_encoder: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BiEncoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class BiEncoder:
    """Holds ``encoder_q`` and ``encoder_p``, built through the registry
    from config dicts with a ``type`` key ('vdr', 'dpr',
    'vdr_crossmodal_text', 'vdr_crossmodal_image'; the two sides may
    differ). Weights come from ``seed`` (query encoder) and ``seed + 1``
    (passage encoder)."""

    config_class = BiEncoderConfig

    def __init__(self, config: BiEncoderConfig, tokenizer=None,
                 seed: int = 0, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.default_batch_size = 32
        q_cfg_cls, q_cls = get_encoder_classes(config.encoder_q["type"])
        q_cfg = q_cfg_cls.from_dict(config.encoder_q)
        if config.shared_encoder:
            # one encoder for both sides, at the larger of the two lengths
            p_max = config.encoder_p.get("max_len", q_cfg.max_len)
            if p_max > q_cfg.max_len:
                q_cfg = dataclasses.replace(q_cfg, max_len=p_max)
        self.encoder_q = q_cls(q_cfg, tokenizer=tokenizer, seed=seed,
                               device=self.device)
        if config.shared_encoder:
            self.encoder_p = self.encoder_q
        else:
            p_cfg_cls, p_cls = get_encoder_classes(config.encoder_p["type"])
            self.encoder_p = p_cls(p_cfg_cls.from_dict(config.encoder_p),
                                   tokenizer=tokenizer, seed=seed + 1,
                                   device=self.device)

    # -- training forward ----------------------------------------------------
    def forward(self, q_ids, q_segments, q_attn_mask, p_ids, p_segments,
                p_attn_mask, *, deterministic: bool = True,
                seed: Optional[int] = None):
        """Token tensors (numpy arrays or tensors) -> ``(q_emb, p_emb)``,
        each encoder module's raw embeddings on the model's device, with
        no top-k or bag-of-words masking (the loss sparsifies its own) and
        autograd recording unless the caller turns it off. The forward
        computes in the encoders' configured dtype.

        ``deterministic=False`` turns dropout on and needs ``seed``: the
        query side draws its masks from seed lane 0 and the passage side
        from lane 1, so the two sides' masks differ and a repeated call
        repeats them (the JAX package folds lanes 0 and 1 into its key).
        For training use ``train.step.make_train_step``."""
        from .models.encoder_base import compute_context, compute_dtype

        if not deterministic and seed is None:
            raise ValueError(
                "deterministic=False requires a seed; pass a fresh one per "
                "step (the reference draws new dropout masks each forward)")
        outs = []
        for lane, (enc, tensors) in enumerate((
                (self.encoder_q, (q_ids, q_segments, q_attn_mask)),
                (self.encoder_p, (p_ids, p_segments, p_attn_mask)))):
            mod = enc.module
            dev = next(mod.parameters()).device
            args = [torch.as_tensor(x).long().to(dev) for x in tensors]
            was_training = mod.training
            mod.train(not deterministic)
            try:
                # manual_seed re-seeds every card: restore them all
                with torch.random.fork_rng(
                        devices=range(torch.cuda.device_count()),
                        device_type="cuda"):
                    if seed is not None:
                        torch.manual_seed(int(np.random.SeedSequence(
                            [seed, lane]).generate_state(1)[0]))
                    with compute_context(mod, compute_dtype(enc.config)):
                        outs.append(mod(*args))
            finally:
                mod.train(was_training)
        return outs[0], outs[1]

    __call__ = forward

    def encode_queries(self, queries: List[str],
                       batch_size: Optional[int] = None,
                       **kwargs) -> np.ndarray:
        batch_size = batch_size or self.default_batch_size
        return self.encoder_q.embed(queries, batch_size=batch_size,
                                    activate_lexical=False, **kwargs)

    def encode_corpus(self, corpus: Union[List[str], List[Dict[str, str]]],
                      batch_size: Optional[int] = None,
                      max_len: Optional[int] = None,
                      **kwargs) -> np.ndarray:
        batch_size = batch_size or self.default_batch_size
        if not takes_images(self.encoder_p):
            corpus = join_corpus(corpus)
        return self.encoder_p.embed(corpus,
                                    batch_size=batch_size, max_len=max_len,
                                    activate_lexical=False, **kwargs)

    def explain(self, q: str, p: str, topk: int = 768, visual: bool = False,
                max_words: int = 100, log_scale: bool = True,
                save_file: Optional[str] = None) -> Dict[str, float]:
        """Token-level q x p attribution, largest first; ``visual`` draws
        it as a word cloud (``utils.vis``), into ``save_file`` if given."""
        q_dst = self.encoder_q.dst(q, topk=topk)
        p_dst = self.encoder_p.dst(p, topk=topk)
        inter = {
            key: q_dst.get(key, 0) * p_dst.get(key, 0)
            for key in set(q_dst) | set(p_dst)
            if q_dst.get(key, 0) * p_dst.get(key, 0) != 0
        }
        results = dict(sorted(inter.items(), key=lambda kv: -kv[1]))
        if visual:
            from .utils.vis import wordcloud_from_dict
            wordcloud_from_dict(results, max_words=max_words,
                                log_scale=log_scale, save_file=save_file)
        return results

    # -- persistence -------------------------------------------------------
    def _encoders(self):
        yield "encoder_q", self.encoder_q
        if not self.config.shared_encoder:
            yield "encoder_p", self.encoder_p

    def save_pretrained(self, path: str):
        """Write an HF-layout checkpoint directory (see the module
        docstring). The ``compat_pad_pooling`` of each encoder that has one
        (VDR, cross-modal text) is written explicitly, since a reader of
        this layout defaults it to True. Weights are stored in f32, which
        holds bf16 weights exactly."""
        os.makedirs(path, exist_ok=True)
        cfg = self.config.to_dict()
        for name, enc in (("encoder_q", self.encoder_q),
                          ("encoder_p", self.encoder_p)):
            cfg[name] = {k: _json_value(v) for k, v in cfg[name].items()}
            if hasattr(enc.config, "compat_pad_pooling"):
                cfg[name]["compat_pad_pooling"] = bool(
                    enc.config.compat_pad_pooling)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        vocab = getattr(self.encoder_q.tokenizer, "vocab", None)
        if isinstance(vocab, dict):
            # by line position: an id gap stays a blank line, so a reload
            # gives every token its id back
            by_id = {i: t for t, i in vocab.items()}
            with open(os.path.join(path, "vocab.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(by_id.get(i, "")
                                  for i in range(max(by_id, default=-1) + 1))
                        + "\n")
        sd = {f"{name}.{k}": v.detach().float().cpu()
              for name, enc in self._encoders()
              for k, v in enc.module.state_dict().items()}
        torch.save(sd, os.path.join(path, _WEIGHTS))
        logger.info("saved bi-encoder to %s", path)

    @classmethod
    def from_pretrained(cls, path: str, tokenizer=None, **kwargs):
        """Load an HF-layout checkpoint directory: one written by
        ``save_pretrained`` or a reference checkpoint (VDR, DPR, cross-modal
        text and image encoders). VDR and cross-modal text encoders whose
        config does not say otherwise get ``compat_pad_pooling=True``, the
        reference's pooling. ``kwargs`` go to the constructor (``device``,
        ``seed``); weights are read on the host and then moved."""
        cfg_file = os.path.join(path, "config.json")
        if not os.path.isfile(cfg_file):
            if os.path.isfile(os.path.join(path, _JAX_NATIVE_CONFIG)):
                raise ValueError(
                    f"{path} is a JAX-native checkpoint ({_JAX_NATIVE_CONFIG} "
                    "+ flax msgpack, written by vsearch_tpu's "
                    "BiEncoder.save_pretrained), which this package cannot "
                    "read without flax. Convert it where JAX is installed: "
                    "load it with vsearch_tpu's Retriever.from_pretrained, "
                    "carry each encoder's params over with the matching "
                    "vsearch_tpu_torch.models.convert"
                    ".*_state_dict_from_flax and write the HF layout "
                    "with this package's "
                    "save_pretrained")
            raise FileNotFoundError(
                f"no HF-layout checkpoint (config.json) under {path}")
        if tokenizer is None and os.path.isfile(
                os.path.join(path, "vocab.txt")):
            from .tokenization import get_tokenizer
            tokenizer = get_tokenizer(path)
        with open(cfg_file) as f:
            config = cls.config_class.from_dict(json.load(f))
        for enc_cfg in (config.encoder_q, config.encoder_p):
            if (enc_cfg.get("type", "vdr") in ("vdr", "vdr_crossmodal_text")
                    and "compat_pad_pooling" not in enc_cfg):
                enc_cfg["compat_pad_pooling"] = True
        sd = _load_state_dict(path)
        model = cls(config, tokenizer=tokenizer, **kwargs)
        from .models import convert
        from .models.vdr import TRUNKS

        readers = {
            "vdr": lambda sub, c: TRUNKS[c.trunk].read_hf(sub, c.bert),
            "dpr": lambda sub, c: convert.convert_dpr_params(sub),
            "vdr_crossmodal_text":
                lambda sub, c: convert.convert_crossmodal_text_params(
                    sub, c.bert.hidden_size),
            "vdr_crossmodal_image":
                lambda sub, c: convert.convert_vdr_image_params(sub)}
        for name, enc in model._encoders():
            prefix = f"{name}." if any(
                k.startswith(f"{name}.") for k in sd) else ""
            sub = {k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)} if prefix else sd
            etype = getattr(enc.config, "type", "vdr")
            enc.module.load_state_dict(readers[etype](sub, enc.config))
        return model


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint directory's weights on the host: ``model.safetensors``
    when present, else ``pytorch_model.bin``."""
    st = os.path.join(path, _SAFETENSORS)
    if os.path.isfile(st):
        return read_safetensors(st)
    weights = os.path.join(path, _WEIGHTS)
    if not os.path.isfile(weights):
        raise FileNotFoundError(
            f"no {_SAFETENSORS} or {_WEIGHTS} under {path}")
    return torch.load(weights, map_location="cpu", weights_only=True)


def _json_value(v):
    """An encoder-config value as JSON takes it (a torch dtype by its
    name)."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return v
