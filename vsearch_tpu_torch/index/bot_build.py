"""Bag-of-token index construction: tokenizer-only, no neural network
(counterpart of ``vsearch_tpu/index/bot_build.py``).

Tokens go straight into the ELL layout (cols + nnz, no values): each row
holds the text's first ``max_token`` unique token ids >= ``shift``,
shifted into [0, V - shift). The C++ tokenizer's fused
``encode_bot_batch`` does this in its own threads; the pure-Python
tokenizer (a fallback for tests and tiny corpora) runs in-process.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..ops.ell import ELLMatrix

# texts per call into the C++ tokenizer: bounds the joined-text blob
_NATIVE_CHUNK = 1 << 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _encode_chunk(tokenizer, texts: Sequence[str], max_len: int,
                  shift: int, cap: int, nnz_pad: int, sentinel: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    if hasattr(tokenizer, "encode_bot_batch"):
        # fused C++ path: tokenize + first-N-unique + shift in one call
        parts = [tokenizer.encode_bot_batch(
            texts[s: s + _NATIVE_CHUNK], max_len=max_len, shift=shift,
            cap=cap, nnz_pad=nnz_pad, pad_value=sentinel)
            for s in range(0, len(texts), _NATIVE_CHUNK)]
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
    n = len(texts)
    cols = np.full((n, nnz_pad), sentinel, dtype=np.int32)
    nnz = np.zeros(n, dtype=np.int32)
    id_lists = tokenizer.encode_batch(texts, max_length=max_len)
    for i, ids in enumerate(id_lists):
        seen: Dict[int, None] = {}
        for t in ids:
            if t >= shift and t not in seen:
                seen[t] = None
                if len(seen) >= cap:
                    break
        row = np.fromiter(seen.keys(), dtype=np.int32, count=len(seen))
        cols[i, : row.size] = row - shift
        nnz[i] = row.size
    return cols, nnz


def build_bot_ell(tokenizer, texts: Sequence[str], max_len: int = 128,
                  shift: int = 999, batch_size: int = 1024,
                  max_token: Optional[int] = None,
                  num_workers: Optional[int] = None,
                  vocab_size: Optional[int] = None,
                  return_host: bool = False, device="cuda"):
    """Build a binary bag-of-token ELLMatrix from raw texts, with the JAX
    package's arguments in its order.

    ``batch_size`` and ``num_workers`` are accepted and unused: the C++
    tokenizer runs its own threads. ``device`` is a device name or
    ``torch.device``, or the JAX package's flag: ``True`` the card,
    ``False`` a host ELL (CPU tensors). ``return_host=True`` returns
    ``(ell, cols, nnz)`` with the rows as numpy arrays too.
    """
    if isinstance(device, bool):
        device = "cuda" if device else "cpu"
    dev = resolve_device(device)
    vocab_size = vocab_size or tokenizer.vocab_size
    if shift >= vocab_size:
        raise ValueError(
            f"shift={shift} >= vocab_size={vocab_size}: the token-id "
            "shift must leave a non-empty column space (pass a smaller "
            "--num_shift for non-BERT vocabularies)")
    cap = max_token or max_len
    nnz_pad = max(_round_up(cap, 128), 128)
    sentinel = vocab_size - shift  # mask-free scoring padding
    cols, nnz = _encode_chunk(tokenizer, texts, max_len, shift, cap,
                              nnz_pad, sentinel)
    ell = ELLMatrix.from_arrays(cols, nnz, None, vocab_size - shift, True,
                                dev)
    if return_host:
        return ell, cols, nnz
    return ell
