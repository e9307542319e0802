"""ctypes bindings for the C++ WordPiece tokenizer.

Builds ``csrc/wordpiece.cc`` with g++ on first use into the package's
git-ignored ``_build/`` directory. Exposes the same surface as the
pure-Python ``WordPieceTokenizer`` plus a fused ``encode_bot_batch``
that emits ELL bag-of-token rows directly — the hot path of the binary
index build. (A copy of the JAX package's module.)
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "wordpiece.cc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_LIB = os.path.join(_BUILD, "libwordpiece.so")
_TABLES = os.path.join(_BUILD, "unitables_v1.npz")
_BUILD_LOCK = threading.Lock()
_N_CP = 0x110000


def _generate_unicode_tables():
    """flags + fold tables mirroring python unicodedata exactly.

    flags bits: 1=removed(control/NUL/U+FFFD) 2=whitespace 4=punct 8=cjk.
    fold(cp) = per-char-lowercase(strip-Mn(NFD(chr(cp)))) — the HF-fast
    BertNormalizer pipeline; only non-identity entries are stored.
    """
    import unicodedata

    from .wordpiece import (_is_cjk, _is_control, _is_punctuation,
                            _is_whitespace)

    flags = np.zeros(_N_CP, dtype=np.uint8)
    keys, offs, data = [], [0], []
    for cp in range(_N_CP):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates never occur in UTF-8
            flags[cp] = 1
            continue
        ch = chr(cp)
        f = 0
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            f |= 1
        if _is_whitespace(ch):
            f |= 2
        if _is_punctuation(ch):
            f |= 4
        if _is_cjk(cp):
            f |= 8
        flags[cp] = f
        if f & 3:  # removed/space chars are never folded
            continue
        folded = unicodedata.normalize("NFD", ch)
        folded = "".join(c for c in folded
                         if unicodedata.category(c) != "Mn")
        folded = "".join(c.lower() for c in folded)
        if folded != ch:
            keys.append(cp)
            data.extend(ord(c) for c in folded)
            offs.append(len(data))
    return (flags, np.asarray(keys, np.uint32),
            np.asarray(offs, np.int32), np.asarray(data, np.uint32))


_tables_cache = None


def _unicode_tables():
    """Load (or generate + disk-cache) the exact-unicode tables."""
    global _tables_cache
    if _tables_cache is not None:
        return _tables_cache
    with _BUILD_LOCK:
        if _tables_cache is not None:
            return _tables_cache
        if os.path.exists(_TABLES):
            try:
                z = np.load(_TABLES)
                _tables_cache = (z["flags"], z["fold_keys"],
                                 z["fold_off"], z["fold_data"])
                return _tables_cache
            except Exception:
                pass  # corrupt cache: regenerate
        tables = _generate_unicode_tables()
        tmp = _TABLES + f".tmp{os.getpid()}"
        try:
            os.makedirs(_BUILD, exist_ok=True)
            with open(tmp, "wb") as fh:  # np.savez would append .npz
                np.savez_compressed(fh, flags=tables[0],
                                    fold_keys=tables[1],
                                    fold_off=tables[2],
                                    fold_data=tables[3])
            os.replace(tmp, _TABLES)
        except OSError:
            pass  # read-only install: keep in-memory only
        _tables_cache = tables
    return _tables_cache


def _build_library() -> str:
    with _BUILD_LOCK:
        if os.path.exists(_LIB) and os.path.getmtime(
                _LIB) >= os.path.getmtime(_SRC):
            return _LIB
        os.makedirs(_BUILD, exist_ok=True)
        tmp = _LIB + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", "-pthread", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    return _LIB


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(_build_library())
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_vocab_size.restype = ctypes.c_int32
        lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        lib.wp_set_tables.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64]
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32]
        lib.wp_encode_bot_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32]
        _lib_handle = lib
    return _lib_handle


def _pack_texts(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    # ASCII fast path: one join+encode instead of N encode calls, with
    # char-based offsets (byte-correct for ASCII). str.isascii() is a
    # cheap C scan, so non-ASCII batches skip the speculative join
    # instead of paying for it twice.
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    if all(map(str.isascii, texts)):
        char_lens = np.fromiter(map(len, texts), dtype=np.int64,
                                count=len(texts))
        np.cumsum(char_lens, out=offsets[1:])
        return "".join(texts).encode("utf-8"), offsets
    encoded = [t.encode("utf-8") for t in texts]
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


class NativeWordPieceTokenizer:
    """Drop-in WordPiece tokenizer backed by the C++ core."""

    def __init__(self, vocab: Dict[str, int], nthreads: Optional[int]
                 = None):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.nthreads = nthreads or min(os.cpu_count() or 1, 16)
        # the C++ core numbers tokens by their LINE position, so the
        # blob must be dense over [0, max_id]: a gapped vocab (e.g. a
        # vocab.txt with blank lines skipped by the loader) would
        # otherwise renumber every token after the gap and silently
        # disagree with self.vocab. Gaps get unmatchable placeholders
        # (\x00 cannot appear in wordpiece input).
        max_id = max(vocab.values()) if vocab else -1
        by_id = {i: t for t, i in vocab.items()}
        blob = "\n".join(by_id.get(i, f"\x00gap{i}")
                         for i in range(max_id + 1)).encode("utf-8")
        self._handle = ctypes.c_void_p(_lib().wp_create(blob, len(blob)))
        flags, fkeys, foff, fdata = _unicode_tables()
        _lib().wp_set_tables(
            self._handle, np.ascontiguousarray(flags, np.uint8),
            flags.shape[0], np.ascontiguousarray(fkeys, np.uint32),
            np.ascontiguousarray(foff, np.int32),
            np.ascontiguousarray(fdata, np.uint32), fkeys.shape[0])
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get("[UNK]", 1)
        self.cls_id = vocab.get("[CLS]", 2)
        self.sep_id = vocab.get("[SEP]", 3)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "NativeWordPieceTokenizer":
        from .wordpiece import load_vocab

        return cls(load_vocab(path), **kw)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                _lib().wp_free(self._handle)
        except Exception:
            pass

    def __getstate__(self):
        return {"vocab": self.vocab, "nthreads": self.nthreads}

    def __setstate__(self, state):
        self.__init__(state["vocab"], nthreads=state["nthreads"])

    @property
    def vocab_size(self) -> int:
        # max id + 1, NOT len(vocab): gapped vocabs (blank vocab.txt
        # lines keep their line number) produce ids beyond len(), and
        # embedding/bow/index dimensions must cover every real id
        return (max(self.vocab.values()) + 1) if self.vocab else 0

    # -- encoding ----------------------------------------------------------
    def encode_batch_padded(self, texts: Sequence[str],
                            max_length: int = 256,
                            add_special_tokens: bool = True
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [N, max_length] int32 padded, lens [N])."""
        blob, offsets = _pack_texts(texts)
        n = len(texts)
        out = np.zeros((n, max_length), dtype=np.int32)
        lens = np.zeros(n, dtype=np.int32)
        _lib().wp_encode_batch(self._handle, blob, offsets, n, max_length,
                               1 if add_special_tokens else 0, out, lens,
                               self.nthreads)
        return out, lens

    def encode_batch(self, texts: Sequence[str], max_length: int = 256,
                     add_special_tokens: bool = True) -> List[List[int]]:
        out, lens = self.encode_batch_padded(texts, max_length,
                                             add_special_tokens)
        return [out[i, : lens[i]].tolist() for i in range(len(texts))]

    def encode(self, text: str, max_length: int = 256,
               add_special_tokens: bool = True) -> List[int]:
        return self.encode_batch([text], max_length, add_special_tokens)[0]

    def encode_bot_batch(self, texts: Sequence[str], max_len: int,
                         shift: int, cap: int, nnz_pad: int,
                         pad_value: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused BoT rows: (cols [N, nnz_pad] int32 shifted, nnz [N]).
        Padding entries hold ``pad_value`` (pass the sentinel column id
        for mask-free scoring)."""
        blob, offsets = _pack_texts(texts)
        n = len(texts)
        cols = np.zeros((n, nnz_pad), dtype=np.int32)
        nnz = np.zeros(n, dtype=np.int32)
        _lib().wp_encode_bot_batch(self._handle, blob, offsets, n, max_len,
                                   shift, cap, nnz_pad, pad_value, cols,
                                   nnz, self.nthreads)
        return cols, nnz

    # -- misc (parity with python tokenizer) -------------------------------
    def tokenize(self, text: str) -> List[str]:
        # bound the buffer by the input size — a huge fixed max_length
        # would allocate (and the C++ pad loop would dirty) the whole
        # [1, max_length] buffer per call. NFD can EXPAND characters
        # (Hangul decomposes to up to 3 jamo), so use 4x + slack, not
        # len(text) + 2, or long decomposable runs would truncate
        ids = self.encode(text, max_length=max(4 * len(text) + 16, 16),
                          add_special_tokens=False)
        return [self.ids_to_tokens.get(i, "[UNK]") for i in ids]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        special = {self.cls_id, self.sep_id, self.pad_id}
        toks = [self.ids_to_tokens.get(int(i), "[UNK]")
                for i in ids if not (skip_special and int(i) in special)]
        return " ".join(toks).replace(" ##", "")
