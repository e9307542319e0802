"""The pack at 2M rows, in both layouts (counterpart of
``scripts/probe_pack.py``).

    python -m vsearch_tpu_torch.scripts.probe_pack [--rows 2000000]
        [--device cpu]

The TPU probe timed its Pallas packs of 2,000,000 ELL rows of 128 ids
(64 valid) over V' = 29,523: ``make_packT`` writes words_T [1,024,
N_pad] (P2 here, ``ops.probes.pack_bits_t``), ``make_packT_fused_transpose``
the row-major [N_pad, 1,024] (kernel #1's function, ``ops.bitpack
.pack_bits``). This times both against their byte bound, checks
``words_T == words.T`` and holds each against its plain version, in
262,144-row slices. The TPU probe drew ids with repeats; these are
distinct within a row (64 of the 128 strata of the vocabulary, one id
each), as every ELL of the repo holds them.
"""
from __future__ import annotations

import torch

from ..ops import bitpack, probes
from ..ops.bitpack import ROW_BLOCK, TILE_BITS, _round_up
from . import common

ROWS, NNZ_PAD, NNZ = 2_000_000, 128, 64
SLICE = 1 << 18


def make_ell(n: int, v: int, seed: int, dev):
    """[n, 128] int32 cols, distinct a row (one id of each of 128 strata,
    the strata in random order), and nnz = 64."""
    cols, _ = common.stratified_ell(n, v, seed, dev, nnz_pad=NNZ_PAD)
    gen = common.generator(dev, seed + 1)
    for s in range(0, n, 1 << 21):
        c = cols[s:s + (1 << 21)]
        perm = torch.rand(c.shape, generator=gen, device=dev).argsort(dim=1)
        cols[s:s + (1 << 21)] = torch.gather(c, 1, perm)
    return cols, torch.full((n,), NNZ, dtype=torch.int32, device=dev)


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=ROWS)
        ap.add_argument("--vocab", type=int, default=common.V_PACK)

    args, dev, out = common.start(__doc__, argv, add)
    n, v = args.rows, args.vocab
    cols, nnz = make_ell(n, v, args.seed, dev)
    words_t = probes.pack_bits_t(cols, nnz, v)
    words = bitpack.pack_bits(cols, nnz, v)
    n_pad = _round_up(n, ROW_BLOCK)
    nw = _round_up(v, TILE_BITS) // 32
    checks = common.pack_checks(cols, nnz, v, words, words_t, SLICE)
    nbytes = cols.numel() * 4 + nnz.numel() * 4 + n_pad * nw * 4

    def plain_in_slices(fn):
        for s in range(0, n, SLICE):
            fn(cols[s:s + SLICE], nnz[s:s + SLICE], v)

    iters = max(1, args.iters // 4)
    out.update({
        "n": n, "v": v, "nnz_pad": NNZ_PAD, "nnz": NNZ,
        "words_t_shape": list(words_t.shape), "words_shape": list(
            words.shape),
        "words_t_equals_words_T": checks["words_t_equals_words_T"],
        "packT": {"ms": common.time_ms(
            lambda: probes.pack_bits_t(cols, nnz, v), dev, args.iters),
            "plain_ms": common.time_ms(
                lambda: plain_in_slices(probes.pack_bits_t_plain), dev,
                iters),
            "bit_identical_to_plain": checks["pack_t_bit_identical"],
            **common.bound(nbytes)},
        "pack": {"ms": common.time_ms(
            lambda: bitpack.pack_bits(cols, nnz, v), dev, args.iters),
            "plain_ms": common.time_ms(
                lambda: plain_in_slices(bitpack.pack_bits_plain), dev,
                iters),
            "bit_identical_to_plain": checks["pack_bit_identical"],
            **common.bound(nbytes)},
        "plain_in_slices_of": SLICE})
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
