"""The block tier's cost by part, one steady-state block (counterpart of
``scripts/probe_block_parts.py``).

    python -m vsearch_tpu_torch.scripts.probe_block_parts [--b 1024]
        [--rows 262144] [--device cpu]

One 262,144-row block of the JAX probe's ELL (128 strata, 48-96 ids,
V = 30,522), B = 1,024 dense random queries (``--b 32``: the port's served
batch), k = 100, bucket 8 as the TPU probe timed it:

- ``pack``: kernel #1 over the block's ELL;
- ``keys``: kernel #3 alone (keys [N_pad / 8, B] int32), with its bound
  and its plain version's time;
- ``topk_f32``: the keys decoded to f32 scores and row ids, then the
  port's ``top_k`` (a stable sort: ROADMAP S4);
- ``topk_int``: ``torch.topk`` on the int32 keys, only the k winners
  decoded (the fused-merge candidate), with ``topk_int_matches``: the
  sorted scores equal ``topk_f32``'s;
- ``merge``: the running merge of two [B, k] lists (``merge_topk``);
- ``block_iter``: one block through the port's ``bitpack_blockwise_topk``
  (``selection="bucketed"``, its own bucket 16), all of it.

The TPU's ``topk_approx`` (``lax.approx_max_k``) has no PyTorch
counterpart: ``"topk_approx": "n/a"``. Kernels #1 and #3 are held against
their plain versions at this shape (#3 on dyadic weights).
"""
from __future__ import annotations

import torch

from ..ops import bitpack
from ..ops.bitpack import BUCKET, ROW_BLOCK, _prepare_bf16, merge_topk
from ..ops.search import top_k
from . import common

BLOCK, B, K = 1 << 18, 1024, 100
V = common.V_BERT


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--rows", type=int, default=BLOCK)
        ap.add_argument("--b", type=int, default=B)

    args, dev, out = common.start(__doc__, argv, add)
    n, b = args.rows, args.b
    it = args.iters
    cols, nnz = common.stratified_ell(n, V, args.seed, dev)
    # dense queries, |N(0, 1)| on every id, as the TPU probe's
    q = torch.randn((b, V), device=dev,
                    generator=common.generator(dev, args.seed + 1)).abs_()
    out.update({"block_rows": n, "b": b, "v": V, "k": K, "bucket": BUCKET})

    def t(fn):
        return common.time_ms(fn, dev, it)


    out["pack_ms"] = t(lambda: bitpack.pack_bits(cols, nnz, V))
    words = bitpack.pack_bits(cols, nnz, V)
    out["pack_check"] = common.compare(
        words, bitpack.pack_bits_plain(cols, nnz, V))
    vp = words.shape[1] * 32
    qT = _prepare_bf16(q, vp)
    keys = bitpack.bucket_keys(words, qT, n)
    out["keys_ms"] = t(lambda: bitpack.bucket_keys(words, qT, n))
    out["keys_tfs"] = (None if out["keys_ms"] is None else
                       2.0 * b * n * V / (out["keys_ms"] * 1e-3) / 1e12)
    out["keys_plain_ms"] = common.time_ms(
        lambda: bitpack.bucket_keys_plain(words, qT, n), dev, 1)
    out["keys_bound"] = common.bound(
        words.numel() * 4 + qT.numel() * 2 + keys.numel() * 4,
        int(nnz.sum()) * b)
    dyT = common.dyadic_operand(vp, V, b, args.seed + 2, dev)
    out["keys_bit_identical_dyadic"] = bool(torch.equal(
        bitpack.bucket_keys(words, dyT, n),
        bitpack.bucket_keys_plain(words, dyT, n)))
    m = keys.shape[0]
    kb = ROW_BLOCK // BUCKET

    def topk_f32(keys):
        local = keys & (ROW_BLOCK - 1)
        scores = bitpack._key_scores(keys)
        gids = (torch.arange(m, device=dev) // kb)[:, None] * ROW_BLOCK \
            + local
        s, pos = top_k(scores.T, K)
        return torch.gather(gids.T, 1, pos), s

    def topk_int(keys):
        kt, pos = torch.topk(keys.T, K, dim=1)
        return ((pos // kb) * ROW_BLOCK + (kt & (ROW_BLOCK - 1)),
                bitpack._key_scores(kt))

    ids_f, s_f = topk_f32(keys)
    _, s_i = topk_int(keys)
    out["topk_f32_ms"] = t(lambda: topk_f32(keys))
    out["topk_int_ms"] = t(lambda: topk_int(keys))
    # ids may differ on tied scores (the int keys break ties by the spliced
    # row id); the masked scores must not
    out["topk_int_matches"] = bool(torch.equal(
        s_i.sort(dim=1).values, s_f.sort(dim=1).values))
    out["topk_approx"] = "n/a"
    best_s = torch.randn((b, K), device=dev,
                         generator=common.generator(dev, args.seed + 3))
    best_i = torch.zeros((b, K), dtype=torch.int64, device=dev)
    out["merge_ms"] = t(lambda: merge_topk(best_s, best_i, s_f, ids_f, K))
    del words, keys, qT, dyT
    out["block_iter_ms"] = common.time_ms(
        lambda: bitpack.bitpack_blockwise_topk(q, cols, nnz, V, K,
                                               block_rows=n,
                                               selection="bucketed"),
        dev, max(1, it // 2))
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
