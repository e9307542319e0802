"""Port parity for the slice as a whole: SVDR beta search through
``vsearch_tpu_torch.Retriever`` against ``vsearch_tpu.Retriever`` on the
same tiny model (JAX init, carried over by the bridge), corpus and
queries, on the CPU; plus index files read and written both ways.

Both packages take the bit-packed first stage (``search_mode="bitpack"``;
on the CPU the JAX package would otherwise take the exact gather route),
with ``selection`` "exact" and "bucketed". Top-k ties break toward the
lower row in both, so ids compare exactly; scores compare to f32
summation-order tolerance."""
import numpy as np
import pytest
import torch

import jax

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu_torch.index import IndexType
from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
QUERIES = ["green tea drink", "theory of relativity", "mars ice water",
           "dog runs fast in the city", "light speed physics"]
CORPUS = [
    "green tea is a drink",
    "the red planet mars has ice water on the surface",
    "einstein wrote the famous theory of relativity",
    "a big dog runs fast in the city",
    "the river water runs slow and is small",
    "physics is the theory of space and time and light",
]


@pytest.fixture(scope="module")
def pair():
    tok = make_tokenizer()
    enc = {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
           **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
              if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                       "num_attention_heads", "intermediate_size",
                       "max_position_embeddings")}}
    j = JRetriever(JConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                           shared_encoder=True), tokenizer=tok)
    t = Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                  shared_encoder=True),
                  tokenizer=WordPieceTokenizer(dict(tok.vocab)),
                  device="cpu")
    params = jax.tree_util.tree_map(np.asarray,
                                    j.encoder_q.variables["params"])
    t.encoder_q.module.load_state_dict(vdr_state_dict_from_flax(params, 2))
    return j, t


@pytest.fixture(scope="module")
def big_corpus():
    """2,048 short passages: k * bucket < rows, so 'bucketed' takes the
    fused kernel's route and not the exact fallback."""
    rng = np.random.default_rng(5)
    words = [w for w in make_tokenizer().vocab if w.isalpha() and len(w) > 2]
    return [" ".join(rng.choice(words, size=int(n)))
            for n in rng.integers(3, 12, size=2048)]


def bitpack_index(r, corpus, selection):
    # batch_size only sizes the build's work split; at >= n / 4 both
    # packages tokenize in-process instead of forking workers
    r.build_index(corpus, batch_size=1024, index_type="bag_of_token")
    r.index.search_mode = "bitpack"
    r.index.selection = selection
    return r.index


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_beta_search_matches_jax(pair, big_corpus, selection):
    j, t = pair
    for r in pair:
        bitpack_index(r, big_corpus, selection)
    for rerank in (False, True):
        a = j.retrieve(QUERIES, k=6, rerank=rerank)
        b = t.retrieve(QUERIES, k=6, rerank=rerank)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.scores, a.scores, **TOL)
    stages = {"query_embed", "first_stage", "rerank"}
    assert stages <= set(t.last_timings)
    for key in set(t.last_timings) - stages:
        head = key.split("/")[0]
        assert "/" in key and (head in stages or head == "serve"), key


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_beta_search_block_tier_matches_jax(pair, big_corpus, selection):
    """The slice as a whole over an index in the block tier (two 1,024-row
    blocks): the first stage is the blockwise sweep, with int8 selection
    and an exact rerank under 'bucketed'."""
    j, t = pair
    for r in pair:
        r.build_index(big_corpus, batch_size=1024,
                      index_type="bag_of_token")
        r.index.search_mode = "block"
        r.index.stream_block_rows = 1024
        r.index.selection = selection
    assert t.index._block_selection() == (
        "bucketed_int8" if selection == "bucketed" else "exact")
    for rerank in (False, True):
        a = j.retrieve(QUERIES, k=6, rerank=rerank)
        b = t.retrieve(QUERIES, k=6, rerank=rerank)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.scores, a.scores, **TOL)


@pytest.mark.parametrize("index_type", ["dense", "sparse", "bag_of_token"])
def test_alpha_search_matches_jax(pair, index_type):
    j, t = pair
    for r in pair:
        r.build_index(CORPUS, batch_size=4, index_type=index_type)
    a, b = j.retrieve(QUERIES, k=3), t.retrieve(QUERIES, k=3)
    np.testing.assert_array_equal(b.ids, a.ids)
    # dense indexes store bf16 vectors on both sides
    tol = dict(rtol=2e-2, atol=2e-2) if index_type == "dense" else TOL
    np.testing.assert_allclose(b.scores, a.scores, **tol)


def test_rerank_k_exceeding_corpus(pair):
    j, t = pair
    for r in pair:
        r.build_index(CORPUS, batch_size=4, index_type="bag_of_token")
    a = j.retrieve(["green tea drink"], k=100, rerank=True)
    b = t.retrieve(["green tea drink"], k=100, rerank=True)
    assert b.ids.shape == (1, len(CORPUS))
    np.testing.assert_array_equal(b.ids, a.ids)


def test_dict_corpus_and_explain(pair):
    j, t = pair
    corpus = [{"text": c, "title": f"t{i}" if i % 2 else ""}
              for i, c in enumerate(CORPUS)]
    for r in pair:
        r.build_index(corpus, batch_size=4, index_type="bag_of_token")
    a = j.retrieve(QUERIES[:2], k=2, rerank=True)
    b = t.retrieve(QUERIES[:2], k=2, rerank=True)
    np.testing.assert_array_equal(b.ids, a.ids)
    assert isinstance(t.index.get_sample(int(b.ids[0, 0])), dict)
    ej = j.explain("green tea", "green tea is a drink", topk=20)
    et = t.explain("green tea", "green tea is a drink", topk=20)
    assert list(et) == list(ej)


@pytest.mark.parametrize("suffix", [".ell.npz", ".bot.npz"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bot_index_files_both_ways(pair, tmp_path, suffix, writer):
    j, t = pair
    src, dst = (j, t) if writer == "jax" else (t, j)
    for r in pair:
        r.build_index(CORPUS, batch_size=4, index_type="bag_of_token")
    before = dst.retrieve(QUERIES, k=3)
    path = str(tmp_path / f"idx{suffix}")
    src.save_index(path)
    dst.load_index(index_file=path)
    assert dst.index.index_type.value == IndexType.BAG_OF_TOKEN.value
    dst.index.data = list(CORPUS)
    after = dst.retrieve(QUERIES, k=3)
    np.testing.assert_array_equal(after.ids, before.ids)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sparse_index_files_both_ways(pair, tmp_path, writer):
    j, t = pair
    src, dst = (j, t) if writer == "jax" else (t, j)
    for r in pair:
        r.build_index(CORPUS, batch_size=4, index_type="sparse")
    before = dst.retrieve(QUERIES, k=3)
    for name in ("idx.npz", "idx.ell.npz"):
        path = str(tmp_path / name)
        src.save_index(path)
        dst.load_index(index_file=path)
        assert dst.index.index_type.value == "sparse"
        dst.index.data = list(CORPUS)
        after = dst.retrieve(QUERIES, k=3)
        np.testing.assert_array_equal(after.ids, before.ids)
        # f16 values on disk
        np.testing.assert_allclose(after.scores, before.scores, rtol=5e-3,
                                   atol=5e-3)


def test_biencoder_forward_matches_jax(pair):
    """``BiEncoder.forward``: token tensors -> each encoder module's raw
    embeddings, equal to the JAX package's ``forward`` (f32); calling the
    model is the same; dropout needs a seed, draws other masks for the
    two sides and repeats them for a repeated seed."""
    j, t = pair
    rng = np.random.default_rng(11)
    v = t.encoder_q.config.vocab_size
    q = rng.integers(5, v, size=(3, 10)).astype(np.int32)
    p = rng.integers(5, v, size=(6, 14)).astype(np.int32)
    q[1, 7:] = 0
    p[2, 9:] = 0
    args = (q, np.zeros_like(q), (q != 0).astype(np.int32),
            p, np.zeros_like(p), (p != 0).astype(np.int32))
    with torch.no_grad():
        q_emb, p_emb = t.forward(*args)
        called = t(*args)
    jq, jp = j.forward(*args)
    assert q_emb.shape == (3, v - 5) and p_emb.shape == (6, v - 5)
    assert q_emb.device == t.device
    np.testing.assert_allclose(q_emb.numpy(), np.asarray(jq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p_emb.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(called, (q_emb, p_emb)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires a seed"):
        t.forward(*args, deterministic=False)
    same = (q, args[1], args[2]) * 2
    with torch.no_grad():
        d1 = t.forward(*same, deterministic=False, seed=3)
        d2 = t.forward(*same, deterministic=False, seed=3)
        d3 = t.forward(*same, deterministic=False, seed=4)
    assert not t.encoder_q.module.training
    torch.testing.assert_close(d1[0], d2[0], rtol=0, atol=0)
    assert not torch.equal(d1[0], d1[1])  # lanes 0 and 1
    assert not torch.equal(d1[0], d3[0])
    assert not torch.equal(d1[0], q_emb)
