"""Port parity of cross-modal retrieval: the valid-vocabulary maps, the
cross-modal text and image encoders, image preprocessing, the CLIP-RN
blocks, text -> image ``build_index("sparse")`` + ``retrieve`` and the
dense branch of the beta rerank, each against the JAX package on the same
numpy inputs and weights (JAX init carried over by ``models.convert``;
the CLIP-RN blocks from one torch state dict through both packages'
converters).

Tiny configs: BERT of 2 layers, hidden 64, 4 heads; the ViT at resolution
64 with patch 16. f32 throughout; only summation order differs (and, in
the CLIP-RN blocks, BatchNorm folded to one scale and shift): values to
rtol 1e-5 / atol 1e-5, ids and masks exactly."""
import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_tokenizer, make_vocab
from vsearch_tpu.models import clip_resnet as j_rn
from vsearch_tpu.models import crossmodal_image as j_img
from vsearch_tpu.models import crossmodal_text as j_txt
from vsearch_tpu.models import valid_vocab as j_vv
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu.tokenization.wordpiece import WordPieceTokenizer as JTok
from vsearch_tpu_torch.models import clip_resnet as t_rn
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.models import crossmodal_image as t_img
from vsearch_tpu_torch.models import crossmodal_text as t_txt
from vsearch_tpu_torch.models import valid_vocab as t_vv
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["green tea is a drink", "the red planet mars has ice water",
         "einstein wrote the famous theory of relativity and physics of "
         "space and time", "dog"]
CAPTIONS = ["green tea drink", "red planet mars", "a big dog runs fast",
            "river water"]
_TOK = make_tokenizer()
V = _TOK.vocab_size
BERT = {"vocab_size": V, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 64}
IMAGE = {"type": "vdr_crossmodal_image", "resolution": 64, "patch_size": 16,
         "width": 64, "layers": 2, "heads": 4, "topk": 16,
         "num_valid_tokens": V - 5}


def text_dict(**over):
    return {"type": "vdr_crossmodal_text", "max_len": 32, "topk": 16,
            **BERT, **over}


def pad7_vocab():
    """The test vocabulary with [PAD] moved to a valid id (7): the pad
    column then shows in the bag of words of padded rows."""
    vocab = make_vocab()
    other = next(t for t, i in vocab.items() if i == 7)
    vocab[other], vocab["[PAD]"] = vocab["[PAD]"], 7
    return vocab


def test_valid_vocab_matches_jax():
    assert len(t_vv.VALID_TOKEN_IDS) == 27623
    assert len(t_vv.invalid_token_ids()) == 2899
    np.testing.assert_array_equal(t_vv.VALID_TOKEN_IDS, j_vv.VALID_TOKEN_IDS)
    np.testing.assert_array_equal(t_vv.invalid_token_ids(),
                                  j_vv.invalid_token_ids())
    assert t_vv.LID2VID == j_vv.LID2VID and t_vv.VID2LID == j_vv.VID2LID
    for vs in (512, 30000, 30522, 31000):
        np.testing.assert_array_equal(
            t_txt.VDRTextEncoderConfig.from_dict(
                {"vocab_size": vs}).valid_ids,
            j_txt.VDRTextEncoderConfig.from_dict(
                {"vocab_size": vs}).valid_ids)


_TEXT = {}


def text_pair(compat: bool):
    """(JAX, port) cross-modal text encoders on one JAX init; with compat
    pooling the tokenizer's pad id is 7 (valid, nonzero)."""
    if compat not in _TEXT:
        vocab = pad7_vocab() if compat else make_vocab()
        d = text_dict(compat_pad_pooling=compat)
        j = j_txt.VDRTextEncoder(j_txt.VDRTextEncoderConfig.from_dict(d),
                                 tokenizer=JTok(dict(vocab)),
                                 rng=jax.random.PRNGKey(5))
        params = jax.tree_util.tree_map(np.asarray, j.variables["params"])
        t = t_txt.VDRTextEncoder(
            t_txt.VDRTextEncoderConfig.from_dict(d),
            state_dict=convert.crossmodal_text_state_dict_from_flax(
                params, 2),
            tokenizer=WordPieceTokenizer(dict(vocab)), device="cpu")
        _TEXT[compat] = (j, t)
    return _TEXT[compat]


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("topk", ["cfg", 0, None, 1000])
def test_text_embed_matches_jax(compat, topk):
    j, t = text_pair(compat)
    assert t.tokenizer.pad_id == (7 if compat else 0)
    got = t.embed(TEXTS, batch_size=3, topk=topk)
    want = np.asarray(j.embed(TEXTS, batch_size=3, topk=topk))
    assert got.shape == (len(TEXTS), V - 5)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("compat", [False, True])
def test_text_bow_and_disentangle_match_jax(compat):
    j, t = text_pair(compat)
    bow = t.embed(TEXTS, batch_size=3, bow=True)
    np.testing.assert_array_equal(bow, np.asarray(j.embed(
        TEXTS, batch_size=3, bow=True)))
    # padded rows carry the pad column when the pad id is valid
    assert bow[3, 7 - 5] == (1.0 if compat else 0.0)
    dj, dt = j.disentangle("green tea drink", topk=8), \
        t.disentangle("green tea drink", topk=8)
    assert list(dt) == list(dj)
    np.testing.assert_allclose(list(dt.values()), list(dj.values()), **TOL)


_IMAGE = {}


def image_pair():
    """(JAX, port) image encoders; the JAX init's all-ones projection is
    replaced by random values, so the top-k has no ties."""
    if not _IMAGE:
        cfg = j_img.VDRImageEncoderConfig.from_dict(IMAGE)
        j0 = j_img.VDRImageEncoder(cfg, tokenizer=_TOK,
                                   rng=jax.random.PRNGKey(6))
        params = jax.tree_util.tree_map(np.asarray, j0.variables["params"])
        params["proj"] = np.random.default_rng(6).normal(
            scale=0.1, size=params["proj"].shape).astype(np.float32)
        j = j_img.VDRImageEncoder(cfg, variables={"params": params},
                                  tokenizer=_TOK)
        t = t_img.VDRImageEncoder(
            t_img.VDRImageEncoderConfig.from_dict(IMAGE),
            state_dict=convert.vdr_image_state_dict_from_flax(params, 2),
            tokenizer=WordPieceTokenizer(dict(_TOK.vocab)), device="cpu")
        _IMAGE["pair"] = (j, t, params)
    return _IMAGE["pair"]


def pil_images(n, seed=7):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [Image.fromarray((rng.random((70 + 9 * i, 90 - 5 * i, 3)) * 255)
                            .astype(np.uint8)) for i in range(n)]


def test_preprocess_image_matches_jax():
    for img in pil_images(3):
        for res in (64, 224):
            np.testing.assert_array_equal(
                t_img.preprocess_image(img, res),
                j_img.preprocess_image(img, res))


@pytest.mark.parametrize("topk", [None, 5, 100000])
def test_image_embed_from_array_matches_jax(topk):
    j, t, _ = image_pair()
    pixels = np.random.default_rng(8).normal(
        size=(5, 64, 64, 3)).astype(np.float32)
    want = np.asarray(j.embed(pixels, topk=topk, batch_size=2))
    got = t.embed(pixels, topk=topk, batch_size=2)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, **TOL)
    # NCHW arrays and tensors on the device embed the same
    np.testing.assert_allclose(
        t.embed(pixels.transpose(0, 3, 1, 2), topk=topk), got, **TOL)
    np.testing.assert_allclose(
        t.embed(torch.from_numpy(pixels), topk=topk), got, **TOL)


def test_image_embed_from_pil_and_paths_match_jax(tmp_path):
    j, t, _ = image_pair()
    imgs = pil_images(3)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"im{i}.png"))
        img.save(paths[-1])
    want = np.asarray(j.embed(imgs))
    np.testing.assert_allclose(t.embed(imgs, batch_size=2), want, **TOL)
    np.testing.assert_allclose(t.embed(imgs[0]), want[:1], **TOL)
    np.testing.assert_allclose(t.embed(paths), np.asarray(j.embed(paths)),
                               **TOL)
    dj, dt = j.disentangle(imgs[0], topk=8), t.disentangle(imgs[0], topk=8)
    assert list(dt) == list(dj)


def test_image_module_is_f32_and_reference_named():
    _, t, _ = image_pair()
    names = set(t.module.state_dict())
    assert {"conv1.weight", "positional_embedding", "proj",
            "transformer.resblocks.1.attn.in_proj_weight",
            "transformer.resblocks.0.mlp.c_fc.bias"} <= names
    assert all(p.dtype == torch.float32 for p in t.module.parameters())
    # a reference state dict (extra entries dropped) loads as it is
    sd = dict(t.module.state_dict(), class_embedding=torch.zeros(64))
    assert convert.convert_vdr_image_params(sd).keys() == names


def _bn_stats(rng, c):
    return {"weight": rng.normal(size=c), "bias": rng.normal(size=c) * 0.1,
            "running_mean": rng.normal(size=c) * 0.1,
            "running_var": 0.5 + rng.random(c),
            "num_batches_tracked": np.asarray(3)}


@pytest.mark.parametrize("stride,inplanes,planes",
                         [(1, 64, 16), (2, 64, 32), (2, 16, 8)])
def test_bottleneck_matches_jax(stride, inplanes, planes):
    rng = np.random.default_rng(stride * 100 + planes)
    out = planes * 4
    shapes = {"conv1": (planes, inplanes, 1, 1),
              "conv2": (planes, planes, 3, 3), "conv3": (out, planes, 1, 1)}
    sd = {f"{n}.weight": rng.normal(size=s) * 0.1 for n, s in shapes.items()}
    for i, c in ((1, planes), (2, planes), (3, out)):
        sd.update({f"bn{i}.{k}": v for k, v in _bn_stats(rng, c).items()})
    if stride > 1 or inplanes != out:
        sd["downsample.0.weight"] = rng.normal(size=(out, inplanes, 1, 1)) \
            * 0.1
        sd.update({f"downsample.1.{k}": v
                   for k, v in _bn_stats(rng, out).items()})
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    x = rng.normal(size=(2, 8, 8, inplanes)).astype(np.float32)
    want = np.asarray(j_rn.Bottleneck(planes=planes, stride=stride).apply(
        j_rn.convert_bottleneck_params(sd), x))
    ours = t_rn.Bottleneck(inplanes, planes, stride=stride)
    ours.load_state_dict(t_rn.convert_bottleneck_params(
        {k: torch.from_numpy(v) for k, v in sd.items()}))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8 // stride, 8 // stride, out)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("output_dim", [None, 24])
def test_attention_pool_matches_jax(output_dim):
    rng = np.random.default_rng(9)
    s, d, heads = 4, 32, 4
    sd = {"positional_embedding": rng.normal(size=(s * s + 1, d)) / d ** .5}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        o = (output_dim or d) if name == "c_proj" else d
        sd[f"{name}.weight"] = rng.normal(size=(o, d)) * 0.1
        sd[f"{name}.bias"] = rng.normal(size=o) * 0.1
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    x = rng.normal(size=(3, s, s, d)).astype(np.float32)
    want = np.asarray(j_rn.AttentionPool2d(
        spacial_dim=s, embed_dim=d, num_heads=heads,
        output_dim=output_dim).apply(j_rn.convert_attnpool_params(sd), x))
    ours = t_rn.AttentionPool2d(s, d, heads, output_dim)
    ours.load_state_dict(t_rn.convert_attnpool_params(sd))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == (3, output_dim or d)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def text_image(tmp_path_factory):
    """(JAX, port) text -> image retrievers on the same weights, and PNG
    images (the JAX package's corpus is image paths)."""
    j_text, t_text = text_pair(False)
    j_image, t_image, image_params = image_pair()
    cfg = dict(encoder_q=text_dict(), encoder_p=dict(IMAGE),
               shared_encoder=False)
    j = JRetriever(JConfig(**cfg), tokenizer=_TOK)
    j.encoder_q.variables = j_text.variables
    j.encoder_p.variables = {"params": image_params}
    t = Retriever(RetrieverConfig(**cfg),
                  tokenizer=WordPieceTokenizer(dict(_TOK.vocab)),
                  device="cpu")
    t.encoder_q.module.load_state_dict(t_text.module.state_dict())
    t.encoder_p.module.load_state_dict(t_image.module.state_dict())
    d = tmp_path_factory.mktemp("images")
    paths = []
    for i, img in enumerate(pil_images(6, seed=10)):
        paths.append(str(d / f"im{i}.png"))
        img.save(paths[-1])
    return j, t, paths


def test_text_to_image_sparse_index_matches_jax(text_image):
    """``build_index("sparse")`` through the branch for encoders without
    ``embed_sparse`` (dense embeddings -> ELL rows of exactly ``topk``
    ids), then text -> image ``retrieve``; the port also takes the pixels
    themselves."""
    j, t, paths = text_image
    j.build_index(paths, batch_size=4, index_type="sparse")
    t.build_index(paths, batch_size=4, index_type="sparse")
    ell = t.index.ell
    assert ell.vals.dtype == torch.float32
    assert (ell.nnz.numpy() == IMAGE["topk"]).all()
    np.testing.assert_array_equal(ell.cols.numpy(),
                                  np.asarray(j.index.ell.cols))
    np.testing.assert_allclose(ell.vals.numpy(),
                               np.asarray(j.index.ell.vals), **TOL)
    got, want = t.retrieve(CAPTIONS, k=4), j.retrieve(CAPTIONS, k=4)
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), **TOL)
    pixels = np.stack([t_img.preprocess_image(
        __import__("PIL.Image").Image.open(p).convert("RGB"), 64)
        for p in paths])
    t.build_index(pixels, batch_size=4, index_type="sparse")
    assert t.index.data is pixels
    np.testing.assert_array_equal(t.retrieve(CAPTIONS, k=4).ids, got.ids)


def test_image_to_text_dense_index_matches_jax(text_image):
    """Image queries (embedded by the image encoder) against a dense index
    of caption embeddings, as a user of either package writes it."""
    j, t, paths = text_image
    from vsearch_tpu.index import DenseIndex as JDense
    from vsearch_tpu_torch.index import DenseIndex

    t_idx, j_idx = DenseIndex(dtype=torch.float32, device="cpu"), \
        JDense(dtype=np.float32)
    t_idx.set_vectors(t.encoder_q.embed(CAPTIONS))
    j_idx.set_vectors(np.asarray(j.encoder_q.embed(CAPTIONS)))
    q_t, q_j = t.encoder_p.embed(paths), np.asarray(j.encoder_p.embed(paths))
    np.testing.assert_allclose(q_t, q_j, **TOL)
    got = t.retrieve(q_t, k=3, index=t_idx)
    want = j.retrieve(q_j, k=3, index=j_idx)
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), **TOL)


def test_beta_rerank_dense_branch_matches_jax():
    """Beta search with a passage encoder that has no ``embed_sparse``
    (cross-modal text): the candidates are re-embedded densely and
    rescored on the host, in both packages."""
    from vsearch_tpu.index import BoTIndex as JBoT
    from vsearch_tpu.models import vdr as j_vdr
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.index.bot_build import build_bot_ell

    vdr = {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
           **BERT}
    cfg = dict(encoder_q=vdr, encoder_p=text_dict(), shared_encoder=False)
    j = JRetriever(JConfig(**cfg), tokenizer=_TOK)
    t = Retriever(RetrieverConfig(**cfg),
                  tokenizer=WordPieceTokenizer(dict(_TOK.vocab)),
                  device="cpu")
    assert isinstance(j.encoder_q, j_vdr.VDREncoder)
    t.encoder_q.module.load_state_dict(convert.vdr_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, j.encoder_q.variables["params"]),
        2))
    t.encoder_p.module.load_state_dict(
        convert.crossmodal_text_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray,
                                   j.encoder_p.variables["params"]), 2))
    corpus = TEXTS + CAPTIONS + ["the city river is big", "ice and tea"]
    # a BoT index in the query's space (shift 5: V - 5 columns)
    ell, cols, nnz = j._build_bot_ell(corpus, num_shift=5)
    j_idx = JBoT(search_mode="bitpack")
    j_idx.set_ell(ell, host_cache=(cols, nnz))
    t_idx = BoTIndex(search_mode="bitpack", device="cpu")
    t_idx.set_ell(build_bot_ell(t.encoder_p.tokenizer, corpus, max_len=128,
                                shift=5, vocab_size=V, device="cpu"))
    for idx in (j_idx, t_idx):
        idx.selection = "exact"
        idx.data = corpus
    queries = ["green tea", "the red planet", "dog runs in the city"]
    got = t.retrieve(queries, k=5, rerank=True, index=t_idx)
    want = j.retrieve(queries, k=5, rerank=True, index=j_idx)
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), **TOL)


def test_crossmodal_checkpoint_round_trip(text_image, tmp_path):
    """A text -> image retriever through ``save_pretrained``: the port
    reads it back bit for bit, and the JAX package (its reader of the HF
    layout) embeds both sides as the port does."""
    _, t, paths = text_image
    t.save_pretrained(str(tmp_path))
    back = Retriever.from_pretrained(str(tmp_path), device="cpu")
    assert back.encoder_q.config.compat_pad_pooling is False
    j = JRetriever.from_pretrained(str(tmp_path))
    for r in (back, j):
        np.testing.assert_allclose(np.asarray(r.encoder_q.embed(CAPTIONS)),
                                   t.encoder_q.embed(CAPTIONS), **TOL)
        np.testing.assert_allclose(np.asarray(r.encoder_p.embed(paths)),
                                   t.encoder_p.embed(paths), **TOL)
    np.testing.assert_array_equal(back.encoder_p.embed(paths),
                                  t.encoder_p.embed(paths))
