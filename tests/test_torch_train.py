"""Port parity of training: the losses, the cts masks, the train step's
gradients, the optimizer with its clip and schedules, negative mining and a
short trainer run, against the JAX package on the same numpy inputs (JAX on
the CPU); then port-only checks of resume, checkpoints, remat, the CLI and
the prefetch thread.

Tolerances (f32 on the CPU on both sides, dropout 0 wherever the two
packages are compared):
- losses and correct counts: rtol 1e-5 (one softmax over the same scores);
- gradients through 2 BERT layers and the vocabulary projection: rtol 1e-4
  and atol 1e-5 of the largest gradient (summation order only; the token
  type embedding's gradient sums every token's and cancels to ~1e-3 of
  the largest);
- AdamW + clip on identical gradients over 5 updates: rtol 1e-5, atol 1e-7
  of the parameter scale;
- lr schedules: rtol 1e-6 (optax computes them in f32);
- trainer per-step losses over 2 epochs (6 steps): rtol 2e-5 (measured
  3e-6 at most; Adam's first update is ~lr x sign(g), so rounding in
  near-zero gradients can move a parameter by up to lr, which is why the
  parameters themselves are compared only on identical gradients).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.helpers import make_tokenizer
from vsearch_tpu.data import BiEncoderDataset as JDataset
from vsearch_tpu.models import dpr as j_dpr
from vsearch_tpu.models import vdr as j_vdr
from vsearch_tpu.ops import sparse as j_sparse
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JRetrieverConfig
from vsearch_tpu.train import loss as j_loss
from vsearch_tpu.train import optim as j_optim
from vsearch_tpu.train import step as j_step
from vsearch_tpu.train.trainer import RetrieverTrainer as JTrainer
from vsearch_tpu.train.trainer import TrainConfig as JTrainConfig
from vsearch_tpu_torch.data import BiEncoderDataset
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.models import dpr as t_dpr
from vsearch_tpu_torch.models import vdr as t_vdr
from vsearch_tpu_torch.models.vdr import _masked_max_project
from vsearch_tpu_torch.ops import sparse as t_sparse
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer
from vsearch_tpu_torch.train import loss as t_loss
from vsearch_tpu_torch.train import optim as t_optim
from vsearch_tpu_torch.train import step as t_step
from vsearch_tpu_torch.train.checkpoint import (load_checkpoint,
                                                resolve_checkpoint_dir,
                                                save_checkpoint)
from vsearch_tpu_torch.train.trainer import RetrieverTrainer, TrainConfig

_TOK = make_tokenizer()
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LAYERS = 2
WORDS = ["tea", "mars", "einstein", "dog", "river", "physics", "city",
         "water", "light", "planet"]


def port_tok():
    return WordPieceTokenizer(dict(_TOK.vocab))


def enc_dict(kind="vdr", **over):
    d = {"type": kind, "max_len": 32, "vocab_size": _TOK.vocab_size,
         "hidden_size": 32, "num_hidden_layers": LAYERS,
         "num_attention_heads": 2, "intermediate_size": 64,
         "max_position_embeddings": 64, "hidden_dropout_prob": 0.0,
         "attention_probs_dropout_prob": 0.0}
    if kind == "vdr":
        d.update(topk=16, shift_vocab_num=5)
    d.update(over)
    return d


# -- losses ------------------------------------------------------------------
def _embs(seed, n=6, negs=1, v=40):
    r = np.random.default_rng(seed)
    m = n * (1 + negs)
    q = r.random((n, v)).astype(np.float32) * 2
    p = r.random((m, v)).astype(np.float32) * 2
    qb = (r.random((n, v)) < 0.2).astype(np.float32)
    pb = (r.random((m, v)) < 0.3).astype(np.float32)
    qb[:, :3] = 0  # slots no row uses: the cts mask has work to do
    pb[:, :3] = 0
    return q, p, qb, pb


def _both_losses(fn_j, fn_t, *arrays):
    lj, mj = fn_j(*[jnp.asarray(a) for a in arrays])
    lt, mt = fn_t(*[torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(float(lt), float(lj), **LOSS_TOL)
    for key in ("correct_parametric", "correct_semiparametric",
                "batch_size"):
        assert float(mt[key]) == float(mj[key]), key
    return float(lt)


@pytest.mark.parametrize("semi", [True, False])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("cts", ["off", "on", "norm"])
def test_vdr_loss_matches_jax(semi, sym, scaled, cts):
    kw = dict(semi=semi, sym_loss=sym, scaled_loss=scaled, topk=8,
              temperature=0.7 if sym else 1.0, cts_mask=cts != "off",
              cts_mask_norm=cts == "norm", cts_mask_weight=0.5)
    cj, ct = j_loss.VDRLossConfig(**kw), t_loss.VDRLossConfig(**kw)
    val = _both_losses(
        lambda *a: j_loss.compute_vdr_loss(*a, cj),
        lambda *a: t_loss.compute_vdr_loss(*a, ct), *_embs(1))
    assert np.isfinite(val)


@pytest.mark.parametrize("sym", [True, False])
def test_dpr_loss_matches_jax(sym):
    cj = j_loss.VDRLossConfig(sym_loss=sym)
    ct = t_loss.VDRLossConfig(sym_loss=sym)
    q, p, _, _ = _embs(2)
    _both_losses(lambda a, b: j_loss.compute_dpr_loss(a, b, cj),
                 lambda a, b: t_loss.compute_dpr_loss(a, b, ct), q, p)


@pytest.mark.parametrize("n,v", [(1, 7), (4, 9), (6, 40), (9, 5)])
def test_cts_masks_exact(n, v):
    r = np.random.default_rng(n * 100 + v)
    bow = (r.random((n, v)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        t_sparse.init_cts_mask_like(torch.from_numpy(bow)).numpy(),
        np.asarray(j_sparse.init_cts_mask_like(jnp.asarray(bow))))
    np.testing.assert_array_equal(
        t_sparse.build_cts_mask(torch.from_numpy(bow)).numpy(),
        np.asarray(j_sparse.build_cts_mask(jnp.asarray(bow))))


def test_max_pool_gradient_splits_ties_as_jax():
    """Tied maxima (duplicate positions) share the gradient evenly in both
    packages: amax, not an argmax gather."""
    r = np.random.default_rng(3)
    h = r.standard_normal((2, 4, 8)).astype(np.float32)
    h[0, 2] = h[0, 0]  # exact ties at every vocab slot of row 0
    h[1, 3] = h[1, 1] = h[1, 0]  # a three-way tie in row 1
    proj = r.standard_normal((10, 8)).astype(np.float32)
    valid = np.ones((2, 4), bool)
    valid[1, 2] = False
    w = r.standard_normal((2, 10)).astype(np.float32)

    def jfn(hh, pp):
        lg = jnp.einsum("blh,vh->blv", hh, pp,
                        precision=jax.lax.Precision.HIGHEST)
        return (jnp.where(valid[:, :, None], lg, -jnp.inf).max(axis=1)
                * w).sum()

    gh_j, gp_j = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(h),
                                                jnp.asarray(proj))
    for remat in (False, True):
        ht = torch.from_numpy(h).requires_grad_()
        pt = torch.from_numpy(proj).requires_grad_()
        (_masked_max_project(ht, pt, torch.from_numpy(valid), remat)
         * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp_j),
                                   rtol=1e-5, atol=1e-6)
    # each of row 0's two tied positions gets half of every slot's weight
    np.testing.assert_allclose(np.asarray(gh_j)[0, 0],
                               np.asarray(gh_j)[0, 2], rtol=1e-6)


# -- gradients of the train step --------------------------------------------
def _batch(seed, vocab, n=4, negs=1, lq=16, lp=32):
    r = np.random.default_rng(seed)
    q = r.integers(5, vocab, size=(n, lq))
    p = r.integers(5, vocab, size=(n * (1 + negs), lp))
    p[:n, :lq // 2] = q[:, :lq // 2]  # positives share query tokens
    for rows in (q, p):  # ragged padding
        for i in range(len(rows)):
            cut = rows.shape[1] - int(r.integers(0, rows.shape[1] // 2))
            rows[i, cut:] = 0
    return q.astype(np.int32), p.astype(np.int32)


_MODELS = {}


def jax_model(kind, seed):
    """(JAX module, its params as numpy) for one encoder kind and seed."""
    key = (kind, seed)
    if key not in _MODELS:
        if kind == "vdr":
            cfg = j_vdr.VDREncoderConfig.from_dict(enc_dict("vdr"))
            module = j_vdr.VDRModule(cfg)
        else:
            cfg = j_dpr.DPREncoderConfig.from_dict(enc_dict("dpr"))
            module = j_dpr.DPRModule(cfg)
        dummy = jnp.zeros((1, 8), jnp.int32)
        params = module.init(jax.random.PRNGKey(seed), dummy, dummy,
                             dummy + 1)["params"]
        _MODELS[key] = (module, jax.tree_util.tree_map(np.asarray, params))
    return _MODELS[key]


def to_port(kind, params_or_grads):
    fn = (convert.vdr_state_dict_from_flax if kind == "vdr"
          else convert.dpr_state_dict_from_flax)
    return fn(params_or_grads, LAYERS)


def port_module(kind, params):
    cls_cfg, cls_mod = ((t_vdr.VDREncoderConfig, t_vdr.VDRModule)
                        if kind == "vdr"
                        else (t_dpr.DPREncoderConfig, t_dpr.DPRModule))
    m = cls_mod(cls_cfg.from_dict(enc_dict(kind)))
    m.load_state_dict(to_port(kind, params))
    return m


def _step_cfgs(kind, semi):
    loss_kw = dict(semi=semi, topk=16)
    common = dict(encoder_type=kind, vocab_size=_TOK.vocab_size,
                  shift_vocab_num=5 if kind == "vdr" else 0)
    return (j_step.TrainStepConfig(loss=j_loss.VDRLossConfig(**loss_kw),
                                   **common),
            t_step.TrainStepConfig(loss=t_loss.VDRLossConfig(**loss_kw),
                                   **common))


def jax_loss_and_grads(kind, semi, shared, q, p):
    module, pq = jax_model(kind, 0)
    params = pq if shared else {"q": pq, "p": jax_model(kind, 1)[1]}
    cfg, _ = _step_cfgs(kind, semi)
    apply = j_step.make_encoder_apply(module, deterministic=True)

    def loss_fn(prm):
        q_emb = apply(prm if shared else prm["q"], jnp.asarray(q), None)
        p_emb = apply(prm if shared else prm["p"], jnp.asarray(p), None)
        if kind == "dpr":
            return j_loss.compute_dpr_loss(q_emb, p_emb, cfg.loss)[0]
        bows = [j_sparse.build_bow_mask(jnp.asarray(x),
                                        vocab_size=cfg.vocab_size,
                                        shift_num=cfg.shift_vocab_num)
                for x in (q, p)]
        return j_loss.compute_vdr_loss(q_emb, p_emb, *bows, cfg.loss)[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return (float(loss), jax.tree_util.tree_map(np.asarray, grads),
            float(optax.global_norm(grads)))


def port_state(kind, shared, remat=False, lr=0.0, max_grad_norm=None):
    """A port TrainState on the JAX init's weights, its apply fns."""
    mq = port_module(kind, jax_model(kind, 0)[1])
    module = mq if shared else torch.nn.ModuleDict(
        {"q": mq, "p": port_module(kind, jax_model(kind, 1)[1])})
    mods = (mq, mq) if shared else (module["q"], module["p"])
    applies = [t_step.make_encoder_apply(m, deterministic=True, remat=remat)
               for m in mods]
    tx = t_optim.get_optimizer([module], learning_rate=lr,
                               max_grad_norm=max_grad_norm)
    return t_step.TrainState.create(module, tx), applies


def port_grads(state):
    return {k: p.grad.numpy().copy()
            for k, p in state.module.named_parameters()}


@pytest.mark.parametrize("kind,semi", [("vdr", True), ("vdr", False),
                                       ("dpr", True)])
@pytest.mark.parametrize("shared", [True, False])
def test_step_gradients_match_jax(kind, semi, shared):
    q, p = _batch(7, _TOK.vocab_size)
    loss_j, grads_j, norm_j = jax_loss_and_grads(kind, semi, shared, q, p)
    state, (aq, ap) = port_state(kind, shared)
    step = t_step.make_train_step(aq, ap, _step_cfgs(kind, semi)[1],
                                  shared_params=shared)
    state, metrics = step(state, t_step.TrainBatch(
        torch.from_numpy(q).long(), torch.from_numpy(p).long()), 0)
    np.testing.assert_allclose(float(metrics["loss"]), loss_j, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), norm_j,
                               rtol=1e-4)
    if shared:
        expect = to_port(kind, grads_j)
    else:
        expect = {f"{side}.{k}": v for side in ("q", "p")
                  for k, v in to_port(kind, grads_j[side]).items()}
    got = port_grads(state)
    assert set(got) == set(expect)
    scale = max(float(v.abs().max()) for v in expect.values())
    for name, g in expect.items():
        np.testing.assert_allclose(got[name], g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_remat_gives_the_same_gradients():
    """remat=True (checkpointed layers and pooling chunks) gives the
    gradients of remat=False, with dropout on (the checkpoint restores the
    generator, so the recomputed masks are the same)."""
    q, p = _batch(8, _TOK.vocab_size)
    got = []
    for remat in (False, True):
        state, _ = port_state("vdr", shared=False)
        applies = [t_step.make_encoder_apply(m, deterministic=False,
                                             remat=remat)
                   for m in (state.module["q"], state.module["p"])]
        for m in state.module.modules():  # dropout on
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.1
        step = t_step.make_train_step(*applies, _step_cfgs("vdr", True)[1])
        state, metrics = step(state, t_step.TrainBatch(
            torch.from_numpy(q).long(), torch.from_numpy(p).long()), 5)
        got.append((float(metrics["loss"]), port_grads(state)))
    assert got[0][0] == got[1][0]
    for name, g in got[0][1].items():
        np.testing.assert_allclose(got[1][1][name], g, rtol=1e-6,
                                   atol=1e-9, err_msg=name)


# -- optimizer and schedules -------------------------------------------------
@pytest.mark.parametrize("weight_decay,max_norm", [(0.0, 2.0), (0.01, 0.05),
                                                   (0.1, None)])
def test_adamw_clip_schedule_match_optax(weight_decay, max_norm):
    """5 updates on identical gradients: optax's clip_by_global_norm +
    adamw (no-decay mask on biases and LayerNorm scales) + linear warmup
    schedule against the port's Optimizer. The middle case clips on some
    steps only."""
    _, params = jax_model("vdr", 0)
    sched_j = j_optim.get_schedule_linear(2, 5, 1e-3)
    tx = j_optim.get_optimizer(params, learning_rate=1e-3,
                               weight_decay=weight_decay,
                               max_grad_norm=max_norm, schedule=sched_j)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    module = port_module("vdr", params)
    opt = t_optim.get_optimizer([module], learning_rate=1e-3,
                                weight_decay=weight_decay,
                                max_grad_norm=max_norm,
                                schedule=t_optim.get_schedule_linear(
                                    2, 5, 1e-3))
    r = np.random.default_rng(11)
    named = dict(module.named_parameters())
    for i in range(5):
        gscale = 0.02 * (i + 1)  # norms straddle the clip in case 2
        grads = jax.tree_util.tree_map(
            lambda x: (r.standard_normal(x.shape) * gscale)
            .astype(np.float32), params)
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, g in to_port("vdr", grads).items():
            named[name].grad = g.clone()
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            grads)), rtol=1e-5)
        assert opt.lr() == pytest.approx(float(sched_j(i)), rel=1e-6)
    expect = to_port("vdr", jax.tree_util.tree_map(np.asarray, jp))
    for name, v in expect.items():
        np.testing.assert_allclose(named[name].detach().numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_no_decay_groups_by_module_type():
    module = port_module("vdr", jax_model("vdr", 0)[1])
    decay, no_decay = t_optim.decay_groups([module])
    names = {id(p): n for n, p in module.named_parameters()}
    nd = {names[id(p)] for p in no_decay}
    assert "ln.weight" in nd and "ln.bias" in nd
    assert all(n.endswith("bias") or "LayerNorm" in n or n.startswith("ln.")
               for n in nd)
    assert {names[id(p)] for p in decay} == set(names.values()) - nd
    assert "bert_model.embeddings.word_embeddings.weight" not in nd


@pytest.mark.parametrize("kind,args", [
    ("linear", (3, 10, 2e-5)), ("linear", (0, 7, 1e-3)),
    ("linear", (5, 5, 1e-4)), ("linear", (2, 9, 1e-3, 3)),
    ("cosine", (3, 10, 2e-5)), ("cosine", (0, 1, 1e-3)),
    ("warmup", (4, 1e-3)), ("warmup", (0, 2e-5))])
def test_schedules_match_jax(kind, args):
    fj = getattr(j_optim, f"get_schedule_{kind}")(*args)
    ft = getattr(t_optim, f"get_schedule_{kind}")(*args)
    for step in range(14):
        np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


# -- negative mining ---------------------------------------------------------
CORPUS = [{"text": f"{w} {WORDS[(i * 3) % 10]} passage {i % 4} about "
                   f"{WORDS[(i * 7) % 10]}", "title": WORDS[i % 10]}
          for i, w in enumerate(WORDS * 4)]


@pytest.fixture(scope="module")
def mining_pair():
    """(JAX, port) retrievers with bag-of-token indexes of CORPUS."""
    enc = enc_dict("vdr")
    j = JRetriever(JRetrieverConfig(encoder_q=enc, encoder_p=enc,
                                    shared_encoder=True), tokenizer=_TOK)
    j.build_index(CORPUS, index_type="bag_of_token")
    t = Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                                  shared_encoder=True), tokenizer=port_tok(),
                  device="cpu")
    t.build_index(CORPUS, index_type="bag_of_token")
    return j, t


@pytest.mark.parametrize("seed,dropout,pool", [(0, 0.0, 100), (7, 0.0, 3),
                                               (3, 0.5, 100)])
def test_retrieve_negatives_matches_jax(mining_pair, seed, dropout, pool):
    j, t = mining_pair
    r = np.random.default_rng(seed)
    v = _TOK.vocab_size - 5
    q = np.zeros((4, v), np.float32)
    for i in range(4):  # weight on a few words of the corpus
        ids = _TOK.encode(" ".join(WORDS[i:i + 3]))[1:-1]
        q[i, np.array(ids) - 5] = r.random(len(ids)) + 0.5
    # a word of the query, or one it lacks: the pool pads for some rows
    answers = [[WORDS[i + (5 if i % 2 else 0)]] for i in range(4)]
    kw = dict(answers=answers, ret_neg_num=2, ret_topk=12, pool_size=pool,
              ret_dropout=dropout, seed=seed)
    got = t.retrieve_negatives(q, **kw)
    assert got == j.retrieve_negatives(q, **kw)
    assert got == t.retireve_negatives(q, **kw)
    hits = t.retrieve(q, a=768, k=12, dropout=dropout,
                      rng=np.random.default_rng(seed)).ids
    padded = 0
    for ans, negs, row in zip(answers, got, hits):
        assert len(negs) == 2
        clean = [i for i in row
                 if ans[0] not in CORPUS[int(i)]["text"].split()]
        if len(clean) >= 2:  # unpadded pool: no negative holds the answer
            assert not any(ans[0] in n.split() for n in negs)
        else:
            padded += 1
    assert padded < len(answers)


# -- the trainer against the JAX trainer -----------------------------------
@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    """tests/test_trainer.py's JSONL schema: 24 samples, one hard negative
    each."""
    d = tmp_path_factory.mktemp("train")
    rows = [{"question": f"what is {WORDS[i % 10]}",
             "answers": [WORDS[i % 10]],
             "positive_ctxs": [{"text": f"{WORDS[i % 10]} is the answer "
                                        f"about {WORDS[i % 10]}",
                                "title": WORDS[i % 10]}],
             "negative_ctxs": [],
             "hard_negative_ctxs": [{"text": f"unrelated passage number "
                                             f"{i}"}]}
            for i in range(24)]
    path = d / "train.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


def tiny_enc(**over):
    return enc_dict("vdr", max_len=24, **over)


def port_retriever(jr=None, **over):
    enc = tiny_enc(**over)
    r = Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                                  shared_encoder=True),
                  tokenizer=port_tok(), seed=4, device="cpu")
    if jr is not None:
        params = jax.tree_util.tree_map(
            np.asarray, jr.encoder_q.variables["params"])
        r.encoder_q.module.load_state_dict(to_port("vdr", params))
    return r


def record_losses(trainer, out):
    """Wrap the trainer's step (built in _init_state) to record losses."""
    orig_init = trainer._init_state

    def init(updates_per_epoch):
        orig_init(updates_per_epoch)
        step = trainer._step_fn

        def recorded(state, batch, rng):
            state, metrics = step(state, batch, rng)
            out.append(float(metrics["loss"]))
            return state, metrics

        trainer._step_fn = recorded

    trainer._init_state = init


def test_trainer_losses_match_jax(train_file, tmp_path):
    kw = dict(batch_size=8, num_train_epochs=2, learning_rate=5e-4,
              num_epoch_to_save=10, log_batch_step=100, seed=3)
    enc = tiny_enc()
    jr = JRetriever(JRetrieverConfig(encoder_q=enc, encoder_p=enc,
                                     shared_encoder=True), tokenizer=_TOK)
    tr = port_retriever(jr)
    lj, lt = [], []
    jt = JTrainer(jr, JTrainConfig(output_dir=str(tmp_path / "j"), **kw),
                  [JDataset(train_file)])
    record_losses(jt, lj)
    jt.run_train()
    tt = RetrieverTrainer(tr, TrainConfig(output_dir=str(tmp_path / "t"),
                                          **kw),
                          [BiEncoderDataset(train_file)])
    record_losses(tt, lt)
    tt.run_train()
    assert len(lt) == len(lj) == 6 and tt.state.step == 6
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=2e-5)


# -- port only ---------------------------------------------------------------
def run_trainer(train_file, out_dir, steps_log=None, **kw):
    cfg = dict(batch_size=8, num_train_epochs=2, learning_rate=5e-4,
               num_epoch_to_save=10, seed=9, output_dir=str(out_dir))
    cfg.update(kw)
    t = RetrieverTrainer(port_retriever(hidden_dropout_prob=0.1,
                                        attention_probs_dropout_prob=0.1),
                         TrainConfig(**cfg), [BiEncoderDataset(train_file)])
    if steps_log is not None:
        record_losses(t, steps_log)
    return t


def test_resume_is_bit_exact(train_file, tmp_path):
    """With dropout on, a run that dies after a mid-epoch save and is
    resumed by a fresh trainer ends on the uninterrupted run's weights,
    bit for bit, and replays its losses exactly."""
    ref_losses, losses = [], []
    t0 = run_trainer(train_file, tmp_path / "ref", ref_losses)
    t0.run_train()
    assert t0.state.step == 6

    t1 = run_trainer(train_file, tmp_path / "run", save_steps=2)
    orig_init = t1._init_state

    def init_and_arm(n):
        orig_init(n)
        step, calls = t1._step_fn, {"n": 0}

        def dying(state, batch, rng):
            if calls["n"] == 5:
                raise KeyboardInterrupt("simulated crash after step 5")
            calls["n"] += 1
            return step(state, batch, rng)

        t1._step_fn = dying

    t1._init_state = init_and_arm
    with pytest.raises(KeyboardInterrupt):
        t1.run_train()

    t2 = run_trainer(train_file, tmp_path / "run", losses, save_steps=2)
    t2.run_train(resume=True)
    assert (t2.start_epoch, t2.start_batch, t2.state.step) == (1, 2, 6)
    assert losses == ref_losses[-1:]
    ref = t0.state.params
    for name, v in t2.state.params.items():
        assert torch.equal(v, ref[name]), name
    for p_ref, p_new in zip(t0.state.tx.adamw.state.values(),
                            t2.state.tx.adamw.state.values()):
        assert torch.equal(p_ref["exp_avg"], p_new["exp_avg"])


def test_checkpoint_atomicity_crash_windows(train_file, tmp_path):
    """A crash at any point of a train-state save leaves a resumable
    checkpoint: the committed dir, then a complete .tmp, then .old."""
    t = run_trainer(train_file, tmp_path, num_train_epochs=1,
                    num_epoch_to_save=1)
    t.run_train()
    ckpt = str(tmp_path / "train_state")
    assert resolve_checkpoint_dir(ckpt) == os.path.abspath(ckpt)

    # crash after the old dir was displaced, before the tmp rename
    save_checkpoint(ckpt, t.state, epoch=1, offset=2)
    os.rename(ckpt, ckpt + ".old")
    shutil.copytree(ckpt + ".old", ckpt + ".tmp")
    got = resolve_checkpoint_dir(ckpt)
    assert got == ckpt + ".tmp"
    t2 = run_trainer(train_file, tmp_path, num_train_epochs=1)
    t2._init_state(3)
    state, meta = load_checkpoint(got, t2.state)
    assert meta["epoch"] == 1 and meta["offset"] == 2 and state.step == 3

    # crash during the tmp write (meta missing): the displaced .old wins
    shutil.rmtree(ckpt + ".tmp")
    os.makedirs(ckpt + ".tmp")
    open(os.path.join(ckpt + ".tmp", "state.pt"), "wb").close()
    assert resolve_checkpoint_dir(ckpt) == ckpt + ".old"

    # a fresh save on top of the debris commits cleanly again
    shutil.rmtree(ckpt + ".tmp")
    os.rename(ckpt + ".old", ckpt)
    save_checkpoint(ckpt, t.state, epoch=1, offset=3)
    assert resolve_checkpoint_dir(ckpt) == os.path.abspath(ckpt)
    assert not os.path.exists(ckpt + ".tmp")
    _, meta = load_checkpoint(ckpt, t2.state)
    assert meta["offset"] == 3


def test_checkpoint_tmp_promoted_before_next_save(train_file, tmp_path,
                                                  monkeypatch):
    """After a crash between displacing the old dir and committing .tmp,
    the next save promotes the complete .tmp (the newest good checkpoint)
    before writing; if that save then crashes, the promoted state
    survives at the committed path."""
    import vsearch_tpu_torch.train.checkpoint as ckpt_mod

    t = run_trainer(train_file, tmp_path, num_train_epochs=1,
                    num_epoch_to_save=1)
    t.run_train()
    ckpt = str(tmp_path / "train_state")
    save_checkpoint(ckpt, t.state, epoch=1, offset=5)
    os.rename(ckpt, ckpt + ".tmp")
    assert resolve_checkpoint_dir(ckpt) == ckpt + ".tmp"

    class Boom(Exception):
        pass

    def failing_save(*a, **k):
        raise Boom()

    monkeypatch.setattr(ckpt_mod.torch, "save", failing_save)
    with pytest.raises(Boom):
        save_checkpoint(ckpt, t.state, epoch=2, offset=0)
    monkeypatch.undo()
    got = resolve_checkpoint_dir(ckpt)
    assert got == os.path.abspath(ckpt)
    t2 = run_trainer(train_file, tmp_path, num_train_epochs=1)
    t2._init_state(3)
    _, meta = load_checkpoint(got, t2.state)
    assert meta["epoch"] == 1 and meta["offset"] == 5


def test_prefetch_thread_surfaces_worker_error_and_stops(train_file,
                                                         tmp_path,
                                                         monkeypatch):
    """An exception in the producer thread reaches the training loop, and
    the thread ends instead of producing the rest of the epoch."""
    import threading

    t = run_trainer(train_file, tmp_path, num_train_epochs=1,
                    prefetch_batches=1)
    made = []
    orig = t._make_device_batch

    def flaky(samples, epoch, iteration, source=0):
        made.append(iteration)
        if len(made) == 2:
            raise ValueError("tokenizer failed")
        return orig(samples, epoch, iteration, source)

    monkeypatch.setattr(t, "_make_device_batch", flaky)
    before = threading.active_count()
    with pytest.raises(ValueError, match="tokenizer failed"):
        t.run_train()
    assert threading.active_count() == before
    assert len(made) == 2 and t.state.step <= 1


def test_prefetch_thread_stops_when_consumer_fails(train_file, tmp_path):
    """A failure in the training loop stops the producer: it does not go
    on tokenizing the epoch (JAX package semantics)."""
    import threading

    t = run_trainer(train_file, tmp_path, num_train_epochs=1,
                    prefetch_batches=1, batch_size=2)
    made = []
    orig = t._make_device_batch

    def counting(samples, epoch, iteration, source=0):
        made.append(iteration)
        return orig(samples, epoch, iteration, source)

    t._make_device_batch = counting
    orig_init = t._init_state

    def init(n):
        orig_init(n)

        def failing(state, batch, rng):
            raise RuntimeError("step failed")

        t._step_fn = failing

    t._init_state = init
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="step failed"):
        t.run_train()
    assert threading.active_count() == before
    assert len(made) <= 3  # 12 batches in the epoch


def _cli_conf(tmp_path, train_file):
    """A copy of conf/ whose vdr biencoder is tiny, and a checkpoint made
    from it (the tokenizer comes from its vocab.txt)."""
    conf = tmp_path / "conf"
    shutil.copytree(os.path.join(os.path.dirname(__file__), "..", "conf"),
                    conf)
    ckpt = tmp_path / "ckpt"
    enc = tiny_enc()
    Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                              shared_encoder=False), tokenizer=port_tok(),
              device="cpu").save_pretrained(str(ckpt))
    (conf / "data_stores" / "tiny.yaml").write_text(
        f"tiny_train:\n  file: {train_file}\n")
    return conf, ckpt


def test_cli_train_cpu_end_to_end(train_file, tmp_path):
    from vsearch_tpu_torch.cli import train as cli

    conf, ckpt = _cli_conf(tmp_path, train_file)
    out = tmp_path / "out"
    trainer = cli.main([
        "--config", str(conf / "train_ir_cfg.yaml"), "--device", "cpu",
        "data_stores=tiny", "train_datasets=[tiny_train]",
        f"model_path={ckpt}", f"output_dir={out}", "train.batch_size=8",
        "train.num_train_epochs=2", "train.num_epoch_to_save=1",
        "train.save_steps=2", "train.learning_rate=1e-3"])
    assert trainer.state.step == 6
    assert sorted(os.listdir(out)) == ["checkpoint_0", "checkpoint_1",
                                       "checkpoint_2", "train_state"]
    with open(out / "train_state" / "train_meta.json") as f:
        assert json.load(f) == {"epoch": 2, "offset": 0, "step": 6}
    loaded = Retriever.from_pretrained(str(out / "checkpoint_2"),
                                       device="cpu")
    np.testing.assert_array_equal(
        loaded.encoder_q.embed(["what is tea"]),
        trainer.retriever.encoder_q.embed(["what is tea"]))
    # resume from the end state replays nothing
    again = cli.main([
        "--config", str(conf / "train_ir_cfg.yaml"), "device=cpu",
        "data_stores=tiny", "train_datasets=[tiny_train]",
        f"model_path={ckpt}", f"output_dir={out}", "train.batch_size=8",
        "train.num_train_epochs=2", "resume=true"])
    assert again.start_epoch == 2 and again.state.step == 6


def test_cli_train_as_one_torchrun_rank_equals_one_process(train_file,
                                                           tmp_path,
                                                           monkeypatch):
    """Under torchrun's environment with one rank (gloo on the CPU) the CLI
    forms the group, takes shard 0 of 1, writes its checkpoints as rank 0
    and ends the group; its weights equal a run without the group's."""
    import socket

    import torch.distributed as dist

    from vsearch_tpu_torch.cli import train as cli

    conf, ckpt = _cli_conf(tmp_path, train_file)

    def train(out, env):
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        return cli.main([
            "--config", str(conf / "train_ir_cfg.yaml"), "--device", "cpu",
            "data_stores=tiny", "train_datasets=[tiny_train]",
            f"model_path={ckpt}", f"output_dir={tmp_path / out}",
            "train.batch_size=8", "train.num_train_epochs=1",
            "train.learning_rate=1e-3", "mesh.dp=1"])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    one = train("one", {})
    ranked = train("ranked", {"WORLD_SIZE": "1", "RANK": "0",
                              "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                              "MASTER_PORT": str(port)})
    assert not dist.is_initialized()  # the CLI ended its group
    assert ranked.state.step == one.state.step == 3
    assert sorted(os.listdir(tmp_path / "ranked")) == [
        "checkpoint_0", "checkpoint_1", "train_state"]
    a, b = one.module.state_dict(), ranked.module.state_dict()
    for name in a:
        torch.testing.assert_close(b[name], a[name], rtol=0, atol=0)


@pytest.mark.parametrize("override,env", [("mesh.dp=2", None),
                                          (None, "2")])
def test_cli_refuses_more_than_one_device(train_file, tmp_path, override,
                                          env, monkeypatch):
    """What the CLI still refuses before it writes anything: a mesh.dp
    other than the launch's world size, and a world of 2 without a
    coordinator to form its group."""
    from vsearch_tpu_torch.cli import train as cli

    conf, ckpt = _cli_conf(tmp_path, train_file)
    for var in ("WORLD_SIZE", "MASTER_ADDR", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv("WORLD_SIZE", env)
    argv = ["--config", str(conf / "train_ir_cfg.yaml"), "--device", "cpu",
            "data_stores=tiny", "train_datasets=[tiny_train]",
            f"model_path={ckpt}", f"output_dir={tmp_path / 'out'}"]
    match = {"mesh.dp=2": r"mesh.dp=2 != WORLD_SIZE=1",
             None: r"WORLD_SIZE=2 without MASTER_ADDR"}[override]
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ([override] if override else []))
    assert not os.path.exists(tmp_path / "out")


def test_train_step_refuses_a_mesh():
    """A mesh whose dp is not the process group's world size is refused; a
    tp axis (the VDR head's vocabulary split, ``test_torch_tp.py``) builds
    a step."""
    from vsearch_tpu_torch.parallel.mesh import make_mesh

    cfg = _step_cfgs("vdr", True)[1]
    assert callable(t_step.make_train_step(None, None, cfg, mesh=make_mesh(
        dp=1, tp=2, devices=["cpu"] * 2)))
    with pytest.raises(ValueError, match="world size 1"):
        t_step.make_train_step(None, None, cfg, mesh=make_mesh(
            devices=["cpu"] * 2))
    t_step.make_train_step(None, None, cfg, mesh=make_mesh(devices=["cpu"]))


@pytest.mark.parametrize("tp", [2, 3])
def test_cli_train_on_the_tp_axis(train_file, tmp_path, tp, monkeypatch):
    """``mesh.tp`` with ``--device cpu`` splits the VDR head's vocabulary
    over the CPU tp times and trains end to end; its losses and global
    norms equal ``mesh.tp=1``'s at the JAX tp test's tolerances (loss rtol
    1e-5, norm rtol 1e-4). A shift of 6 makes V' = 143, so both widths
    slice unevenly (72 + 71, 48 + 48 + 47)."""
    from vsearch_tpu_torch.cli import train as cli
    from vsearch_tpu_torch.train import trainer as tr

    conf, _ = _cli_conf(tmp_path, train_file)
    ckpt = tmp_path / "ckpt_odd"
    enc = tiny_enc(shift_vocab_num=6)
    Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc),
              tokenizer=port_tok(), device="cpu").save_pretrained(str(ckpt))
    orig = tr.RetrieverTrainer._init_state
    runs, widths, split_fn = {}, {}, t_vdr._vocab_split

    def record(pool, h, proj, valid, devices):
        # the step's forwards (q and p a step) go through the split
        if torch.is_grad_enabled():
            width = len(devices) if devices else 1
            widths[width] = widths.get(width, 0) + 1
        return split_fn(pool, h, proj, valid, devices)

    monkeypatch.setattr(t_vdr, "_vocab_split", record)

    def train(width):
        got = runs[width] = []

        def init(self, updates_per_epoch):
            orig(self, updates_per_epoch)
            step = self._step_fn

            def recorded(state, batch, seed):
                state, metrics = step(state, batch, seed)
                got.append((float(metrics["loss"]),
                            float(metrics["grad_norm"])))
                return state, metrics

            self._step_fn = recorded

        monkeypatch.setattr(tr.RetrieverTrainer, "_init_state", init)
        return cli.main([
            "--config", str(conf / "train_ir_cfg.yaml"), "--device", "cpu",
            "data_stores=tiny", "train_datasets=[tiny_train]",
            f"model_path={ckpt}", f"output_dir={tmp_path / str(width)}",
            "train.batch_size=8", "train.num_train_epochs=1",
            "train.learning_rate=1e-3", f"mesh.tp={width}"])

    split = train(tp)
    one = train(1)
    assert split.mesh.shape == {"dp": 1, "tp": tp} and one.mesh is None
    assert split.mesh.devices("tp") == [torch.device("cpu")] * tp
    assert widths == {tp: 2 * split.state.step, 1: 2 * one.state.step}
    for m in (split.retriever.encoder_q.module,
              split.retriever.encoder_p.module):
        assert m.tp_devices is None  # split in the step's forwards alone
    assert split.state.step == one.state.step == 3
    assert sorted(os.listdir(tmp_path / str(tp))) == [
        "checkpoint_0", "checkpoint_1", "train_state"]
    a, b = np.array(runs[tp]), np.array(runs[1])
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-5)
    np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=1e-4)


def test_embed_sees_live_weights_after_training(train_file, tmp_path):
    """The trained module is the encoder's own: embed after training
    equals a forward of the live f32 weights, and differs from before."""
    t = run_trainer(train_file, tmp_path, num_train_epochs=1)
    enc = t.retriever.encoder_q
    before = enc.embed(["what is tea"])
    t.run_train()
    after = enc.embed(["what is tea"])
    assert not np.array_equal(before, after)
    assert next(enc.module.parameters()).dtype == torch.float32
    assert not enc.module.training
