"""Data-parallel training and cross-process search over ``torch.distributed``
with two gloo processes on the CPU (``tests/torch_dist_worker.py``),
against the JAX package's one-program step on the global batch.

Two ranks each train one step on 4 queries, their positives and their
hard negatives (dropout 0). The gather puts every rank's positives first,
so each rank's loss is the JAX loss over the global batch of 8; the
gradient that reaches each rank's weights is summed over the two ranks'
losses by the gather's backward pass and averaged over the ranks, which
must leave exactly the global-batch gradient. Tolerances: the loss at
rtol 1e-5; the global norm and the gradients at rtol 1e-4 and atol 1e-5
of the largest gradient (summation order, as
``test_torch_train.py::test_step_gradients_match_jax``); the weights after
one AdamW update at rtol 1e-5, and within 2 lr where a gradient lies
inside that atol of zero (Adam's first update is lr x sign(g)).

The same two ranks then train the step again on a dp=2 x tp=2 mesh (the
VDR head's vocabulary split over two virtual CPU shards a rank), held to
the JAX package's step at dp=2/tp=2 on the global batch with the JAX tp
test's tolerances and schedule (its first lr is 0): loss rtol 1e-5, global
norm rtol 1e-4, weights rtol 5e-5 / atol 1e-6, and the gradients the JAX
step fed its optimizer as above.

The same run checks the all-gather's gradient contract (the reference's
``GatherLayer``: each rank's own slice), ``all_gather_objects`` and a
``make_sharded_bitpack_search`` whose two shards live in two processes.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.helpers import make_tokenizer
from vsearch_tpu.models import vdr as j_vdr
from vsearch_tpu.ops import sparse as j_sparse
from vsearch_tpu.ops.bitpack import pack_dense as j_pack_dense
from vsearch_tpu.parallel import sharded_search as jss
from vsearch_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsearch_tpu.parallel.mesh import shard_batch as j_shard_batch
from vsearch_tpu.train import loss as j_loss
from vsearch_tpu.train import optim as j_optim
from vsearch_tpu.train import step as j_step
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.ops.bitpack import pack_ell
from vsearch_tpu_torch.ops.ell import ELLMatrix
from vsearch_tpu_torch.parallel import sharded_search as tss
from vsearch_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LOCAL, LR, MAX_NORM, K = 4, 1e-3, 2.0, 10
TP_SCHEDULE, TP_DECAY = (2, 50, 1e-3), 0.01  # test_tp_equivalence.py's
TOK = make_tokenizer()
ENC = {"type": "vdr", "max_len": 32, "vocab_size": TOK.vocab_size,
       "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
       "intermediate_size": 64, "max_position_embeddings": 64,
       "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
       "topk": 16, "shift_vocab_num": 5}


def _global_batch(seed=7, n=2 * N_LOCAL, lq=16, lp=32):
    """[n] queries and [n positives + n hard negatives] passages."""
    r = np.random.default_rng(seed)
    v = TOK.vocab_size
    q = r.integers(5, v, size=(n, lq))
    p = r.integers(5, v, size=(2 * n, lp))
    p[:n, :lq // 2] = q[:, :lq // 2]
    for rows in (q, p):
        for i in range(len(rows)):
            rows[i, rows.shape[1] - int(r.integers(0, rows.shape[1] // 2)):] = 0
    return q.astype(np.int32), p.astype(np.int32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs written, the two ranks run (60 s limit), their outputs and
    the JAX references."""
    work = tmp_path_factory.mktemp("dist")
    cfg = j_vdr.VDREncoderConfig.from_dict(ENC)
    module = j_vdr.VDRModule(cfg)
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(0), dummy, dummy,
                         dummy + 1)["params"]
    torch.save(convert.vdr_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), 2), work / "init.pt")
    q, p = _global_batch()
    rng = np.random.default_rng(3)
    bits = (rng.random((4096, 300)) < 0.05).astype(np.float32)
    np.savez(work / "inputs.npz", q=q, p=p,
             gather_x=rng.normal(size=(2 * N_LOCAL, 4)).astype(np.float32),
             gather_w=rng.normal(size=(2 * N_LOCAL, 4)).astype(np.float32),
             gather_theta=rng.normal(size=(4, 4)).astype(np.float32),
             bits=bits,
             bit_q=np.abs(rng.normal(size=(3, 300))).astype(np.float32))
    (work / "config.json").write_text(json.dumps(
        {"enc": ENC, "lr": LR, "max_grad_norm": MAX_NORM,
         "n_local": N_LOCAL, "k": K, "tp_schedule": TP_SCHEDULE,
         "tp_decay": TP_DECAY}))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         str(r), port, str(work)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        logs = [pr.communicate(timeout=60) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for pr, (_, err) in zip(procs, logs):
        assert pr.returncode == 0, err[-3000:]
    outs = [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(2)]

    # the JAX package's step on the global batch: loss, gradients, AdamW
    step_cfg = j_step.TrainStepConfig(
        encoder_type="vdr", vocab_size=ENC["vocab_size"],
        shift_vocab_num=ENC["shift_vocab_num"],
        loss=j_loss.VDRLossConfig(topk=ENC["topk"]))
    apply = j_step.make_encoder_apply(module, deterministic=True)

    def loss_fn(prm):
        q_emb = apply(prm, jnp.asarray(q), None)
        p_emb = apply(prm, jnp.asarray(p), None)
        bows = [j_sparse.build_bow_mask(jnp.asarray(x),
                                        vocab_size=step_cfg.vocab_size,
                                        shift_num=step_cfg.shift_vocab_num)
                for x in (q, p)]
        return j_loss.compute_vdr_loss(q_emb, p_emb, *bows,
                                       step_cfg.loss)[0]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = j_optim.get_optimizer(params, learning_rate=LR,
                               max_grad_norm=MAX_NORM)
    upd, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, upd)
    norm = float(optax.global_norm(grads))
    clip = min(1.0, MAX_NORM / norm)
    # the JAX step at dp=2/tp=2 on the global batch
    tx_tp = j_optim.get_optimizer(
        params, learning_rate=LR, max_grad_norm=MAX_NORM,
        weight_decay=TP_DECAY,
        schedule=j_optim.get_schedule_linear(*TP_SCHEDULE))
    jm = j_make_mesh(dp=2, tp=2)
    tp_step = j_step.make_train_step(apply, apply, step_cfg, mesh=jm,
                                     shared_params=True)
    with jm:
        tp_state, tp_m = tp_step(
            j_step.TrainState.create(params, tx_tp),
            j_shard_batch(jm, j_step.TrainBatch(q_ids=jnp.asarray(q),
                                                p_ids=jnp.asarray(p))),
            jax.random.PRNGKey(1))
    # Adam's first moment after one step is 0.1 of the (clipped) gradient
    adam = [s for s in jax.tree_util.tree_leaves(
        tp_state.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    ref_tp = {"loss": float(tp_m["loss"]),
              "norm": float(tp_m["grad_norm"]),
              "grads": convert.vdr_state_dict_from_flax(
                  jax.tree_util.tree_map(lambda g: np.asarray(g) / 0.1,
                                         adam[0].mu), 2),
              "params": convert.vdr_state_dict_from_flax(
                  jax.tree_util.tree_map(np.asarray, tp_state.params), 2)}
    ref = {"tp": ref_tp, "loss": float(loss), "norm": norm,
           "grads": convert.vdr_state_dict_from_flax(
               jax.tree_util.tree_map(lambda g: np.asarray(g) * clip,
                                      grads), 2),
           "params": convert.vdr_state_dict_from_flax(
               jax.tree_util.tree_map(np.asarray, new), 2)}
    return outs, ref, np.load(work / "inputs.npz")


def test_step_loss_equals_jax_global_batch(run):
    outs, ref, _ = run
    for o in outs:
        assert o["batch_size"] == 2 * N_LOCAL
        np.testing.assert_allclose(o["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(o["grad_norm"], ref["norm"], rtol=1e-4)


def test_step_gradients_and_update_equal_jax(run):
    """The averaged gradient is the global-batch gradient (neither 1/W nor
    W times it), equal on both ranks, and so are the updated weights."""
    outs, ref, _ = run
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        for o in outs:
            np.testing.assert_allclose(o["grads"][name], g.numpy(),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)
        np.testing.assert_array_equal(outs[0]["params"][name],
                                      outs[1]["params"][name])
        want = ref["params"][name].numpy()
        got = outs[0]["params"][name].numpy()
        signed = np.abs(g.numpy()) > 1e-5 * scale
        np.testing.assert_allclose(got[signed], want[signed], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-5), name


def test_dp_tp_step_equals_jax_dp_tp(run):
    """dp=2 x tp=2 (two gloo ranks, the vocabulary split over two virtual
    CPU shards in each) against the JAX step at dp=2/tp=2."""
    outs, ref, _ = run
    want = ref["tp"]
    scale = max(float(g.abs().max()) for g in want["grads"].values())
    for o in outs:
        got = o["tp"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["norm"],
                                   rtol=1e-4)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g.numpy(),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)
            np.testing.assert_allclose(got["params"][name],
                                       want["params"][name].numpy(),
                                       rtol=5e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(outs[0]["tp"]["loss"], outs[0]["loss"],
                               rtol=1e-6)


def test_differentiable_all_gather_grad(run):
    """A global loss sum(Y * w) over every rank's rows y_r = x_r @ theta:
    the gradient reaching each rank's rows is its own slice of w times
    theta's transpose, summed over the two ranks' (equal) losses, so twice
    it (the reference GatherLayer's contract, before DDP's average); the
    gradient of the replicated theta, averaged over the ranks, is the
    global one, X^T W."""
    outs, _, inp = run
    x, w, theta = inp["gather_x"], inp["gather_w"], inp["gather_theta"]
    for r, o in enumerate(outs):
        own = w[r * N_LOCAL:(r + 1) * N_LOCAL]
        np.testing.assert_allclose(o["gather_grad_x"], 2 * own @ theta.T,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["gather_grad_theta"], x.T @ w,
                                   rtol=1e-5, atol=1e-6)


def test_all_gather_objects_two_ranks(run):
    outs, _, _ = run
    for o in outs:
        assert o["objects"] == [{"rank": 0}, {"rank": 1}]
        # the larger object (rank 1's) fails the check on BOTH ranks
        assert o["size_error"] is not None
        assert "exceeds max_bytes 64" in o["size_error"]


@pytest.mark.parametrize("selection", ["bucketed", "exact"])
def test_cross_process_sharded_bitpack_search(run, selection):
    """Two shards in two processes, gathered by all_gather_into_tensor:
    the same top-k on both ranks as two virtual shards in one process,
    and as the JAX package's sharded search over 2 devices."""
    outs, _, inp = run
    bits, q = inp["bits"], inp["bit_q"]
    mesh = make_mesh(devices=["cpu"] * 2)
    shards = tss.shard_bitmat(mesh, pack_ell(ELLMatrix.from_dense(
        bits, binary=True, device="cpu")))
    ids, scores = tss.make_sharded_bitpack_search(
        mesh, K, shards, selection=selection)(torch.from_numpy(q), shards)
    jm = j_make_mesh(dp=2, tp=1)
    j_bm = jss.shard_bitmat(jm, j_pack_dense(bits))
    j_ids, j_s = jss.make_sharded_bitpack_search(
        jm, K, j_bm, selection=selection)(jnp.asarray(q), j_bm)
    for o in outs:
        got_ids, got_s = o[f"search_{selection}"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_s, scores)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_s), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("selection", ["bucketed", "exact"])
def test_tp_axis_search_stays_in_the_rank(run, selection):
    """Under the two-rank group a dp=2 x tp=2 mesh gives each rank a line
    of two devices; an index sharded over tp has both shards in every
    rank, so the search gathers nothing across ranks: each id comes once,
    the answer equals the one-device exact top-k (exact selection) and
    the two-process dp search over the same two shards (both)."""
    from vsearch_tpu_torch.ops.bitpack import bitpack_scores
    from vsearch_tpu_torch.ops.search import top_k

    outs, _, inp = run
    bm = pack_ell(ELLMatrix.from_dense(inp["bits"], binary=True,
                                       device="cpu"))
    q = torch.from_numpy(inp["bit_q"])
    want_s, want_ids = top_k(bitpack_scores(q, bm), K)
    for o in outs:
        got_ids, got_s = o[f"search_tp_{selection}"]
        assert got_ids.shape == (q.shape[0], K)
        assert all(len(set(row.tolist())) == K for row in got_ids)
        if selection == "exact":
            np.testing.assert_array_equal(got_ids, want_ids)
            np.testing.assert_array_equal(got_s, want_s)
        dp_ids, dp_s = o[f"search_{selection}"]
        np.testing.assert_array_equal(got_ids, dp_ids)
        np.testing.assert_array_equal(got_s, dp_s)
