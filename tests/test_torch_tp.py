"""Training on the mesh's ``tp`` axis: the VDR head's vocabulary split over
this process's tp devices (``models/vdr.py``, ``train/step.py``).

The setting is ``tests/test_tp_equivalence.py``'s: a tiny VDR (vocab 96,
shift 5, so V' = 91, topk 8), deterministic, one AdamW step at lr 1e-3
under a linear schedule (warmup 2 of 50) with weight decay 0.01, and the
batch drawn from ``default_rng(0)``. The port's step at tp = 1, 2 and 4
(virtual CPU shards in one process) is held to the JAX package's step on
its meshless program and on dp=4/tp=2 and dp=2/tp=4 (8 virtual CPU
devices) with that test's tolerances: loss rtol 1e-5, ``grad_norm`` rtol
1e-4, parameters rtol 5e-5 / atol 1e-6. The schedule's first lr is 0, so
the gradients that the JAX step fed its optimizer (Adam's first moment
after one step is 0.1 of them) are held too, as ``test_torch_train.py``
holds gradients: rtol 1e-4, atol 1e-5 of the largest. Separate q/p
modules, a DPR step, ``remat=True``, ``norm=True`` and mean pooling are
held the same way to the JAX step at dp=2/tp=4 (JAX's own test holds its
layouts to its meshless program; each JAX program compiles for seconds
here, so each variant is held to one).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vsearch_tpu.models import dpr as j_dpr
from vsearch_tpu.models import vdr as j_vdr
from vsearch_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsearch_tpu.parallel.mesh import shard_batch as j_shard_batch
from vsearch_tpu.train import loss as j_loss
from vsearch_tpu.train import optim as j_optim
from vsearch_tpu.train import step as j_step
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.models import dpr as t_dpr
from vsearch_tpu_torch.models import vdr as t_vdr
from vsearch_tpu_torch.parallel.mesh import make_mesh
from vsearch_tpu_torch.train import loss as t_loss
from vsearch_tpu_torch.train import optim as t_optim
from vsearch_tpu_torch.train import step as t_step

VOCAB, SHIFT, TOPK, LAYERS = 96, 5, 8, 2
ENC = {"vocab_size": VOCAB, "hidden_size": 32, "num_hidden_layers": LAYERS,
       "num_attention_heads": 2, "intermediate_size": 64,
       "max_position_embeddings": 64, "max_len": 16}
# name -> (encoder type, shared q/p, remat, VDR config overrides)
CASES = {"shared": ("vdr", True, False, {}),
         "separate": ("vdr", False, False, {}),
         "remat": ("vdr", True, True, {}),
         "norm": ("vdr", True, False, {"norm": True}),
         "mean": ("vdr", True, False, {"pooling": "mean"}),
         "dpr": ("dpr", True, False, {})}
# the JAX layouts (meshless, dp/tp) each case is held to
J_LAYOUTS = {case: ((2, 4),) for case in CASES}
J_LAYOUTS["shared"] = (None, (4, 2), (2, 4))
PARAM_TOL = dict(rtol=5e-5, atol=1e-6)


def enc_dict(kind, over):
    d = dict(ENC, type=kind)
    if kind == "vdr":
        d.update(shift_vocab_num=SHIFT, topk=TOPK, **over)
    return d


def batch():
    rng = np.random.default_rng(0)
    return (rng.integers(SHIFT, VOCAB, size=(16, 12)).astype(np.int32),
            rng.integers(SHIFT, VOCAB, size=(32, 12)).astype(np.int32))


def jax_params(kind, over, seed):
    cfg_cls, mod_cls = ((j_vdr.VDREncoderConfig, j_vdr.VDRModule)
                        if kind == "vdr"
                        else (j_dpr.DPREncoderConfig, j_dpr.DPRModule))
    module = mod_cls(cfg_cls.from_dict(enc_dict(kind, over)))
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(seed), dummy, dummy,
                         jnp.ones((1, 8), jnp.int32))["params"]
    return module, jax.tree_util.tree_map(np.asarray, params)


def to_port(kind, params):
    fn = (convert.vdr_state_dict_from_flax if kind == "vdr"
          else convert.dpr_state_dict_from_flax)
    return fn(params, LAYERS)


def step_cfgs(kind):
    common = dict(encoder_type=kind, vocab_size=VOCAB,
                  shift_vocab_num=SHIFT if kind == "vdr" else 0)
    return (j_step.TrainStepConfig(loss=j_loss.VDRLossConfig(topk=TOPK),
                                   **common),
            t_step.TrainStepConfig(loss=t_loss.VDRLossConfig(topk=TOPK),
                                   **common))


def flat_params(kind, shared, params):
    """Port-named numpy weights of a JAX parameter tree."""
    if shared:
        return {k: v.numpy() for k, v in to_port(kind, params).items()}
    return {f"{s}.{k}": v.numpy() for s in ("q", "p")
            for k, v in to_port(kind, params[s]).items()}


_JAX = {}


def jax_setup(case):
    kind, shared, _, over = CASES[case]
    module, pq = jax_params(kind, over, 0)
    return module, (pq if shared
                    else {"q": pq, "p": jax_params(kind, over, 1)[1]})


def jax_run(case, layout):
    """(loss, grad norm, clipped gradients, weights after it) of one JAX
    step, port-named."""
    key = (case, layout)
    if key in _JAX:
        return _JAX[key]
    kind, shared, remat, _ = CASES[case]
    module, params = jax_setup(case)
    apply = j_step.make_encoder_apply(module, deterministic=True,
                                      remat=remat)
    tx = j_optim.get_optimizer(params, learning_rate=1e-3,
                               schedule=j_optim.get_schedule_linear(
                                   2, 50, 1e-3), weight_decay=0.01)
    state = j_step.TrainState.create(params, tx)
    mesh = None if layout is None else j_make_mesh(*layout)
    step = j_step.make_train_step(apply, apply, step_cfgs(kind)[0],
                                  mesh=mesh, shared_params=shared)
    q, p = batch()
    b = j_step.TrainBatch(q_ids=jnp.asarray(q), p_ids=jnp.asarray(p))
    if mesh is not None:
        with mesh:
            state, m = step(state, j_shard_batch(mesh, b),
                            jax.random.PRNGKey(1))
    else:
        state, m = step(state, b, jax.random.PRNGKey(1))
    # Adam's first moment after one step: (1 - b1) = 0.1 of the gradient
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / 0.1,
                                   adam[0].mu)
    out = (float(m["loss"]), float(m["grad_norm"]),
           flat_params(kind, shared, grads),
           flat_params(kind, shared,
                       jax.tree_util.tree_map(np.asarray, state.params)))
    _JAX[key] = out
    return out


def port_module(kind, over, params):
    cfg_cls, mod_cls = ((t_vdr.VDREncoderConfig, t_vdr.VDRModule)
                        if kind == "vdr"
                        else (t_dpr.DPREncoderConfig, t_dpr.DPRModule))
    m = mod_cls(cfg_cls.from_dict(enc_dict(kind, over)))
    m.load_state_dict(to_port(kind, params))
    return m


def port_run(case, tp):
    """(loss, grad norm, clipped gradients, weights after it) of one port
    step over a mesh of ``tp`` virtual CPU shards."""
    kind, shared, remat, over = CASES[case]
    mq = port_module(kind, over, jax_params(kind, over, 0)[1])
    module = mq if shared else torch.nn.ModuleDict(
        {"q": mq, "p": port_module(kind, over, jax_params(kind, over, 1)[1])})
    mesh = make_mesh(dp=1, tp=tp, devices=["cpu"] * tp)
    applies = [t_step.make_encoder_apply(m, deterministic=True, remat=remat,
                                         mesh=mesh)
               for m in ((mq, mq) if shared else (module["q"], module["p"]))]
    tx = t_optim.get_optimizer([module], learning_rate=1e-3,
                               schedule=t_optim.get_schedule_linear(
                                   2, 50, 1e-3), weight_decay=0.01)
    state = t_step.TrainState.create(module, tx)
    step = t_step.make_train_step(*applies, step_cfgs(kind)[1], mesh=mesh,
                                  shared_params=shared)
    q, p = (torch.from_numpy(x).long() for x in batch())
    state, m = step(state, t_step.TrainBatch(q, p), 1)
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: v.grad.numpy() for k, v in module.named_parameters()},
            {k: v.detach().numpy() for k, v in module.state_dict().items()})


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_step_equals_jax_layouts(case, tp):
    loss, gnorm, grads, params = port_run(case, tp)
    assert np.isfinite(loss)
    for layout in J_LAYOUTS[case]:
        j_loss_, j_gnorm, j_grads, j_params = jax_run(case, layout)
        what = f"{case} tp={tp} vs JAX {layout or 'meshless'}"
        np.testing.assert_allclose(loss, j_loss_, rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(gnorm, j_gnorm, rtol=1e-4, err_msg=what)
        assert set(params) == set(j_params) == set(grads) == set(j_grads)
        for name, want in j_params.items():
            np.testing.assert_allclose(params[name], want, **PARAM_TOL,
                                       err_msg=f"{what}: {name}")
        scale = max(float(np.abs(g).max()) for g in j_grads.values())
        for name, g in j_grads.items():
            np.testing.assert_allclose(grads[name], g, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       err_msg=f"{what}: gradient of {name}")


def test_uneven_slices_equal_one_device():
    """tp = 3 over V' = 91 (slices of 31, 30, 30): the embeddings equal
    tp = 1's within rtol 1e-6 and have exactly V' columns, for the max and
    the mean pooling, with the reference's pad pooling and the norm."""
    _, params = jax_params("vdr", {}, 0)
    q, _ = batch()
    ids = torch.from_numpy(q).long()
    ids[:, 9:] = 0  # padding, so the valid mask matters
    args = (ids, torch.zeros_like(ids), (ids != 0).long())
    for over in ({}, {"pooling": "mean", "pooling_topk": 2},
                 {"compat_pad_pooling": True, "norm": True}):
        m = port_module("vdr", over, params).eval()
        want = m(*args)
        m.tp_devices = [torch.device("cpu")] * 3
        got = m(*args)
        assert got.shape == want.shape == (16, VOCAB - SHIFT)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-6,
                                   atol=0, err_msg=str(over))


def test_tp_line_must_start_at_the_module(monkeypatch):
    """The trunk runs on the first device of the tp line: a line that does
    not start at the module's device is refused. The split holds in each
    forward of the step's ``apply`` alone (the module is unsplit after
    it, so embed and mining run unsplit), and no mesh means no split."""
    seen, split = [], t_vdr._vocab_split
    monkeypatch.setattr(t_vdr, "_vocab_split", lambda pool, h, proj, valid,
                        devices: seen.append(devices) or split(
                            pool, h, proj, valid, devices))
    m = port_module("vdr", {}, jax_params("vdr", {}, 0)[1])
    ids = torch.from_numpy(batch()[0]).long()
    t_step.make_encoder_apply(m, mesh=make_mesh(dp=1, tp=2,
                                                devices=["cpu"] * 2))(m, ids)
    assert seen == [[torch.device("cpu")] * 2] and m.tp_devices is None
    t_step.make_encoder_apply(m)(m, ids)
    assert seen[1:] == [None] and m.tp_devices is None
    with pytest.raises(ValueError, match="must start at the module"):
        t_step.make_encoder_apply(m, mesh=make_mesh(
            dp=1, tp=2, devices=["meta", "cpu"]))


def test_default_tp_line_under_gloo(monkeypatch):
    """In a process group each rank holds a line of tp devices: under
    gloo the CPU tp times, and ``devices("tp")`` is this rank's row;
    under NCCL rank r's lead is card r*tp."""
    from vsearch_tpu_torch.parallel import collectives

    monkeypatch.setattr(collectives, "group_up", lambda: True)
    monkeypatch.setattr(collectives, "get_world_size", lambda: 2)
    monkeypatch.setattr(collectives, "get_rank", lambda: 1)
    monkeypatch.setattr(collectives.dist, "get_backend", lambda: "gloo")
    mesh = make_mesh(dp=2, tp=3)
    assert mesh.shape == {"dp": 2, "tp": 3} and mesh.multiprocess
    assert mesh.ranks == [[0, 0, 0], [1, 1, 1]]
    assert mesh.devices("tp") == [torch.device("cpu")] * 3
    assert mesh.is_local("tp") == [True] * 3
    assert mesh.is_local("dp") == [False, True]
    assert not mesh.spans_processes("tp") and mesh.spans_processes("dp")
    monkeypatch.setattr(collectives.dist, "get_backend", lambda: "nccl")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert collectives.local_device(2) == torch.device("cuda", 2)
    assert collectives.local_device() == torch.device("cuda", 1)
    # this machine has no card 2: the line is refused with the arithmetic
    with pytest.raises(ValueError, match=r"dp=2 x tp=2 needs 4 devices "
                       r"but only \d+ are available \(cuda:2 is not"):
        make_mesh(dp=2, tp=2)


def test_default_tp_line_alone():
    """Without a group the line starts at the device asked for: the CPU
    tp times, or tp cards from a card, which must be there."""
    mesh = make_mesh(dp=1, tp=3, device="cpu")
    assert mesh.devices("tp") == [torch.device("cpu")] * 3
    assert not mesh.multiprocess and not mesh.spans_processes("tp")
    with pytest.raises(ValueError, match=r"dp=1 x tp=2 needs 2 devices "
                       r"but only \d+ are available \(cuda:\d+ is not"):
        make_mesh(dp=1, tp=2, device=f"cuda:{torch.cuda.device_count()}")


def test_bare_cuda_device_takes_the_ranks_card(monkeypatch):
    """``initialize_distributed(device="cuda")`` (its default) makes this
    rank's card, ``cuda:LOCAL_RANK``, the current device before NCCL
    forms the group; a bare "cuda" has no index to set."""
    import vsearch_tpu_torch.device as device_mod
    from vsearch_tpu_torch.parallel import collectives

    calls = []
    monkeypatch.setattr(device_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(collectives.dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert collectives.initialize_distributed("127.0.0.1:1", 4, 3)
    assert calls == [torch.device("cuda", 3), "nccl"]
