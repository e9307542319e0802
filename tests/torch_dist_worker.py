"""One rank of the two-process gloo run of ``test_torch_distributed.py``.

    python tests/torch_dist_worker.py RANK PORT WORKDIR

Imports torch and the port only. Reads ``WORKDIR/inputs.npz`` (the global
batch, the bit rows, the gather operands), ``WORKDIR/init.pt`` (the
module's weights) and ``WORKDIR/config.json``, joins a 2-rank gloo group
on ``127.0.0.1:PORT`` and writes what it computed to
``WORKDIR/rank<RANK>.pt``:
- one train step on its half of the global batch (4 queries, their
  positives and their hard negatives): the loss, the global norm, the
  averaged (and clipped) gradients and the weights after one AdamW update;
- the same step on a dp=2 x tp=2 mesh (the VDR head's vocabulary split
  over 2 virtual CPU shards a rank), under the JAX tp test's schedule;
- the all-gather's gradient contract (a rank's rows, a replicated weight);
- ``all_gather_objects`` and its collective size check;
- a cross-process ``make_sharded_bitpack_search`` (one shard a rank),
  and the same search sharded over each rank's own tp line (both shards
  in the rank, nothing gathered across ranks).
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vsearch_tpu_torch.models import vdr as t_vdr  # noqa: E402
from vsearch_tpu_torch.ops.bitpack import pack_ell  # noqa: E402
from vsearch_tpu_torch.ops.ell import ELLMatrix  # noqa: E402
from vsearch_tpu_torch.parallel import collectives as coll  # noqa: E402
from vsearch_tpu_torch.parallel import sharded_search as tss  # noqa: E402
from vsearch_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vsearch_tpu_torch.train import loss as t_loss  # noqa: E402
from vsearch_tpu_torch.train import optim as t_optim  # noqa: E402
from vsearch_tpu_torch.train import step as t_step  # noqa: E402


def main(rank: int, port: str, work: str) -> None:
    torch.set_num_threads(1)
    assert coll.initialize_distributed(f"127.0.0.1:{port}", 2, rank,
                                       device="cpu")
    assert coll.get_world_size() == 2 and coll.get_rank() == rank
    inp = np.load(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "config.json")) as f:
        cfg = json.load(f)
    out = {}

    # -- one train step on this rank's half of the global batch ------------
    module = t_vdr.VDRModule(t_vdr.VDREncoderConfig.from_dict(cfg["enc"]))
    module.load_state_dict(torch.load(os.path.join(work, "init.pt")))
    apply = t_step.make_encoder_apply(module, deterministic=True)
    tx = t_optim.get_optimizer([module], learning_rate=cfg["lr"],
                               max_grad_norm=cfg["max_grad_norm"])
    state = t_step.TrainState.create(module, tx)
    step_cfg = t_step.TrainStepConfig(
        encoder_type="vdr", vocab_size=cfg["enc"]["vocab_size"],
        shift_vocab_num=cfg["enc"]["shift_vocab_num"],
        loss=t_loss.VDRLossConfig(topk=cfg["enc"]["topk"]))
    step = t_step.make_train_step(apply, apply, step_cfg,
                                  mesh=make_mesh(dp=2), shared_params=True)
    n = cfg["n_local"]
    q, p = inp["q"], inp["p"]  # global: [2n] queries, [2n pos + 2n neg]
    lo, hi = rank * n, (rank + 1) * n
    q_loc = q[lo:hi]
    p_loc = np.concatenate([p[lo:hi], p[2 * n + lo:2 * n + hi]])
    state, metrics = step(state, t_step.TrainBatch(
        torch.from_numpy(q_loc).long(), torch.from_numpy(p_loc).long()), 0)
    out["loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["batch_size"] = float(metrics["batch_size"])
    out["grads"] = {k: v.grad.clone() for k, v in module.named_parameters()}
    out["params"] = {k: v.detach().clone()
                     for k, v in module.named_parameters()}

    # -- the same step with the vocabulary split over this rank's tp line --
    module = t_vdr.VDRModule(t_vdr.VDREncoderConfig.from_dict(cfg["enc"]))
    module.load_state_dict(torch.load(os.path.join(work, "init.pt")))
    mesh = make_mesh(dp=2, tp=2)  # under gloo: the CPU twice a rank
    assert mesh.devices("tp") == [torch.device("cpu")] * 2
    apply = t_step.make_encoder_apply(module, deterministic=True, mesh=mesh)
    tx = t_optim.get_optimizer(
        [module], learning_rate=cfg["lr"], weight_decay=cfg["tp_decay"],
        max_grad_norm=cfg["max_grad_norm"],
        schedule=t_optim.get_schedule_linear(*cfg["tp_schedule"]))
    state = t_step.TrainState.create(module, tx)
    step = t_step.make_train_step(apply, apply, step_cfg, mesh=mesh,
                                  shared_params=True)
    state, metrics = step(state, t_step.TrainBatch(
        torch.from_numpy(q_loc).long(), torch.from_numpy(p_loc).long()), 0)
    out["tp"] = {"loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "grads": {k: v.grad.clone()
                           for k, v in module.named_parameters()},
                 "params": {k: v.detach().clone()
                            for k, v in module.named_parameters()}}

    # -- the GatherLayer contract ------------------------------------------
    # rows y = x @ theta of each rank (theta the same on both), gathered
    # into one global loss sum(Y * w): x's gradient is summed over the two
    # ranks' losses; theta's, averaged over the ranks, is the global one
    w = torch.from_numpy(inp["gather_w"])
    x = torch.from_numpy(inp["gather_x"][lo:hi]).requires_grad_()
    theta = torch.from_numpy(inp["gather_theta"]).requires_grad_()
    gathered = coll.differentiable_all_gather(x @ theta)  # [2, n, d]
    (gathered.flatten(0, 1) * w).sum().backward()
    out["gather_grad_x"] = x.grad.clone()
    coll.average_gradients([theta])
    out["gather_grad_theta"] = theta.grad.clone()

    # -- objects -----------------------------------------------------------
    out["objects"] = coll.all_gather_objects({"rank": rank})
    try:
        coll.all_gather_objects("x" * (100 + rank), max_bytes=64)
        out["size_error"] = None
    except ValueError as exc:
        out["size_error"] = str(exc)

    # -- a cross-process sharded bit-packed search ---------------------------
    bm = pack_ell(ELLMatrix.from_dense(inp["bits"], binary=True,
                                       device="cpu"))
    mesh = make_mesh()  # one device a rank
    assert mesh.multiprocess and mesh.shape["dp"] == 2
    shards = tss.shard_bitmat(mesh, bm)
    assert [p is not None for p in shards.parts] == [rank == 0, rank == 1]
    qb = torch.from_numpy(inp["bit_q"])
    for sel in ("bucketed", "exact"):
        ids, scores = tss.make_sharded_bitpack_search(
            mesh, cfg["k"], shards, selection=sel)(qb, shards)
        out[f"search_{sel}"] = (ids.clone(), scores.clone())

    # -- the same search sharded over this rank's own tp line ----------------
    mesh = make_mesh(dp=2, tp=2)  # the CPU twice a rank
    assert mesh.is_local("tp") == [True, True]
    assert not mesh.spans_processes("tp")
    shards = tss.shard_bitmat(mesh, bm, axis_name="tp")
    for sel in ("bucketed", "exact"):
        ids, scores = tss.make_sharded_bitpack_search(
            mesh, cfg["k"], shards, axis_name="tp", selection=sel)(qb, shards)
        out[f"search_tp_{sel}"] = (ids.clone(), scores.clone())
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
