"""One rank of the port's distributed tests (``test_torch_distributed_trainer``).

Started by ``antmmf_torch.utils.launch`` as ``python torch_ranks_worker.py
<spec> <out_dir>``, it joins the gloo process group on the CPU and runs the
spec's scenarios in order; with the spec's ``pairs``, the world's ranks
then leave its group and join worlds of 2 (ranks 2p and 2p + 1 form pair
p, on the spec's ``pair_ports[p]``) and each pair runs its own scenarios.
Each rank writes what it saw to ``<out_dir>/rank<r>.pt`` (its world rank;
a pair's results under ``pair``):

* ``steps``: a ``BaseTrainer`` loaded from a config (its mesh, shards,
  seeds and state), then its train step on this rank's rows of the given
  global batches; the scalars as the trainer reads them (averaged over
  ranks), the mined columns of every rank's rows, and after the steps the
  whole masters, moments, MoCo EMA and queues, and this rank's state bytes;
* ``trainer``: ``antmmf_torch.run.main`` on a config (training, snapshots,
  validation), then the full validation's metrics once more;
* ``dropout``: this rank's Dropout mask from the trainer's generator;
* ``shards``: ``Shards`` over the world splitting two of three seeded
  tensors, gathered into bf16 and fp32 tensors in buckets of 16 bytes
  (``gather_into``) and onto rank 0's host (``gather_to_host``).

It imports neither JAX nor the JAX package.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from antmmf_torch import run  # noqa: E402
from antmmf_torch.common.build import build_config  # noqa: E402
from antmmf_torch.modules.layers import Dropout, draws  # noqa: E402
from antmmf_torch.modules.moco import queue_buffers  # noqa: E402
from antmmf_torch.parallel import collectives as coll  # noqa: E402
from antmmf_torch.parallel.mesh import set_active_mesh  # noqa: E402
from antmmf_torch.trainers.build import build_trainer  # noqa: E402


def local_rows(batch, rank, world):
    rows = {k: np.asarray(v) for k, v in batch.items()}
    n = next(iter(rows.values())).shape[0] // world
    return {k: torch.from_numpy(v[rank * n:(rank + 1) * n].copy()) for k, v in rows.items()}


def steps(spec):
    rank, world = coll.get_rank(), coll.get_world_size()
    trainer = build_trainer(build_config(spec["config"], opts=spec["opts"]))
    trainer.load()
    state, shell = trainer.state, trainer.shell
    out = {"scalars": [], "cols": []}
    for batch in spec["batches"]:
        local = local_rows(batch, rank, world)
        if shell.module.base.with_cross_encoder:
            with torch.no_grad():
                _, (o, _) = shell.loss_fn(local, deterministic=False, generator=state.generator)
            out["cols"].append(coll.all_gather(o["l2_pair_cols"]).numpy())
            shell.module._pending_keys = None
        state, scalars = trainer._train_step(state, local)
        out["scalars"].append(trainer._host(scalars))
    out["masters"] = state.gathered(state.params)
    out["mu"] = state.gathered(state.opt_state["mu"])
    out["nu"] = state.gathered(state.opt_state["nu"])
    if state.momentum is not None:
        out["momentum"] = state.gathered(state.momentum)
    out["queues"] = {p: t.clone() for p, t in queue_buffers(state.model).items()}
    out["optimizer_state_bytes"] = state.optimizer_state_bytes()
    out["master_bytes"] = state.master_bytes()
    out["sharded"] = sorted(state.shards.dims) if state.shards is not None else []
    return out


def trainer_run(spec):
    trainer = run.main(["--config", spec["config"], *spec["opts"]])
    return {"val": trainer.evaluate_set("val"), "step": trainer.state.step}


def dropout(spec):
    trainer = build_trainer(build_config(spec["config"], opts=spec["opts"]))
    trainer.load()
    with draws(trainer.state.generator):
        return {"mask": Dropout(0.5)(torch.ones(64)).ne(0).numpy()}


def shards(spec):
    from antmmf_torch.trainers import train_state

    rank, world = coll.get_rank(), coll.get_world_size()
    g = torch.Generator().manual_seed(0)
    whole = {"w": torch.randn(6, 4, generator=g), "v": torch.randn(3, 8, generator=g),
             "b": torch.randn(5, generator=g)}
    sh = train_state.Shards({"w": 0, "v": 1}, None, world, rank)
    local = {n: sh.local(n, t).clone() for n, t in whole.items()}
    train_state.BUCKET_BYTES = 16
    into = {"w": torch.zeros(6, 4, dtype=torch.bfloat16), "v": torch.zeros(3, 8),
            "b": torch.zeros(5, dtype=torch.bfloat16)}
    sh.gather_into(into, local)
    return {"whole": whole, "into": into, "host": sh.gather_to_host(local, 0)}


def run_scenarios(scenarios):
    return {name: {"steps": steps, "trainer": trainer_run, "dropout": dropout,
                   "shards": shards}[kind](s) for name, kind, s in scenarios}


def join_pair(ports):
    """Leave the world's group and join a world of 2: ranks 2p and 2p + 1
    of the world become ranks 0 and 1 of pair p, on ``ports[p]``."""
    rank = coll.get_rank()
    coll.synchronize()
    torch.distributed.destroy_process_group()
    coll._STATE.update(backend=None, host_group=None, batch_group=None, batch_index=0)
    set_active_mesh(None)
    os.environ.update(WORLD_SIZE="2", RANK=str(rank % 2), LOCAL_RANK=str(rank % 2),
                      LOCAL_WORLD_SIZE="2", MASTER_PORT=str(ports[rank // 2]))
    assert coll.init_distributed("cpu") == "gloo"
    return rank // 2


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    assert coll.init_distributed("cpu") == "gloo"
    spec = torch.load(spec_path, weights_only=False)
    rank = coll.get_rank()
    results = run_scenarios(spec["scenarios"])
    results["world"] = coll.get_world_size()
    if spec.get("pairs"):
        pair = join_pair(spec["pair_ports"])
        results["pair"] = run_scenarios(spec["pairs"][pair])
        results["pair_world"] = coll.get_world_size()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    coll.synchronize()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
