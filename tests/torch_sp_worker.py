"""One rank of the port's sequence-parallel tests (``test_torch_long_context``,
``test_torch_sequence_parallel``).

Started by ``antmmf_torch.utils.launch`` as ``python torch_sp_worker.py
<spec> <out_dir>``, it joins the gloo process group on the CPU and runs the
spec's scenarios in order, each rank writing what it saw to
``<out_dir>/rank<r>.pt``. Gradients come back as the train step reduces
them: the mean over every rank.

* ``collectives``: the ``seq`` collectives on a [world, 4] tensor a rank
  holds one row of, ⟨out, weights⟩'s gradient through each: ``ppermute``
  (shift 1), ``all_to_all``, ``all_gather_seq``, ``all_reduce_sum``;
* ``attention``: cases of whole q, k, v [B, H, L, D], a key mask and an
  output cotangent; each rank pads L to the axis, takes its slice, runs
  ``ring_attention`` (``blocks`` plain or flash) or ``ulysses_attention``
  over ``{seq: world}`` and gathers the output; the output and the q/k/v
  gradients;
* ``model``: Pink or M2-omni from flax params on a global batch under a
  mesh (``{seq: 2}``: every rank the whole batch; ``{data: 2}``: its rows),
  the loss, ``lm_acc`` and every parameter's gradient as flax paths;
* ``steps``: a ``BaseTrainer`` loaded from a config, then its train step on
  the given global batches (each rank its batch slice), the scalars and the
  masters;
* ``run``: ``antmmf_torch.run.main`` on a config, the logged train scalars.

It imports neither JAX nor the JAX package.
"""

import copy
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from antmmf_torch import run  # noqa: E402
from antmmf_torch.common.build import build_config  # noqa: E402
from antmmf_torch.models.m2_omni import M2Omni  # noqa: E402
from antmmf_torch.models.pink import PinkModel  # noqa: E402
from antmmf_torch.parallel import collectives as coll  # noqa: E402
from antmmf_torch.parallel.long_context import (gather_seq, pad_seq_to_axis,  # noqa: E402
                                                ring_attention, shard_seq, ulysses_attention)
from antmmf_torch.parallel.mesh import build_mesh, set_active_mesh  # noqa: E402
from antmmf_torch.trainers.build import build_trainer  # noqa: E402
from antmmf_torch.utils.weights import (export_flax_params, flatten_flax,  # noqa: E402
                                        load_flax_params)


def mean_grad(t):
    return coll.all_reduce_(t.detach().clone()) / coll.get_world_size()


def collectives(spec):
    mesh = build_mesh({"seq": coll.get_world_size()})
    group = mesh.seq_group()
    rank, world = coll.axis_index(group), coll.axis_size(group)
    whole = torch.as_tensor(spec["x"])
    weights = torch.as_tensor(spec["w"])
    out = {}
    for name, fn in (("ppermute", lambda x: coll.ppermute(x, group, 1)),
                     ("all_to_all", lambda x: coll.all_to_all(x, group, 1, 0)),
                     ("all_gather_seq", lambda x: coll.all_gather_seq(x, group, 0)),
                     ("all_reduce_sum", lambda x: coll.all_reduce_sum(x, group))):
        x = whole[rank:rank + 1].clone().requires_grad_()
        y = fn(x)
        w = weights[:y.shape[0], :y.shape[1]] + rank
        (y * w).sum().backward()
        out[name] = {"y": y.detach().numpy(), "grad": x.grad.numpy()}
    out["axis"] = (rank, world)
    return out


def attention(spec):
    world = coll.get_world_size()
    mesh = build_mesh({"seq": world})
    set_active_mesh(mesh)
    group = mesh.seq_group()
    out = []
    for case in spec["cases"]:
        q, k, v = (torch.tensor(case[n], requires_grad=True) for n in "qkv")
        bias = torch.tensor(np.where(case["mask"] > 0, 0.0, -1e30), dtype=torch.float32)
        qp, kp, vp, kb, L = pad_seq_to_axis(q, k, v, bias, world)
        parts = [shard_seq(t, group, 2) for t in (qp, kp, vp)]
        if case["mode"] == "ulysses":
            o = ulysses_attention(*parts, group, bias=shard_seq(kb, group, 1),
                                  causal=case["causal"])
        else:
            o = ring_attention(*parts, group, bias=shard_seq(kb, group, 1),
                               causal=case["causal"], blocks=case["blocks"])
        full = gather_seq(o, group, 2)[:, :, :L]
        (full * torch.tensor(case["dout"])).sum().backward()
        out.append({"out": full.detach().numpy(),
                    **{f"d{n}": mean_grad(t.grad).numpy() for n, t in zip("qkv", (q, k, v))}})
    set_active_mesh(None)
    return out


def model(spec):
    mesh = build_mesh(spec["mesh"])
    set_active_mesh(mesh)
    cls = PinkModel if spec["kind"] == "pink" else M2Omni
    m = cls(**spec["kw"], device="cpu")
    flat = flatten_flax(export_flax_params(m))
    flat.update(spec["params"])
    load_flax_params(m, flat)
    rows = mesh.size // mesh.shape["seq"]
    index = mesh.batch_index(coll.get_rank())

    def local(v):
        v = np.asarray(v)
        n = v.shape[0] // rows
        return torch.as_tensor(v[index * n:(index + 1) * n].copy())

    batch = {k: [local(x) for x in v] if isinstance(v, list) else local(v)
             for k, v in spec["batch"].items()}
    out = m(batch, deterministic=False)
    out["losses"]["lm_loss"].backward()
    twin = copy.deepcopy(m)
    with torch.no_grad():
        for p, t in zip(m.parameters(), twin.parameters()):
            t.copy_(mean_grad(p.grad) if p.grad is not None else torch.zeros_like(p))
    set_active_mesh(None)
    return {"loss": float(out["losses"]["lm_loss"]),
            "acc": float(out.get("metrics", {}).get("lm_acc", float("nan"))),
            "grads": flatten_flax(export_flax_params(twin)),
            "hidden_len": int(out.get("hidden", out.get("logits")).shape[1])}


def steps(spec):
    trainer = build_trainer(build_config(spec["config"], opts=spec["opts"]))
    trainer.load()
    mesh, state = trainer.mesh, trainer.state
    rows = mesh.size // mesh.shape["seq"]
    index = mesh.batch_index(coll.get_rank())
    out = {"scalars": []}
    for batch in spec["batches"]:
        n = next(iter(batch.values())).shape[0] // rows
        local = {k: torch.from_numpy(np.asarray(v)[index * n:(index + 1) * n].copy())
                 for k, v in batch.items()}
        state, scalars = trainer._train_step(state, local)
        out["scalars"].append(trainer._host(scalars))
    out["masters"] = {n: t.clone() for n, t in state.gathered(state.params).items()}
    return out


def trainer_run(spec):
    trainer = run.main(["--config", spec["config"], *spec["opts"]])
    meters = trainer.meter.meters
    return {k: list(meters[k].deque) for k in spec["keys"]}


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    assert coll.init_distributed("cpu") == "gloo"
    spec = torch.load(spec_path, weights_only=False)
    results = {name: {"collectives": collectives, "attention": attention, "model": model,
                      "steps": steps, "run": trainer_run}[kind](s)
               for name, kind, s in spec["scenarios"]}
    torch.save(results, os.path.join(out_dir, f"rank{coll.get_rank()}.pt"))
    coll.synchronize()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
