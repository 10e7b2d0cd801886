"""The port's trainer over ranks against JAX's one-device step, on the CPU.

One spawn serves the module: 4 gloo ranks (``antmmf_torch.utils.launch``
running ``torch_ranks_worker.py``) with ``mesh {data: 2, fsdp: 2}``, which
then part into two worlds of 2 ranks for ``{data: 2}`` and ``{fsdp: 2}``;
every scenario runs inside them and comes back to this process. The reference is the JAX
trainer's own jitted ``train_step`` (``compile_steps``, one compile a
configuration) on the whole global batch, started from the port's seeded
init (``export_flax_variables``), as the JAX trainer computes it under SPMD
over the 8 CPU devices.

The configurations are the fixture's tiny retrieval presets at fp32 with
dropout 0, lr 1e-3 and AdamW's eps 1e-4 (a smaller eps scales the fp32
noise of gradients that are zero in exact arithmetic, such as the key
projections' biases and the L2 head's bias, up to the learning rate): ``video_retrieval.local.yml`` with the
cross-encoder and ``hard_mining_k`` 2 (the L1 contrastive loss over the
gathered embeddings, the mined columns among the global batch, the L2 loss
against the gathered visual sequences), and ``video_retrieval_moco.local.yml``
(momentum towers, the queues). The global batches (4 rows, 2 steps) are
drawn with numpy from a seed; the clip at norm 1.0 cuts every step.

Tolerances (fp32 sums in another order): the loss, its parts and the
clip's norm at rtol 1e-5; the masters after 2 AdamW steps at atol 2e-6
(lr 1e-3), the first moments at atol 1e-7 and the second at rtol 1e-4 +
atol 1e-12; the mined columns, the queues' ``ptr`` and ``filled``
exactly and their rows at atol 1e-6. The mined columns ride out of the
JAX step with its scalars. The global evaluator's recall over
2 and 4 ranks (the 4-rank validation pads every rank's last batch) equals
one process's exactly, a 2-rank snapshot resumes in one process, two
ranks draw different dropout masks, and the shards' bucketed gathers
write each whole tensor in its destination's dtype.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.utils.launch import free_port, launch
from antmmf_torch.utils.weights import (export_flax_variables, flatten_flax, flax_paths,
                                        flax_to_masters)
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.models.base_model import build_model as j_build_model
from antmmf_tpu.modules import moco as j_moco
from antmmf_tpu.parallel.mesh import batch_spec as j_batch_spec, build_mesh as j_build_mesh
from antmmf_tpu.trainers.base_trainer import BaseTrainer as JBaseTrainer
from antmmf_tpu.trainers.train_state import TrainState as JTrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "projects", "base_vtp", "configs")
CFG = os.path.join(CONFIGS, "video_retrieval.local.yml")
MOCO = os.path.join(CONFIGS, "video_retrieval_moco.local.yml")
COMMON = ["training_parameters.seed", "5", "training_parameters.device", "cpu",
          "optimizer_attributes.params.lr", "0.001", "optimizer_attributes.params.eps", "1e-4",
          "training_parameters.mesh.model", "1"]
MINING = ["model_attributes.univl_retrieval.with_cross_encoder", "true",
          "model_attributes.univl_retrieval.hard_mining_k", "2",
          "model_attributes.univl_retrieval.cross_layers", "1"]
LOSS_RTOL, MASTER_ATOL, MU_ATOL, NU_RTOL = 1e-5, 2e-6, 1e-7, 1e-4


def mesh(data, fsdp):
    return ["training_parameters.mesh.data", str(data), "training_parameters.mesh.fsdp", str(fsdp)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def global_batches(seed=0, n=2, B=4, L=30, F=2, S=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(5, L, size=B)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int64)
        ids = rng.integers(1000, 2000, size=(B, L)) * mask
        out.append({"image_data": rng.standard_normal((B, F, S, S, 3)).astype(np.float32),
                    "video_mask": np.ones((B, F), np.int64), "image_vid": np.arange(B),
                    "caption_tid": np.arange(B), "caption_input_ids": ids,
                    "caption_input_mask": mask, "caption_segment_ids": np.zeros_like(ids),
                    "caption_lm_label_ids": -np.ones_like(ids), "caption_raw_input_ids": ids,
                    "targets": np.zeros(B, np.int64)})
    return out


BATCHES = global_batches()
POOL = concurrent.futures.ThreadPoolExecutor(1)


def spawn(tmp, nproc, scenarios, pairs=()):
    """Start ``nproc`` ranks on the scenarios, then (with ``pairs``) each
    pair of ranks as a world of 2 on its own scenarios; a future of every
    rank's results."""
    spec, out = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out")
    os.makedirs(out)
    torch.save({"scenarios": scenarios, "pairs": list(pairs),
                "pair_ports": [free_port() for _ in pairs]}, spec)

    def run():
        code = launch([os.path.join(HERE, "torch_ranks_worker.py"), spec, out], nproc=nproc,
                      poll_seconds=0.2, extra_env={"OMP_NUM_THREADS": "1"})
        assert code == 0
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(nproc)]

    return POOL.submit(run)


def steps_spec(config, tmp, name, *opts):
    return {"config": config, "batches": BATCHES,
            "opts": [*COMMON, *opts, "training_parameters.save_dir", os.path.join(tmp, name)]}


def trainer_spec(tmp, name, *opts):
    return {"config": CFG, "opts": [*COMMON, "training_parameters.max_iterations", "2",
                                    "training_parameters.log_interval", "1",
                                    "training_parameters.run_type", "train", *opts,
                                    "training_parameters.save_dir", os.path.join(tmp, name)]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks, started before this process compiles the JAX
    references: the 4-rank scenarios, then two worlds of 2 (ranks 0, 1 and
    2, 3) share the 2-rank scenarios."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    t2, t4 = os.path.join(tmp, "two"), os.path.join(tmp, "four")
    future = spawn(tmp, 4, [
        ("ddp_fsdp", "steps", steps_spec(CFG, t4, "ddp_fsdp", *MINING, *mesh(2, 2))),
        ("trainer", "trainer", trainer_spec(t4, "trainer", *mesh(2, 2),
                                            "training_parameters.test_batch_size", "8")),
    ], pairs=[[
        ("ddp", "steps", steps_spec(CFG, t2, "ddp", *MINING, *mesh(2, 1))),
        ("fsdp", "steps", steps_spec(CFG, t2, "fsdp", *MINING, *mesh(1, 2))),
        ("dropout", "dropout", trainer_spec(t2, "dropout", *mesh(2, 1),
                                            "model_attributes.univl_retrieval.dropout", "0.1")),
    ], [
        ("moco", "steps", steps_spec(MOCO, t2, "moco", *mesh(2, 1))),
        ("trainer", "trainer", trainer_spec(t2, "trainer", *mesh(2, 1))),
        ("shards", "shards", {}),
    ]])
    return t2, t4, future


@pytest.fixture(scope="module")
def ranks2(spawned, jax_mining, jax_moco):
    """The 2-rank scenarios: rank r's results of both pairs."""
    results = spawned[2].result()
    assert all(r["pair_world"] == 2 for r in results)
    return spawned[0], [{**results[r]["pair"], **results[2 + r]["pair"]} for r in range(2)]


@pytest.fixture(scope="module")
def ranks4(spawned, jax_mining):
    results = spawned[2].result()
    assert all(r["world"] == 4 for r in results)
    return spawned[1], results


def one_process(config, tmp, *opts):
    t = t_build_trainer(t_build_config(config, opts=[*COMMON, *opts,
                                                     "training_parameters.save_dir", tmp]))
    t.load()
    return t


def jax_steps(config, port, *opts, batches=BATCHES):
    """The JAX trainer's jitted step on the global ``batches``, from the
    port's init: (host scalars a step, the mined columns a step, final
    state). The columns ride out of the step with its scalars."""
    jt = JBaseTrainer(j_build_config(config, opts=[*COMMON[:2], *COMMON[4:8], *opts]))
    jt._init_device_and_seed()
    # one device: the global batch whole, and no SPMD partitioning to compile
    jt.mesh = j_build_mesh({"data": 1}, devices=jax.devices()[:1])
    jt.batch_sharding_ = jax.sharding.NamedSharding(jt.mesh, j_batch_spec())
    jt.shell = j_build_model(jt.config, None)
    loss_fn = jt.shell.loss_fn

    def with_cols(*args, **kwargs):
        loss, (output, scalars) = loss_fn(*args, **kwargs)
        if "l2_pair_cols" in output:
            scalars = {**scalars, "l2_pair_cols": output["l2_pair_cols"]}
        return loss, (output, scalars)

    jt.shell.loss_fn = with_cols
    module = port.shell.module
    variables = jax.tree_util.tree_map(jnp.asarray, export_flax_variables(module))
    jt._init_variables = variables
    jt.load_optimizer()
    jt._moco_m = 0.0
    if module.with_momentum:
        variables = {**variables, "momentum": j_moco.init_momentum_params(
            {"base": variables["params"]["base"]})}
        jt._moco_m = float(module.momentum)
    jt.state = JTrainState.create(variables, jt.tx, jax.random.PRNGKey(0))
    jt.compile_steps()
    scalars, cols = [], []
    # the state placed as the step leaves it (committed, replicated): every
    # step then reuses the first step's compile
    replicated = jax.sharding.NamedSharding(jt.mesh, jax.sharding.PartitionSpec())
    for batch in batches:
        sharded = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                 jt.batch_sharding_)
        jt.state, s = jt._train_step(jax.device_put(jt.state, replicated), sharded)
        s = jax.device_get(s)
        if "l2_pair_cols" in s:
            cols.append(np.asarray(s.pop("l2_pair_cols")))
        scalars.append({k: float(x) for k, x in s.items()})
    return scalars, cols, jax.device_get(jt.state)


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


def as_port(module, tree):
    return flax_to_masters(module, flatten_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), tree)))


@pytest.fixture(scope="module")
def jax_mining(spawned, tmp_path_factory):
    port = one_process(CFG, str(tmp_path_factory.mktemp("one")), *MINING)
    return port, jax_steps(CFG, port, *MINING)


@pytest.fixture(scope="module")
def jax_moco(spawned, tmp_path_factory):
    port = one_process(MOCO, str(tmp_path_factory.mktemp("one_moco")))
    return port, jax_steps(MOCO, port)


def check_against_jax(ranks, ref, moments=True):
    port, (j_scalars, j_cols, j_state) = ref
    module = port.shell.module
    r0 = ranks[0]
    for t, j in zip(r0["scalars"], j_scalars):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
        assert t["grad_norm"] > 1.0  # the clip cut this step
    assert len(r0["cols"]) == len(j_cols)
    for t, j in zip(r0["cols"], j_cols):
        np.testing.assert_array_equal(t, j)
    masters = as_port(module, j_state.variables["params"])
    for n, ref_t in masters.items():
        np.testing.assert_allclose(r0["masters"][n].numpy(), ref_t.numpy(), atol=MASTER_ATOL,
                                   rtol=0, err_msg=n)
    if moments:
        adam = _adam(j_state.opt_state)
        mu, nu = as_port(module, adam.mu), as_port(module, adam.nu)
        for n in r0["mu"]:
            np.testing.assert_allclose(r0["mu"][n].float().numpy(), mu[n].numpy(),
                                       atol=MU_ATOL, rtol=0, err_msg=n)
            np.testing.assert_allclose(r0["nu"][n].numpy(), nu[n].numpy(), atol=1e-12,
                                       rtol=NU_RTOL, err_msg=n)
    for r in ranks[1:]:  # every rank read the same scalars and holds the same whole state
        assert r["scalars"] == r0["scalars"]
        for n, t in r["masters"].items():
            assert torch.equal(t, r0["masters"][n]), n


@pytest.mark.parametrize("scenario", ["ddp", "fsdp"])
def test_two_ranks_equal_jax_one_device_step(ranks2, jax_mining, scenario):
    """{data: 2} and {fsdp: 2}: loss, parts, clipped norm, mined columns,
    masters and both moments after 2 steps."""
    check_against_jax([r[scenario] for r in ranks2[1]], jax_mining)


def test_four_ranks_data_by_fsdp_equal_jax(ranks4, jax_mining):
    check_against_jax([r["ddp_fsdp"] for r in ranks4[1]], jax_mining)


def test_fsdp_shards_the_state(ranks2, ranks4, jax_mining):
    """Under fsdp each rank holds about 1/fsdp of the one-process masters and
    optimizer state (the kernels and embeddings; biases and norms whole)."""
    port = jax_mining[0]
    one_opt, one_masters = port.state.optimizer_state_bytes(), port.state.master_bytes()
    for ranks, name, fsdp in ((ranks2[1], "fsdp", 2), (ranks4[1], "ddp_fsdp", 2)):
        for r in ranks:
            assert r[name]["sharded"]
            for key, one in (("optimizer_state_bytes", one_opt), ("master_bytes", one_masters)):
                share = r[name][key] / one
                assert 1 / fsdp <= share < 1 / fsdp + 0.02, (name, key, share)
    for r in ranks2[1]:
        assert r["ddp"]["optimizer_state_bytes"] == one_opt and not r["ddp"]["sharded"]


def test_moco_queue_and_momentum_equal_jax(ranks2, jax_moco):
    """The MoCo step over 2 ranks: loss, masters, the EMA towers and both
    queues (the global batch's keys, in order, on every rank)."""
    ranks = [r["moco"] for r in ranks2[1]]
    check_against_jax(ranks, jax_moco, moments=False)
    port, (_, _, j_state) = jax_moco
    params = j_state.variables["params"]
    momentum = as_port(port.shell.module, {**params, **j_state.variables["momentum"]})
    for n, t in ranks[0]["momentum"].items():
        np.testing.assert_allclose(t.numpy(), momentum[n].numpy(), atol=MASTER_ATOL, rtol=0,
                                   err_msg=n)
    queues = {"/".join(p): np.asarray(v) for p, v in
              ((tuple(str(k.key) for k in path), v) for path, v in
               jax.tree_util.tree_flatten_with_path(j_state.variables["moco"])[0])}
    for r in ranks:
        assert int(r["queues"]["text_queue/ptr"]) == 8  # 2 steps of 4 keys
        for path, t in r["queues"].items():
            if path.endswith(("ptr", "filled")):
                assert int(t) == int(queues[path]), path
            else:
                np.testing.assert_allclose(t.numpy(), queues[path], atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """One process on the fixture config, to restore the ranks' snapshots."""
    return one_process(CFG, str(tmp_path_factory.mktemp("one_plain")))


@pytest.mark.parametrize("world", [2, 4])
def test_global_recall_equals_one_process(ranks2, ranks4, one, world):
    """The full validation's recall over ranks (the 4-rank run pads each
    rank's only sample to a batch of 2) equals one process's on the state
    the ranks saved."""
    tmp, ranks = ranks2 if world == 2 else ranks4
    val = ranks[0]["trainer"]["val"]
    assert all(r["trainer"]["val"] == val for r in ranks)
    one.checkpoint.restore_state(one.state, os.path.join(tmp, "trainer", "models", "model_2"))
    ref = one.evaluate_set("val")
    recalls = [k for k in ref if "-r@" in k or k.endswith(("rank", "mean_recall"))]
    assert len(recalls) == 11
    assert {k: val[k] for k in recalls} == {k: ref[k] for k in recalls}
    if world == 2:  # 4 ranks score a padded global batch of 8 rows
        np.testing.assert_allclose(val["total_loss"], ref["total_loss"], rtol=LOSS_RTOL)


def test_snapshot_of_two_ranks_resumes_in_one_process(ranks2, one):
    """model_2 of the 2-rank run resumes (``resume_file``) in one process:
    the step, the masters bit for bit, rank 0's generator; then a step."""
    snapshot = os.path.join(ranks2[0], "trainer", "models", "model_2")
    saved = torch.load(snapshot, weights_only=True)
    assert len(saved["rank_generators"]) == 2
    state, info = one.checkpoint.resume(one.state, {"resume_file": snapshot})
    assert state.step == 2 and info == {"mode": "resume_file", "ok": True}
    names = {p: n for n, p in flax_paths(one.shell.module).items()}
    for path, t in saved["params"].items():
        assert torch.equal(state.params[names[path]], t), path
    assert torch.equal(state.generator.get_state(), saved["generator"])
    state, scalars = one._train_step(state, {k: torch.from_numpy(v) for k, v in
                                             BATCHES[0].items()})
    assert state.step == 3 and np.isfinite(one._host(scalars)["total_loss"])


def test_ranks_draw_different_dropout_masks(ranks2):
    a, b = (r["dropout"]["mask"] for r in ranks2[1])
    assert a.shape == b.shape == (64,) and (a != b).any()


def test_shards_gather_in_buckets_into_the_compute_dtype(ranks2):
    """``Shards.gather_into`` in buckets of 16 bytes writes each whole
    tensor, cast to its destination's dtype, on every rank;
    ``gather_to_host`` gives rank 0 the whole tensors and rank 1 nothing."""
    results = [r["shards"] for r in ranks2[1]]
    whole = results[0]["whole"]
    for r in results:
        for n, t in r["into"].items():
            assert torch.equal(t, whole[n].to(t.dtype)), n
    assert results[1]["host"] is None
    assert set(results[0]["host"]) == set(whole)
    for n, t in results[0]["host"].items():
        assert torch.equal(t, whole[n]), n
