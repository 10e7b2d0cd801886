"""The port's parallel surface against the JAX package's, on the CPU, with no
process group.

* ``build_mesh``: the rank layout against JAX's ``build_mesh(...).devices``
  ids over the 8 CPU devices for ``{data: -1}``, ``{data: 2, fsdp: 4}``,
  ``{dcn: {data: 2}, fsdp: -1}`` and a ``dcn`` on ``fsdp``; the same
  errors (and ``{data: 2, seq: 4}``, ``{fsdp: 2, seq: -1}``); ``model``
  over ranks raising with "A7b"; a declared mesh collapsing at world size
  1; the ranks of a ``seq`` line sharing their batch slice;
* ``spec_for``, ``infer_param_specs``, ``validate_specs`` and
  ``relax_to_divisible`` against JAX's on the tiny retrieval model's flax
  paths and shapes, under the default rules and a config's;
  a rule naming ``model`` raising; the port dimension each spec shards;
* ``DistributedSampler``'s indices against JAX's for several (n, replicas,
  rank, seed, epoch);
* ``chunked_symmetric_infonce``'s value and gradients against JAX's, with N
  not divisible by the chunk (atol 1e-6, fp32 sums in another order);
* ``remat_policy``: the names, an unknown one; a step under
  ``dots_saveable`` and ``nothing_saveable`` with dropout 0.1 equal to one
  without remat, bit for bit (the recompute draws the same masks from the
  explicit generator), with the generator where the plain step leaves it;
* ``steps_per_dispatch``: K = 3 against K = 1 through the trainer, 7 steps
  (two windows and a remainder): the same masters bit for bit and the same
  last loss; and its first 6 steps (two windows) against the JAX trainer's
  jitted window (``lax.scan``) on the same batches from the same init
  (masters at atol 2e-6, the loss at rtol 1e-5; AdamW's eps 1e-6 keeps it
  from scaling the fp32 noise of gradients that are zero in exact
  arithmetic, such as the key projections' biases, up to the learning
  rate), the JAX window compiled in a thread while the port's trainers
  run;
* the launcher: a rank that fails ends the job with its code.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.datasets.samplers import DistributedSampler as TSampler
from antmmf_torch.parallel import partitioning as TP
from antmmf_torch.parallel.contrastive import chunked_symmetric_infonce as t_infonce
from antmmf_torch.parallel.mesh import build_mesh as t_mesh, local_batch_size
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.trainers.train_state import remat_context
from antmmf_torch.utils.launch import launch
from antmmf_torch.utils.weights import (export_flax_variables, flatten_flax, flax_paths,
                                        to_torch_layout)
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.datasets.samplers import DistributedSampler as JSampler
from antmmf_tpu.models.base_model import build_model as j_build_model
from antmmf_tpu.parallel import partitioning as JP
from antmmf_tpu.parallel.contrastive import chunked_symmetric_infonce as j_infonce
from antmmf_tpu.parallel.mesh import batch_spec as j_batch_spec, build_mesh as j_mesh
from antmmf_tpu.trainers.base_trainer import BaseTrainer as JBaseTrainer
from antmmf_tpu.trainers.train_state import TrainState as JTrainState
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")


@pytest.mark.parametrize("cfg", [{"data": -1}, {"data": 2, "fsdp": 4},
                                 {"dcn": {"data": 2}, "fsdp": -1},
                                 {"dcn": {"fsdp": 2}, "data": 2, "fsdp": 2},
                                 {"data": 2, "seq": 4}, {"fsdp": 2, "seq": -1}])
def test_mesh_layout_matches_jax(cfg):
    j = np.vectorize(lambda d: d.id)(j_mesh(dict(cfg)).devices)
    t = t_mesh(dict(cfg), 8)
    np.testing.assert_array_equal(t.devices, j)
    assert t.shape == dict(j_mesh(dict(cfg)).shape) and not t.collapsed


@pytest.mark.parametrize("cfg", [{"data": 3}, {"data": -1, "fsdp": -1}, {"bogus": 2},
                                 {"dcn": {"data": 3}}, {"dcn": {"data": -1}}])
def test_mesh_errors_match_jax(cfg):
    with pytest.raises(ValueError):
        j_mesh(dict(cfg))
    with pytest.raises(ValueError):
        t_mesh(dict(cfg), 8)


def test_mesh_later_axes_and_world_one():
    with pytest.raises(NotImplementedError, match="A7b"):
        t_mesh({"data": -1, "model": 2}, 8)
    one = t_mesh({"data": 4, "fsdp": 8}, 1)  # pink_7b.yml's mesh in one process
    assert one.collapsed and set(one.shape.values()) == {1}
    assert local_batch_size(32, t_mesh({"data": 2, "fsdp": 4}, 8)) == 4
    with pytest.raises(ValueError):
        local_batch_size(30, t_mesh({"data": -1}, 8))


def test_seq_ranks_share_their_batch_slice():
    """Under {data: 2, fsdp: 2, seq: 2} the ranks of a seq line load the
    slice of their (data, fsdp) coordinate, the same one; a rule may name
    seq (it shards nothing: a seq line holds the whole state)."""
    mesh = t_mesh({"data": 2, "fsdp": 2, "seq": 2}, 8)
    index = {r: mesh.batch_index(r) for r in range(8)}
    lines = mesh.devices.reshape(-1, 2)
    assert [[index[r] for r in line] for line in lines.tolist()] == [[i, i] for i in range(4)]
    assert all(mesh.coords(r)["seq"] == i for line in lines.tolist()
               for i, r in enumerate(line))
    assert TP.shard_dims({"w": "a/kernel"}, {"w": (4, 6)}, 2, [(r".*", ["seq", "fsdp"])]) == \
        {"w": 0}


@pytest.fixture(scope="module")
def tiny_model():
    cfg = t_build_config(CFG, opts=["model_attributes.univl_retrieval.with_cross_encoder",
                                    "true"])
    from antmmf_torch.models.base_model import build_model

    return build_model(cfg, None, "cpu").module


RULES = [(r".*attention.*kernel", [None, "fsdp"]), (r".*mlp.*kernel", [["data", "fsdp"], None]),
         (r".*embedding$", ["fsdp", None]), (r".*", None)]


@pytest.mark.parametrize("rules", [None, RULES], ids=["default", "config"])
def test_specs_match_jax(tiny_model, rules):
    paths = flax_paths(tiny_model)
    shapes = {paths[n]: TP.flax_shape(paths[n], p.shape)
              for n, p in tiny_model.named_parameters()}
    tree = {}
    for path, shape in shapes.items():
        *outer, leaf = path.split("/")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = np.zeros(shape, np.float32)
    j_specs = {"/".join(str(k.key) for k in p): tuple(s) for p, s in
               jax.tree_util.tree_flatten_with_path(
                   JP.infer_param_specs(tree, rules),
                   is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    t_specs = TP.infer_param_specs(shapes, rules)
    assert t_specs == j_specs
    unrelaxed = JP.infer_param_specs(tree, rules)
    mesh = j_mesh({"data": 2, "fsdp": 4})
    assert sorted(TP.validate_specs(shapes, t_specs, dict(mesh.shape))) == sorted(
        JP.validate_specs(tree, unrelaxed, mesh))
    relaxed = jax.tree_util.tree_flatten_with_path(
        JP.relax_to_divisible(unrelaxed, tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert TP.relax_to_divisible(t_specs, shapes, dict(mesh.shape)) == {
        "/".join(str(k.key) for k in p): tuple(s) for p, s in relaxed}
    for path, shape in shapes.items():
        assert TP.spec_for(path, len(shape), rules or TP.DEFAULT_RULES) == tuple(
            JP.spec_for(path, len(shape), rules or JP.DEFAULT_RULES))


def test_shard_dims_pick_the_port_dimension(tiny_model):
    """``.*kernel`` → fsdp on flax dim 0 (a Dense's input) is the port
    weight's dim 1; a dimension fsdp does not divide stays whole."""
    paths = flax_paths(tiny_model)
    shapes = {n: p.shape for n, p in tiny_model.named_parameters()}
    dims = TP.shard_dims(paths, shapes, 2)
    assert dims["base.text_fc.weight"] == 1 and dims["base.cross_type_embed.weight"] == 0
    assert "base.text_fc.bias" not in dims and "logit_scale" not in dims
    odd = {n: s for n, s in shapes.items() if n in dims and s[dims[n]] % 3}
    assert odd and not set(odd) & set(TP.shard_dims(paths, shapes, 3))
    with pytest.raises(NotImplementedError, match="A7b"):
        TP.shard_dims(paths, shapes, 2, [(r".*", ["model", None])])


@pytest.mark.parametrize("n,replicas,seed,epoch,shuffle", [
    (10, 2, 0, 0, True), (10, 3, 7, 2, True), (11, 4, 3, 1, True), (8, 4, 0, 5, False),
    (7, 2, 1, 0, False)])
def test_distributed_sampler_matches_jax(n, replicas, seed, epoch, shuffle):
    data = list(range(n))
    for rank in range(replicas):
        t = TSampler(data, shuffle=shuffle, seed=seed, num_replicas=replicas, rank=rank)
        j = JSampler(data, shuffle=shuffle, seed=seed, num_replicas=replicas, rank=rank)
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


@pytest.mark.parametrize("n,chunk", [(10, 4), (5, 16)])
def test_chunked_symmetric_infonce_matches_jax(n, chunk):
    rng = np.random.default_rng(n)
    text, video = (rng.standard_normal((n, 8)).astype(np.float32) for _ in range(2))
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    scale = 7.5
    jv, jg = jax.jit(jax.value_and_grad(lambda a, b: j_infonce(a, b, scale, chunk), (0, 1)))(
        jnp.asarray(text), jnp.asarray(video))
    t, v = (torch.tensor(x, requires_grad=True) for x in (text, video))
    tv = t_infonce(t, v, scale, chunk)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[1]), atol=1e-6)


def test_remat_policy_names():
    assert remat_context("none") is None and remat_context(None) is None
    for name in ("dots_saveable", "everything_saveable", "nothing_saveable",
                 "dots_with_no_batch_dims_saveable", "checkpoint_dots",
                 "checkpoint_dots_with_no_batch_dims"):
        assert callable(remat_context(name))
    with pytest.raises(ValueError, match="remat_policy"):
        remat_context("not_a_policy")


def _trainer(tmp, *opts):
    t = t_build_trainer(t_build_config(CFG, opts=[
        "training_parameters.device", "cpu", "training_parameters.seed", "11",
        "training_parameters.save_dir", str(tmp), "training_parameters.log_interval", "100",
        "training_parameters.snapshot_interval", "100", *opts]))
    t.load()
    return t


@pytest.fixture(scope="module")
def remat_runs(tmp_path_factory):
    """One step of the same batch with dropout 0.1 under each policy."""
    out = {}
    for policy in ("none", "dots_saveable", "nothing_saveable"):
        t = _trainer(tmp_path_factory.mktemp(policy),
                     "model_attributes.univl_retrieval.dropout", "0.1",
                     "model_attributes.univl_retrieval.with_cross_encoder", "true",
                     "training_parameters.remat_policy", policy)
        batch = t._to_device(t._cached_first_batch)
        state, scalars = t._train_step(t.state, batch)
        out[policy] = (t._host(scalars), state.params, state.generator.get_state())
    return out


@pytest.mark.parametrize("policy", ["dots_saveable", "nothing_saveable"])
def test_remat_step_equals_no_remat(remat_runs, policy):
    ref_scalars, ref_params, ref_gen = remat_runs["none"]
    scalars, params, gen = remat_runs[policy]
    assert scalars == ref_scalars
    for n, t in ref_params.items():
        assert torch.equal(params[n], t), n
    assert torch.equal(gen, ref_gen)


WINDOW_OPTS = ["training_parameters.steps_per_dispatch", "3",
               "optimizer_attributes.params.eps", "1e-6"]


def jax_window_trainer(init_variables):
    """The JAX trainer on one device whose jitted window (``lax.scan`` of 3
    steps) starts from ``init_variables``."""
    jt = JBaseTrainer(j_build_config(CFG, opts=["training_parameters.seed", "11",
                                                *WINDOW_OPTS]))
    jt._init_device_and_seed()
    jt.mesh = j_mesh({"data": 1}, devices=jax.devices()[:1])
    jt.window_sharding_ = jax.sharding.NamedSharding(
        jt.mesh, jax.sharding.PartitionSpec(None, *j_batch_spec()))
    jt.shell = j_build_model(jt.config, None)
    jt._init_variables = init_variables
    jt.load_optimizer()
    jt._moco_m = 0.0
    jt.compile_steps()
    return jt


def jax_window(jt, state, batches):
    """One window of ``batches`` from ``state``, placed as the window leaves
    it (committed and replicated), so every window reuses one compile."""
    stacked = {f: np.stack([np.asarray(b[f]) for b in batches]) for f in batches[0]}
    state = jax.device_put(state, jax.sharding.NamedSharding(
        jt.mesh, jax.sharding.PartitionSpec()))
    return jt._train_window(state, jax.device_put(stacked, jt.window_sharding_))


@pytest.fixture(scope="module")
def window_runs(tmp_path_factory):
    """K = 1 and K = 3 through the trainer; meanwhile a thread compiles the
    JAX window from the same init (warmed on zero batches of the loader's
    shapes), so the JAX test only runs it."""
    runs, warm = {}, None
    pool = concurrent.futures.ThreadPoolExecutor(1)
    for k in (1, 3):
        t = _trainer(tmp_path_factory.mktemp(f"w{k}"),
                     "training_parameters.steps_per_dispatch", str(k),
                     "training_parameters.max_iterations", "7",
                     "training_parameters.run_type", "train",
                     "optimizer_attributes.params.eps", "1e-6")
        init = {n: p.detach().clone() for n, p in t.shell.module.named_parameters()}
        if warm is None:
            variables = jax.tree_util.tree_map(jnp.asarray,
                                               export_flax_variables(t.shell.module))
            zeros = [{f: np.zeros_like(v.numpy()) for f, v in
                      t._to_device(t._cached_first_batch).items()}] * 3

            def compile_window(variables=variables, zeros=zeros):
                jt = jax_window_trainer(variables)
                jax.block_until_ready(jax_window(jt, JTrainState.create(
                    variables, jt.tx, jax.random.PRNGKey(0)), zeros))
                return jt

            warm = pool.submit(compile_window)
        batches, losses, after6, real = [], [], {}, t._train_step

        def record(state, batch, real=real, batches=batches, losses=losses, t=t,
                   after6=after6):
            batches.append({f: v.clone() for f, v in batch.items()})
            state, scalars = real(state, batch)
            losses.append(t._host(scalars)["total_loss"])
            if state.step == 6:
                after6.update({n: p.clone() for n, p in state.params.items()})
            return state, scalars

        t._train_step = record
        t.train()
        runs[k] = (t, batches, init, losses, after6)
    runs["jax"] = warm.result()
    return runs


def test_windows_equal_single_steps(window_runs):
    (one, b1, _, l1, _), (three, b3, _, l3, _) = window_runs[1], window_runs[3]
    assert one.state.step == three.state.step == 7 and len(b1) == len(b3) == 7
    assert all(torch.equal(x[f], y[f]) for x, y in zip(b1, b3) for f in x)
    for n, t in one.state.params.items():
        assert torch.equal(three.state.params[n], t), n
    assert l1 == l3


def test_windows_equal_jax_window(window_runs):
    """6 steps as two windows of 3 against the JAX trainer's ``lax.scan``
    window on the same stacked batches, from the port's init."""
    t, batches, init, losses, after6 = window_runs[3]
    jt = window_runs["jax"]
    module = t.shell.module
    with torch.no_grad():
        final = {n: p.detach().clone() for n, p in module.named_parameters()}
        for n, p in module.named_parameters():
            p.copy_(init[n])
        variables = jax.tree_util.tree_map(jnp.asarray, export_flax_variables(module))
        for n, p in module.named_parameters():
            p.copy_(final[n])
    state = JTrainState.create(variables, jt.tx, jax.random.PRNGKey(0))
    for w in range(2):
        state, scalars = jax_window(jt, state, [{f: v.numpy() for f, v in b.items()}
                                                for b in batches[3 * w:3 * w + 3]])
    params = flatten_flax(jax.tree_util.tree_map(np.asarray, state.variables["params"]))
    paths = flax_paths(module)
    for n, ref in after6.items():
        j = to_torch_layout(paths[n], params[paths[n]], tuple(ref.shape))
        np.testing.assert_allclose(ref.numpy(), j, atol=2e-6, rtol=0, err_msg=n)
    np.testing.assert_allclose(losses[5], float(scalars["total_loss"][-1]), rtol=1e-5)


def test_a_failing_rank_ends_the_job(tmp_path):
    """pool_processes: a rank that exits non-zero terminates the others, and
    the launcher returns that rank's code; -m runs a module as every rank."""
    script = tmp_path / "worker.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                      "time.sleep(60)\n")
    assert launch([str(script)], nproc=2, poll_seconds=0.1) == 3
    ok = tmp_path / "ok.py"
    ok.write_text("import os\nassert os.environ['WORLD_SIZE'] == '3'\n"
                  "assert int(os.environ['RANK']) < 3 and os.environ['MASTER_PORT']\n")
    assert launch([str(ok)], nproc=3, poll_seconds=0.1) == 0
