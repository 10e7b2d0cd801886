"""The port's training surface against the JAX package, on the CPU.

* ``antmmf_torch.optimizer.build`` (AdamW with the weight-decay mask,
  global-norm clipping, bf16 first moment, lr multipliers and warmup) against
  the optax chain that ``antmmf_tpu.optimizer.build`` builds, over three steps;
* the tiny flagship (two towers) and cross-mined (with the cross-encoder and
  in-step hard-negative mining, ``hard_mining_k`` 3) train steps against the
  JAX step of ``bench.py``, on the same init (the JAX init carried by
  ``flax_to_masters``), the same numpy batch and fp32 compute: the first
  step's mined columns and both losses, and a six-step loss trajectory.

The cross-mined batch has 14 frames of 64² (17 ViT tokens each), so the pair
stream is 30 + 14·17 = 268 tokens and the cross-encoder takes the flash route
(its plain versions on the CPU). Tolerances: the optimizer's parameters at
atol 1e-7 (fp32 rounding of the same arithmetic), its bf16 ``mu`` exactly;
losses at atol 1e-4 (runs read at most 2.7e-5 after six steps, fp32 sums in
another order compounded by the updates).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules import attention as t_attention
from antmmf_torch.optimizer.build import build_lr_schedule as t_schedule
from antmmf_torch.optimizer.build import build_optimizer as t_optimizer
from antmmf_torch.trainers.train_state import TrainState, make_train_step
from antmmf_torch.utils.weights import flax_paths, flax_to_masters
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.optimizer.build import build_lr_schedule as j_schedule
from antmmf_tpu.optimizer.build import build_optimizer as j_optimizer
from antmmf_tpu.trainers.train_state import TrainState as JTrainState

STEPS, LOSS_ATOL = 6, 1e-4
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", embed_dim=32,
            dtype_str="float32")
MODELS = {
    "flagship": ({**TINY, "image_size": 32}, 4, 2, 32),
    "cross_mined": ({**TINY, "image_size": 64, "with_cross_encoder": True,
                     "cross_layers": 2, "hard_mining_k": 3}, 4, 14, 64),
}
OPTIMIZER = {"type": "adam_w", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                          "mu_dtype": "bfloat16"}}
TRAINING = {"clip_gradients": True, "max_grad_l2_norm": 1.0}


def _batch(B, F, size, seed):
    """Ragged captions and one sample with two padded frames."""
    rng = np.random.default_rng(seed)
    lens = np.array([30, 17, 9, 23][:B])
    mask = (np.arange(30)[None] < lens[:, None]).astype(np.int64)
    video_mask = np.ones((B, F), np.int64)
    video_mask[1, -2:] = 0
    return {"image_data": rng.random((B, F, size, size, 3), dtype=np.float32),
            "video_mask": video_mask,
            "caption_input_ids": rng.integers(1, 30522, (B, 30)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, 30), np.int64)}


def _config(model):
    return {"model_attributes": {"univl_retrieval": model},
            "optimizer_attributes": OPTIMIZER, "training_parameters": TRAINING}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX step of bench.py, STEPS times on one batch: (init params,
    losses, first step's scalars, first step's mined columns)."""
    model, B, F, size = MODELS[name]
    cfg, batch = _config(model), _batch(B, F, size, seed=len(name))
    shell = j_build(cfg)
    variables = shell.init(jax.random.PRNGKey(0), batch)
    tx, _ = j_optimizer(variables["params"], OPTIMIZER, TRAINING)
    state = JTrainState.create(variables, tx, jax.random.PRNGKey(1))

    def train_step(state, batch):
        def loss_of(p):
            loss, (out, scalars) = shell.loss_fn(
                {**state.variables, "params": p}, batch,
                rngs={"dropout": jax.random.fold_in(state.rng, state.step)},
                deterministic=False)
            return loss, (scalars, out.get("l2_pair_cols"))

        (loss, aux), grads = jax.value_and_grad(loss_of, has_aux=True)(state.params)
        return state.apply_gradients(grads, tx), (loss, aux)

    step = jax.jit(train_step)
    params = jax.device_get(variables["params"])
    losses, first = [], None
    for _ in range(STEPS):
        state, (loss, aux) = step(state, batch)
        losses.append(float(loss))
        first = first or jax.device_get(aux)
    return params, np.array(losses), first[0], first[1], batch


def _port(name, params, batch):
    model = MODELS[name][0]
    shell = t_build(_config(model), device="cpu")
    tx, _ = t_optimizer(flax_paths(shell.module), OPTIMIZER, TRAINING)
    state = TrainState.create(shell.module, tx, flax_to_masters(shell.module, params))
    return shell, tx, state, shell.to_device(batch)


def test_cross_mined_first_step_matches_jax(monkeypatch):
    """The mined columns (positive first, then the k-1 hardest L1 negatives)
    and both losses on the initial weights; the pair stream went through
    the flash route."""
    params, _, scalars, cols, batch = _jax_run("cross_mined")
    routes = []
    real = t_attention.flash_attention
    monkeypatch.setattr(t_attention, "flash_attention",
                        lambda q, k, v, **kw: routes.append(q.shape) or real(q, k, v, **kw))
    shell, _, _, tb = _port("cross_mined", params, batch)
    loss, (out, t_scalars) = shell.loss_fn(tb, deterministic=False)
    assert routes and all(s[2] == 268 for s in routes)
    assert len(routes) == 2  # one per cross-encoder layer
    np.testing.assert_array_equal(out["l2_pair_cols"].numpy(), cols)
    assert (out["l2_pair_cols"][:, 0] == torch.arange(4)).all()
    for key in ("losses/level1_similarity_loss", "losses/level2_similarity_loss",
                "total_loss"):
        np.testing.assert_allclose(float(t_scalars[key]), float(scalars[key]),
                                   atol=LOSS_ATOL, err_msg=key)
    assert loss.grad_fn is not None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_trajectory_matches_jax(name):
    params, j_losses, _, _, batch = _jax_run(name)
    shell, tx, state, tb = _port(name, params, batch)
    step = make_train_step(shell, tx)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, tb)
        losses.append(float(loss))
    assert state.step == STEPS and state.opt_state["count"] == STEPS
    np.testing.assert_allclose(losses, j_losses, atol=LOSS_ATOL, rtol=0)
    assert losses[-1] < losses[0]


def _opt_inputs(seed):
    """A small flax tree whose paths meet every weight-decay and lr rule."""
    rng = np.random.default_rng(seed)
    shapes = {"img_encoder/layer_0/fc1/kernel": (6, 5), "img_encoder/layer_0/fc1/bias": (5,),
              "text_fc/kernel": (5, 3), "LayerNorm_0/scale": (5,),
              "cross_type_embed/embedding": (2, 5), "logit_scale": ()}
    params = {p: np.asarray(rng.standard_normal(s), np.float32) for p, s in shapes.items()}
    grads = [{p: np.asarray(3 * rng.standard_normal(s), np.float32) for p, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        *outer, leaf = path.split("/")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value)
    return tree


def test_adamw_matches_optax():
    """Three clipped steps under warmup with lr multipliers: the parameters
    and the stored bf16 first moment after each step."""
    optimizer = {"type": "adam_w", "lr_multipliers": [["img_encoder", 0.1]],
                 "params": {"lr": 1e-2, "weight_decay": 0.1, "mu_dtype": "bfloat16"}}
    training = {"clip_gradients": True, "max_grad_l2_norm": 1.0, "use_warmup": True,
                "warmup_iterations": 4, "warmup_factor": 0.25}
    params, grads = _opt_inputs(0)
    j_params = _nest(params)
    j_tx, j_schedule = j_optimizer(j_params, optimizer, training)
    j_state = j_tx.init(j_params)
    names = {p.replace("/", "."): p for p in params}
    t_tx, t_schedule = t_optimizer(names, optimizer, training)
    t_params = {n: torch.from_numpy(params[p].copy()) for n, p in names.items()}
    t_state = t_tx.init(t_params)
    assert t_state["mu"]["text_fc.kernel"].dtype == torch.bfloat16
    for count, g in enumerate(grads):
        assert np.float32(t_schedule(count)) == np.float32(j_schedule(count))
        updates, j_state = j_tx.update(_nest(g), j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, updates)
        t_tx.update({n: torch.from_numpy(g[p]) for n, p in names.items()}, t_state, t_params)
        flat_p = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v
                  in jax.tree_util.tree_flatten_with_path(j_params)[0]}
        adam = next(s for s in jax.tree_util.tree_leaves(
            j_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
        flat_mu = {"/".join(str(k.key) for k in path): np.asarray(v.astype(jnp.float32))
                   for path, v in jax.tree_util.tree_flatten_with_path(adam.mu)[0]}
        for n, p in names.items():
            np.testing.assert_allclose(t_params[n].numpy(), flat_p[p], atol=1e-7, rtol=0,
                                       err_msg=f"step {count + 1}: {p}")
            np.testing.assert_array_equal(t_state["mu"][n].float().numpy(), flat_mu[p],
                                          err_msg=f"step {count + 1}: mu {p}")


@pytest.mark.parametrize("training", [
    {"use_warmup": True, "warmup_iterations": 5, "lr_steps": [8, 12], "lr_ratio": 0.5},
    {"use_warmup": True, "warmup_iterations": 4, "lr_decay": "cosine",
     "max_iterations": 16, "min_lr_ratio": 0.1},
    {"lr_decay": "linear", "lr_decay_iterations": 10},
])
def test_lr_schedule_matches_jax(training):
    """Warmup then step, cosine or linear decay, step count by step count
    (atol 1e-12 on lr 3e-4: fp32 arithmetic in one order on both sides)."""
    t, j = t_schedule(training, 3e-4), j_schedule(training, 3e-4)
    np.testing.assert_allclose([float(t(c)) for c in range(20)],
                               [float(j(c)) for c in range(20)], atol=1e-12, rtol=0)


def test_weight_decay_mask_and_multipliers_follow_flax_paths():
    """The tiny cross-encoder model's parameter names map to the flax paths
    the JAX masks read: kernels decay, biases, LayerNorm scales, embeddings
    and the logit scale do not."""
    shell = t_build(_config(MODELS["cross_mined"][0]), device="cpu")
    paths = flax_paths(shell.module)
    assert paths["base.cross_encoder.layer_0.attention.q_proj.weight"] == \
        "base/cross_encoder/layer_0/attention/q_proj/kernel"
    assert paths["base.cross_type_embed.weight"] == "base/cross_type_embed/embedding"
    tx, _ = t_optimizer(paths, {**OPTIMIZER, "lr_multipliers": [["img_encoder", 0.1]]},
                        TRAINING)
    decays = {n for n, on in tx.decay_mask.items() if on}
    assert "base.cross_sim_head.weight" in decays
    assert not any(n.endswith(".bias") or "norm" in n.lower() for n in decays)
    assert "logit_scale" not in decays and "base.cross_type_embed.weight" not in decays
    assert {n for n, m in tx.lr_multipliers.items() if m == 0.1} == \
        {n for n in paths if n.startswith("base.img_encoder.")}


def test_unported_training_options_raise():
    for key, value in (("loss_type", "mil_nce"), ("with_queue", True), ("dropout", 0.1)):
        with pytest.raises(NotImplementedError):
            t_build(_config({**MODELS["flagship"][0], key: value}), device="cpu")
    with pytest.raises(NotImplementedError):
        t_optimizer({}, {"type": "lion"}, TRAINING)
