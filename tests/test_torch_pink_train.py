"""Pink's training surface in the port against the JAX package, on the CPU.

Tiny presets (``omni_tiny_test``: hidden 64, 2 layers, 2 heads of 32, 1 kv
head, vocabulary 1000; ``vit_tiny_test`` at 32²), fp32, LoRA rank 2 on the
decoder's q and v with the base frozen, weights drawn from numpy into both
packages (so every ``lora_b`` is live).

* The LM loss and every gradient: the loss at atol 1e-5, each gradient at
  atol 1e-4 of its largest magnitude (fp32 sums in another order over
  activations of magnitude 1 to 20); a
  parameter the port freezes (``requires_grad`` False) gets exactly zero
  gradient in JAX (its ``stop_gradient``). Labels of -100 and -1 are both
  ignored; a batch with no supervised token has loss 0 (denominator 1) and
  zero gradients.
* The activation gradient through the frozen q/v projections: ``GQAttention``
  with its base frozen, dx against JAX at atol 1e-5; with the frozen
  projections' outputs detached (the PEFT bug) dx moves far past that.
* The weight bridge over the whole training tree, both ways, bit for bit.
* The optimizer against optax (``antmmf_tpu.optimizer.build``) over 6
  iterations of random gradients on the tiny Pink tree: ``pink_7b.yml``'s
  ``frozen_params``; accumulation at k=2 and k=3 with the clip on and
  warmup; the in-between iterations change nothing; the lr schedule the
  trainer logs. Parameters at atol 1e-6. No moment and no accumulator for a
  frozen parameter.
* The weight-decay trap: JAX's ``lora_freeze_base`` stop-gradients the base
  kernel, which stays in optax's tree, so with ``weight_decay`` > 0 and no
  ``frozen_params`` over it AdamW decays it; the port freezes it at the
  weight and leaves it. At ``weight_decay`` 0 both leave it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.models.pink import PinkModel as TPink
from antmmf_torch.modules import llm as t_llm
from antmmf_torch.optimizer.build import build_optimizer as t_build_optimizer
from antmmf_torch.trainers.train_state import TrainState
from antmmf_torch.utils.weights import (
    _nest,
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.modules import llm as j_llm
from antmmf_tpu.optimizer.build import build_optimizer as j_build_optimizer
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            lora_rank=2, dtype_str="float32")
LOSS_ATOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
PINK_7B = "projects/pink/configs/pink_7b.yml"


def _random_params(module, *args, seed=0):
    params = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, params)


def _batch(seed, B=3, Lt=12, supervised=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (B, Lt))
    lens = np.array([Lt, Lt - 3, Lt - 5])[:B]
    mask = (np.arange(Lt)[None] < lens[:, None]).astype(np.int64)
    labels = np.where(mask > 0, ids, -100)
    labels[:, :4] = -100  # the instruction
    labels[0, 6] = -1  # any label below 0 is ignored
    if not supervised:
        labels[:] = -100
    return {"input_ids": ids * mask, "input_mask": mask, "labels": labels,
            "image_data": rng.standard_normal((B, 1, 32, 32, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def models():
    j_model = JPink(**TINY)
    j_batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    params = _random_params(j_model, j_batch)
    t_model = TPink(**TINY)
    load_flax_params(t_model, params)
    return j_model, params, t_model


_JAX_STEPS = {}


def _jax_loss_and_grads(j_model, params, batch):
    if j_model not in _JAX_STEPS:  # one compile a model and batch shape
        def loss_of(p, b):
            return j_model.apply({"params": p}, b, deterministic=False)["losses"]["lm_loss"]

        _JAX_STEPS[j_model] = jax.jit(jax.value_and_grad(loss_of))
    loss, grads = _JAX_STEPS[j_model](params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), flatten_flax(jax.device_get(grads))


def _port_loss_and_grads(t_model, batch):
    for p in t_model.parameters():
        p.grad = None
    out = t_model({k: torch.as_tensor(v) for k, v in batch.items()}, deterministic=False)
    loss = out["losses"]["lm_loss"]
    loss.backward()
    return loss.item(), {n: p.grad for n, p in t_model.named_parameters()}


@pytest.mark.parametrize("seed", [1, 2])
def test_lm_loss_and_every_gradient_match_jax(models, seed):
    j_model, params, t_model = models
    batch = _batch(seed)
    j_loss, j_grads = _jax_loss_and_grads(j_model, params, batch)
    t_loss, t_grads = _port_loss_and_grads(t_model, batch)
    assert abs(t_loss - j_loss) <= LOSS_ATOL and np.isfinite(t_loss) and t_loss > 1.0
    paths = flax_paths(t_model)
    assert set(paths.values()) == set(j_grads)
    frozen = [n for n, p in t_model.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(
        [f"decoder.layer_{i}.attention.{x}_proj.weight" for i in range(2) for x in "qv"]
        + ["output_adapter.base.weight", "output_adapter.base.bias"])
    for name, grad in t_grads.items():
        ref = to_torch_layout(paths[name], j_grads[paths[name]])
        if name in frozen:
            assert grad is None and not np.any(ref), name  # JAX: stop_gradient's zero
            continue
        atol = GRAD_RTOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(grad.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        assert np.abs(ref).max() > 0, name  # every trainable gradient is live


def test_a_batch_without_supervised_tokens_has_loss_zero(models):
    j_model, params, t_model = models
    batch = _batch(3, supervised=False)
    j_loss, j_grads = _jax_loss_and_grads(j_model, params, batch)
    t_loss, t_grads = _port_loss_and_grads(t_model, batch)
    assert t_loss == j_loss == 0.0
    assert all(g is None or not g.any() for g in t_grads.values())
    assert not any(np.any(g) for g in j_grads.values())


def _gqa_case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    return x, mask


def test_activation_gradient_flows_through_the_frozen_projections():
    """dx of ``GQAttention`` (q/v LoRA, base frozen) against JAX's with its
    ``stop_gradient`` on the kernel; detaching the frozen outputs instead
    (the PEFT bug) is far outside the tolerance."""
    x, mask = _gqa_case(4)
    j_attn = j_llm.GQAttention(num_heads=2, num_kv_heads=1, lora_rank=2, lora_freeze_base=True,
                               causal=True, dtype=jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(9)[None], (2, 9))
    bias = jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e30)
    params = _random_params(j_attn, jnp.asarray(x), pos, bias, seed=5)
    dy = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(np.float32)

    def j_out(xx):
        return jnp.sum(j_attn.apply({"params": params}, xx, pos, bias) * dy)

    j_dx = np.asarray(jax.jit(jax.grad(j_out))(jnp.asarray(x)))
    t_attn = t_llm.GQAttention(64, 2, 1, lora_rank=2, lora_freeze_base=True, dtype=torch.float32)
    load_flax_params(t_attn, params)
    assert not t_attn.q_proj.weight.requires_grad and not t_attn.v_proj.weight.requires_grad
    t_bias = torch.where(torch.as_tensor(mask)[:, None, None, :] > 0, 0.0, -1e30)

    def t_dx(project=None):
        xx = torch.as_tensor(x).requires_grad_()
        if project is not None:
            t_attn._project = project.__get__(t_attn)
        try:
            out = t_attn(xx, torch.arange(9)[None].expand(2, 9), t_bias)
        finally:
            t_attn.__dict__.pop("_project", None)
        (out * torch.as_tensor(dy)).sum().backward()
        return xx.grad.numpy()

    atol = 1e-5 * max(1.0, float(np.abs(j_dx).max()))
    np.testing.assert_allclose(t_dx(), j_dx, atol=atol, rtol=0)
    real = t_llm.GQAttention._project

    def detached(self, name, xx):
        out = real(self, name, xx)
        if name not in self.lora_targets:
            return out
        base = getattr(self, f"{name}_proj")(xx)
        return out - base + base.detach()

    assert np.abs(t_dx(detached) - j_dx).max() > 100 * atol


def test_bridge_carries_the_whole_training_tree(models):
    """``load_flax_params`` and ``export_flax_params`` over every leaf Pink
    trains or freezes: ``vision_proj``'s base and LoRA, ``output_adapter``,
    the q/v LoRA factors, ``lm_head``, bit for bit both ways."""
    _, params, t_model = models
    flat = flatten_flax(params)
    back = flatten_flax(export_flax_params(t_model))
    assert sorted(back) == sorted(flat)
    for path in ("vision_proj/base/kernel", "vision_proj/lora_a", "vision_proj/lora_b",
                 "output_adapter/base/bias", "output_adapter/lora_b",
                 "decoder/layer_1/attention/q_lora_a", "decoder/layer_1/attention/v_lora_b",
                 "lm_head/kernel", "token_embed/embedding"):
        assert path in flat, path
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


# ------------------------------------------------------------------ optimizer
def _frozen_list():
    return list(t_build_config(PINK_7B)["optimizer_attributes"]["frozen_params"])


def _trajectories(models, opt_cfg, tp, iters=6, seed=7):
    """Run optax (the JAX package's chain) and the port's optimizer over the
    same random gradients; returns per iteration (jax params, port params by
    flax path) and the port's state, optimizer and schedule."""
    _, params, t_model = models
    paths = flax_paths(t_model)
    j_tx, j_sched = j_build_optimizer(params, opt_cfg, tp)
    t_tx, t_sched = t_build_optimizer(paths, opt_cfg, tp)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = j_tx.init(j_params)
    j_update = jax.jit(j_tx.update)
    flat = flatten_flax(params)
    masters = {n: torch.from_numpy(np.array(to_torch_layout(p, flat[p]), np.float32))
               for n, p in paths.items()}
    trainable = {n: t for n, t in masters.items() if n not in t_tx.frozen}
    t_state = t_tx.init(trainable)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(iters):
        g_flat = {p: rng.standard_normal(v.shape).astype(np.float32) for p, v in flat.items()}
        nested = {}
        for p, v in g_flat.items():
            node = nested
            *scopes, leaf = p.split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = jnp.asarray(v)
        updates, j_state = j_update(nested, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_tx.update({n: torch.from_numpy(np.array(to_torch_layout(paths[n], g_flat[paths[n]])))
                     for n in trainable}, t_state, trainable)
        out.append((flatten_flax(jax.device_get(j_params)),
                    {paths[n]: t.clone() for n, t in masters.items()}))
    return out, t_state, t_tx, (j_sched, t_sched), paths


def _assert_same(step, j_flat, t_flat, paths):
    for path, value in t_flat.items():
        np.testing.assert_allclose(value.numpy(), to_torch_layout(path, j_flat[path]),
                                   atol=PARAM_ATOL, rtol=0, err_msg=f"iteration {step}: {path}")


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_frozen_params_and_accumulation_match_optax(models, accum):
    opt_cfg = {"type": "adam_w", "params": {"lr": 1e-2, "weight_decay": 0.01},
               "frozen_params": _frozen_list()}
    tp = {"clip_gradients": True, "max_grad_l2_norm": 1.0, "gradient_accumulation_steps": accum,
          "use_warmup": True, "warmup_iterations": 4, "warmup_factor": 0.2,
          "lr_steps": [5], "max_iterations": 6}
    traj, t_state, t_tx, (j_sched, t_sched), paths = _trajectories(models, opt_cfg, tp)
    frozen_paths = {paths[n] for n in t_tx.frozen}
    assert any("vision_tower" in p for p in frozen_paths) and \
        not any("lora" in p or p.startswith("vision_proj") for p in frozen_paths)
    before = flatten_flax(models[1])
    for i, (j_flat, t_flat) in enumerate(traj):
        _assert_same(i + 1, j_flat, t_flat, paths)
        for path in frozen_paths:  # frozen parameters never move
            np.testing.assert_array_equal(t_flat[path].numpy(),
                                          to_torch_layout(path, before[path]))
        previous = traj[i - 1][1] if i else None
        if accum > 1 and (i + 1) % accum and previous is not None:
            assert all(torch.equal(t_flat[p], previous[p]) for p in t_flat), i  # in between
    # the schedule the trainer logs, in trainer iterations, and the count
    for it in range(8):
        assert float(t_sched(it)) == pytest.approx(float(j_sched(it)), rel=1e-7)
    assert t_state["count"] == 6 // accum
    # no moment and no accumulator for a frozen parameter
    trainable = sorted(n for n in paths if n not in t_tx.frozen)
    assert sorted(t_state["mu"]) == sorted(t_state["nu"]) == trainable
    if accum > 1:
        assert sorted(t_state["acc"]) == trainable and t_state["mini_step"] == 6 % accum


def test_accumulation_is_the_mean_then_one_update(models):
    """k micro-gradients under MultiSteps give the update of their mean, and
    the accumulator is optax's running mean in fp32."""
    opt_cfg = {"type": "adam_w", "params": {"lr": 1e-2}}
    _, params, t_model = models
    paths = flax_paths(t_model)
    tx, _ = t_build_optimizer(paths, opt_cfg, {"gradient_accumulation_steps": 3})
    one, _ = t_build_optimizer(paths, opt_cfg, {})
    rng = np.random.default_rng(9)
    masters = {n: torch.from_numpy(rng.standard_normal(3).astype(np.float32)) for n in ("a",)}
    twin = {n: t.clone() for n, t in masters.items()}
    gs = [torch.from_numpy(rng.standard_normal(3).astype(np.float32)) for _ in range(3)]
    state, state1 = tx.init(masters), one.init(twin)
    for i, g in enumerate(gs[:2]):
        tx.update({"a": g}, state, masters)
        assert torch.equal(masters["a"], twin["a"]) and state["mini_step"] == i + 1
    mean = gs[0] + (gs[1] - gs[0]) / 2
    assert torch.equal(state["acc"]["a"], mean)
    tx.update({"a": gs[2]}, state, masters)
    one.update({"a": mean + (gs[2] - mean) / 3}, state1, twin)
    assert torch.equal(masters["a"], twin["a"]) and not state["acc"]["a"].any()


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_weight_decay_trap_on_the_frozen_base_kernels(models, weight_decay):
    """One update of the model's LM loss: JAX decays the q/v base kernels
    that ``lora_freeze_base`` stop-gradients (they stay in optax's tree), the
    port's ``TrainState`` leaves them, having frozen them at the weight."""
    j_model, params, _ = models
    t_model = TPink(**TINY)  # the state below writes its masters into the module
    load_flax_params(t_model, params)
    batch = _batch(1)
    lr = 1e-2
    opt_cfg = {"type": "adam_w", "params": {"lr": lr, "weight_decay": weight_decay}}
    _, j_grads = _jax_loss_and_grads(j_model, params, batch)
    j_tx, _ = j_build_optimizer(params, opt_cfg, {})
    nested = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = jax.jit(j_tx.update)(_nest({p: jnp.asarray(g) for p, g in j_grads.items()}),
                                      j_tx.init(nested), nested)
    j_after = flatten_flax(jax.device_get(optax.apply_updates(nested, updates)))
    paths = flax_paths(t_model)
    t_tx, _ = t_build_optimizer(paths, opt_cfg, {})
    state = TrainState.create(t_model, t_tx)
    assert "decoder.layer_0.attention.q_proj.weight" not in state.trainable
    # the same gradients on both sides: the trap is in the update, not the loss
    state.apply_gradients({n: torch.from_numpy(np.array(to_torch_layout(
        paths[n], j_grads[paths[n]]))) for n in state.trainable}, t_tx)
    flat = flatten_flax(params)
    for layer in range(2):
        for x in "qv":
            path = f"decoder/layer_{layer}/attention/{x}_proj/kernel"
            name = f"decoder.layer_{layer}.attention.{x}_proj.weight"
            np.testing.assert_array_equal(state.params[name].numpy(),
                                          to_torch_layout(path, flat[path]))
            moved = j_after[path] - flat[path]
            if weight_decay:
                np.testing.assert_allclose(moved, -lr * weight_decay * flat[path], atol=1e-7)
                assert np.abs(moved).max() > 1e-4
            else:
                assert not moved.any()
    # the trainable parameters agree all the same
    for name in state.trainable:
        np.testing.assert_allclose(state.params[name].numpy(),
                                   to_torch_layout(paths[name], j_after[paths[name]]),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
