"""``pink_7b.yml``'s branches of the port against the JAX package, on the CPU.

The recipe's model (the EVA tower, remat, the ``scan_layers`` layout, LoRA
16 on q/v over a frozen base) at the tiny presets (``omni_tiny_test``:
hidden 64, 2 layers, 2 heads of 32, 1 kv head; ``eva_tiny_test`` at 28²),
fp32, weights drawn with numpy into both packages (so every ``lora_b``,
adapter and norm scale is live). Tolerances:

* the decoder's branches (``SerialAdapter`` with and without SiLU, after
  the attention norm and with ``adapter_mlp`` after the MLP norm; LoRA on
  q, k, v and o with ``lora_mlp``): the output at atol 1e-4 (hidden states
  of spread 1 to 10 after two fp32 layers, as ``test_torch_pink_decode.py``
  holds the decoder), every gradient
  (the input's too) at atol 1e-4 of its largest magnitude; a projection the
  port freezes gets no gradient, JAX's ``stop_gradient`` a zero one;
* ``PinkModel`` in both ``adapter_style``s: the LM loss at atol 1e-5, every
  trainable gradient as above; remat off gives the same loss and gradients
  bit for bit;
* the bridge: a stacked ``decoder/layers`` tree into the port, each
  layer's leaves equal to ``unstack_decoder_layers``'s; the port's export
  equal to the JAX tree bit for bit, and run by JAX to the same logits;
  a stacked ``params.npz`` loads;
* greedy ``generate``: the tokens equal to JAX's, cached and re-encoded;
* the composed config (``pink_instruct.local.yml`` with ``pink_7b.yml``'s
  model and optimizer laid over by ``recipe_opts``, then the tiny presets)
  through ``antmmf_torch.run`` against one JAX ``BaseTrainer`` run, step for
  step as ``test_torch_pink_trainer.py`` holds it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.checkpoint import load_weights
from antmmf_torch.models.pink import PinkModel as TPink, recipe_opts
from antmmf_torch.modules import llm as t_llm
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
    unstack_layers,
)
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.modules import llm as j_llm
from test_torch_pink_trainer import check_step_for_step, trainer_runs
from test_torch_task_trainer import one_torch_thread  # noqa: F401

OUT_ATOL, LOSS_ATOL, GRAD_RTOL = 1e-4, 1e-5, 1e-4
SIZE = 28
TINY_7B = dict(lm_preset="omni_tiny_test", eva_preset="eva_tiny_test", image_size=SIZE,
               dtype_str="float32")
MODEL = dict(visual_tower="eva", lora_rank=2, remat=True, scan_layers=True, **TINY_7B)


def _random_params(module, *args, seed=0):
    params = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else noise

    return jax.device_get(jax.tree_util.tree_map_with_path(draw, params))


def _check_grads(t_grads, j_grads, paths, frozen):
    j_grads = unstack_layers(j_grads)  # a scanned decoder's gradients, layer by layer
    assert set(paths.values()) == set(j_grads)
    for name, grad in t_grads.items():
        ref = to_torch_layout(paths[name], j_grads[paths[name]])
        if name in frozen:
            assert grad is None and not np.any(ref), name
            continue
        atol = GRAD_RTOL * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(grad.numpy(), ref, atol=atol, rtol=0, err_msg=name)
        assert np.abs(ref).max() > 0, name


DECODER_CASES = {
    "adapter": dict(adapter_dim=8),
    "adapter_silu_mlp": dict(adapter_dim=8, adapter_non_linear=True, adapter_mlp=True),
    "lora_qkvo_mlp": dict(lora_rank=2, lora_targets=("q", "k", "v", "o"), lora_mlp=True),
}


@pytest.mark.parametrize("case", list(DECODER_CASES))
def test_decoder_branches_match_jax(case):
    kw = DECODER_CASES[case]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).copy()
    dy = rng.standard_normal((2, 9, 64)).astype(np.float32)
    j_dec = j_llm.DecoderLM(num_layers=2, num_heads=2, num_kv_heads=1, dtype=jnp.float32, **kw)
    params = _random_params(j_dec, jnp.asarray(x), pos, mask, seed=5)

    def j_obj(p, xx):
        out = j_dec.apply({"params": p}, xx, pos, mask)
        return jnp.sum(out * dy), out

    (_, j_out), (j_grads, j_dx) = jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    t_dec = t_llm.DecoderLM(64, 2, 2, 1, dtype=torch.float32, **kw)
    load_flax_params(t_dec, params)
    xx = torch.as_tensor(x).requires_grad_()
    out = t_dec(xx, torch.as_tensor(pos), torch.as_tensor(mask))
    (out * torch.as_tensor(dy)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=OUT_ATOL, rtol=0)
    j_dx = np.asarray(j_dx)
    np.testing.assert_allclose(xx.grad.numpy(), j_dx, atol=GRAD_RTOL * np.abs(j_dx).max(), rtol=0)
    frozen = {n for n, p in t_dec.named_parameters() if not p.requires_grad}
    if "lora_rank" in kw:  # all seven base projections of each layer
        assert len(frozen) == 2 * 7 and all(n.endswith("_proj.weight") for n in frozen)
    else:
        assert not frozen and "layer_1.adapter_attn.down.bias" in dict(t_dec.named_parameters())
    _check_grads({n: p.grad for n, p in t_dec.named_parameters()},
                 flatten_flax(jax.device_get(j_grads)), flax_paths(t_dec), frozen)


def _batch(seed, B=2, Lt=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (B, Lt))
    mask = (np.arange(Lt)[None] < np.array([Lt, Lt - 3])[:B, None]).astype(np.int64)
    labels = np.where(mask > 0, ids, -100)
    labels[:, :3] = -100
    return {"input_ids": ids * mask, "input_mask": mask, "labels": labels,
            "image_data": rng.standard_normal((B, 1, SIZE, SIZE, 3)).astype(np.float32)}


STYLES = {"lora": {}, "pink": dict(adapter_style="pink", adapter_mlp=True,
                                  adapter_non_linear=True)}


@pytest.fixture(scope="module")
def pinks():
    batch = _batch(0)
    out = {}
    for style, kw in STYLES.items():
        j_model = JPink(**MODEL, **kw)
        params = _random_params(j_model, {k: jnp.asarray(v) for k, v in batch.items()}, seed=6)
        t_model = TPink(**MODEL, **kw)
        load_flax_params(t_model, params)
        out[style] = (j_model, params, t_model)
    return out


def _port_loss_and_grads(t_model, batch):
    for p in t_model.parameters():
        p.grad = None
    loss = t_model({k: torch.as_tensor(v) for k, v in batch.items()})["losses"]["lm_loss"]
    loss.backward()
    return loss.item(), {n: p.grad for n, p in t_model.named_parameters()}


@pytest.mark.parametrize("style", list(STYLES))
def test_pink_loss_and_trainable_gradients_match_jax(pinks, style):
    j_model, params, t_model = pinks[style]
    batch = _batch(1)

    def loss_of(p):
        return j_model.apply({"params": p}, {k: jnp.asarray(v) for k, v in batch.items()},
                             deterministic=False)["losses"]["lm_loss"]

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_of))(params)
    t_loss, t_grads = _port_loss_and_grads(t_model, batch)
    assert abs(t_loss - float(j_loss)) <= LOSS_ATOL and t_loss > 1.0
    assert t_model.num_vision_tokens(batch) == j_model.num_vision_tokens(batch) == 4
    frozen = {n for n, p in t_model.named_parameters() if not p.requires_grad}
    if style == "lora":
        assert frozen == {f"decoder.layer_{i}.attention.{x}_proj.weight" for i in range(2)
                          for x in "qv"} | {"output_adapter.base.weight",
                                            "output_adapter.base.bias"}
    else:  # no decoder LoRA, a plain vision_proj, no output adapter
        assert not frozen and t_model.output_adapter is None
        assert isinstance(t_model.vision_proj, torch.nn.Linear)
        assert not any("lora" in n for n in t_grads)
    _check_grads(t_grads, flatten_flax(jax.device_get(j_grads)), flax_paths(t_model), frozen)


@pytest.mark.parametrize("style", list(STYLES))
def test_remat_off_gives_the_same_loss_and_gradients(pinks, style):
    _, _, t_model = pinks[style]
    batch = _batch(2)
    runs = []
    for remat in (True, False):
        t_model.decoder.remat = t_model.vision_tower.remat = remat
        runs.append(_port_loss_and_grads(t_model, batch))
    t_model.decoder.remat = t_model.vision_tower.remat = True
    (loss_on, on), (loss_off, off) = runs
    assert loss_on == loss_off
    for name, grad in on.items():
        assert (grad is None and off[name] is None) or torch.equal(grad, off[name]), name


def test_the_bridge_reads_and_writes_the_stacked_layout(pinks, tmp_path):
    j_model, params, t_model = pinks["lora"]
    assert "layers" in params["decoder"] and "layer_0" not in params["decoder"]
    per_layer = flatten_flax(j_llm.unstack_decoder_layers(params["decoder"]))
    paths = flax_paths(t_model)
    named = dict(t_model.named_parameters())
    seen = 0
    for name, path in paths.items():
        if path.startswith("decoder/layer_"):  # each layer's leaf is its own slice
            want = to_torch_layout(path, per_layer[path[len("decoder/"):]])
            np.testing.assert_array_equal(named[name].detach().numpy(), want, err_msg=name)
            seen += 1
    assert seen == sum(p.startswith("layer_") for p in per_layer) and "layer_1" in str(per_layer)
    exported = export_flax_params(t_model)
    assert jax.tree_util.tree_structure(exported) == jax.tree_util.tree_structure(params)
    for path, leaf in flatten_flax(params).items():
        np.testing.assert_array_equal(flatten_flax(exported)[path], leaf, err_msg=path)
    assert "layer_0" in export_flax_params(t_model, stacked=False)["decoder"]
    batch = {k: jnp.asarray(v) for k, v in _batch(3).items()}  # JAX runs the port's export
    logits = jax.jit(lambda p, b: j_model.apply({"params": p}, b)["logits"])
    np.testing.assert_array_equal(np.asarray(logits(exported, batch)),
                                  np.asarray(logits(params, batch)))
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_flax(params))
    fresh = TPink(**MODEL)
    load_weights(fresh, npz)
    for name, t in fresh.named_parameters():
        assert torch.equal(t, named[name]), name


def test_greedy_generate_matches_jax(pinks):
    j_model, params, t_model = pinks["lora"]
    batch = _batch(4)
    batch = {"input_ids": batch["input_ids"], "input_mask": batch["input_mask"],
             "image_data": batch["image_data"][:, 0]}
    want, want_lens = j_model.generate({"params": params}, batch, eos_id=1, max_length=5)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    got, lens = t_model.generate(tb, eos_id=1, max_length=5)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again, _ = t_model.generate(tb, eos_id=1, max_length=5, use_cache=False)
    np.testing.assert_array_equal(again.numpy(), np.asarray(want))


DATA = "task_attributes.pink_task.dataset_attributes.pink_instruct"
COMPOSED = recipe_opts(**TINY_7B) + [f"{DATA}.image.size", str(SIZE),
                                     f"{DATA}.image.resize", "32"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trainer_runs(tmp_path_factory, *COMPOSED)


def test_composed_config_trains_step_for_step_with_jax(runs):
    check_step_for_step(runs)
    state = runs["port"].state
    module = runs["port"].shell.module
    assert module.decoder.scan_layers and module.decoder.remat and module.vision_tower.remat
    assert type(module.vision_tower).__name__ == "EvaVisionTransformer"
    # pink_7b.yml's frozen_params leave the LoRA adapters and vision_proj
    assert sorted(state.trainable) == sorted(
        n for n in state.params if n.endswith(("lora_a", "lora_b"))
        and not n.startswith("output_adapter.base") or n.startswith("vision_proj."))
    assert os.path.exists(runs["npz"])
