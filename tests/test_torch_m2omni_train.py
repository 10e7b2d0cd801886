"""M2-omni training in the port against the JAX package, on the CPU.

``M2Omni`` at ``omni_tiny_test`` (hidden 64, 2 layers, 2 heads of 32, 1 kv
head), fp32, on ``tests/test_torch_m2omni.py``'s tiny rows (labels over
the text, padding ignored) with JAX parameters drawn with numpy from the
init's shapes (every LoRA ``b`` live) and carried by the weight bridge.
Tolerances:

* the loss and every gradient under autograd against
  ``jax.jit(jax.value_and_grad)`` of ``M2Omni.apply``, in the spliced
  layout with the ViT and SANM (1D RoPE, LoRA on q and v) and in the
  prefix layout with Qwen2-ViT and SANM (LoRA on the decoder's seven
  projections and on the tower's blocks, ``mlp_depths`` 2); and, in the
  recipe's update test below, the spliced layout with Qwen2-ViT and the
  conv tower under remat and ``scan_layers`` (every trainable gradient of
  the first micro-step): the loss at rtol 1e-5,
  each leaf's gradient within 1e-4 of its largest JAX entry (floored at
  1e-6 of the tree's largest), the gradients carried back through the
  bridge, so the LoRA leaves and the stacked ``decoder/layers`` are read
  under their flax paths; a base the adapters freeze has no gradient in
  the port and a zero one in JAX;
* the chunked LM loss: ``_lm_loss_chunked`` at chunks of 16, 7 and 64
  equal to ``_lm_loss`` of the whole logits, the loss at rtol 1e-6 (as
  ``tests/test_chunked_lm_loss.py`` pins JAX's) and the gradient of the
  hidden states at 1e-5 of its largest entry (the slices' products are
  blocked differently from the whole one's); the bytes
  saved for the backward (counted by ``saved_tensors_hooks``) the same at
  every chunk and no more than the slices' inputs (hidden states and
  labels), below one 16-position slice's fp32 logits: no slice's logits or log-softmax
  are kept, they are recomputed in the backward;
* remat on and off: the same loss and gradients bit for bit;
* ``recipe_opts`` over ``m2_omni_7b.yml`` at the tiny presets (with the
  gradient check above): the
  optimizer ``build_optimizer`` makes from it (AdamW at lr 2e-5 with a bf16
  first moment, ``MultiSteps`` over 2 micro-batches, ``frozen_params``
  leaving the adapters, ``vision_proj`` and ``audio_proj``: the bench
  leg's trainable set) through ``make_train_step``, two updates (four
  micro-steps) against the JAX package's optax chain on the same config:
  each micro-step's loss at atol 1e-5, every master at atol 1e-6 after
  each micro-step, the frozen ones unchanged in both.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from antmmf_torch.common.build import build_config
from antmmf_torch.models.base_model import build_model
from antmmf_torch.models.m2_omni import AUDIO_FEATURES, LORA_TRAINABLE, M2Omni as TM, \
    recipe_opts
from antmmf_torch.optimizer.build import build_optimizer
from antmmf_torch.predictors.m2_omni_serving import M2_OMNI_7B
from antmmf_torch.trainers.train_state import TrainState, make_train_step
from antmmf_torch.utils.weights import export_flax_params, flatten_flax, flax_paths, \
    flax_to_masters
from antmmf_tpu.models.m2_omni import M2Omni as JM
from antmmf_tpu.optimizer.build import build_optimizer as j_build_optimizer
from test_torch_m2omni import QWEN2, SANM, SPLICE, TINY, VIT, case_batch, jax_batch, \
    torch_batch, torch_model
from test_torch_qwen2_vit import random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-6
STEP_LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-6
# with the recipe's case (Qwen2-ViT and the conv tower, spliced, LoRA on all
# seven projections and the tower, remat, scan_layers: the update test)
# each tower kind and both layouts are held
CASES = {
    "vit_sanm_spliced_rope_1d_lora_qv": {**VIT, **SANM, **SPLICE, "rope_3d": False,
                                         "llm_lora_rank": 2},
    "qwen2_sanm_prefix_mlp2_lora_all_vit_lora": {
        **QWEN2, **SANM, "mlp_depths": 2, "llm_lora_rank": 2, "llm_lora_targets": "all",
        "vit_lora_rank": 2},
}


def port_grads(model) -> dict:
    """The parameters' gradients (zero where there is none) as the flat flax
    tree the bridge exports."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return flatten_flax(export_flax_params(twin))


def assert_grads_close(got: dict, ref: dict, paths=None):
    """Each leaf of ``ref`` (of ``paths`` only, when given) against ``got``."""
    ref = flatten_flax(jax.device_get(ref))
    assert set(got) == set(ref)
    floor = GRAD_FLOOR * max(float(np.abs(v).max()) for v in ref.values())
    for path, r in ref.items():
        if paths is not None and path not in paths:
            continue
        tol = max(GRAD_RTOL * float(np.abs(r).max()), floor)
        np.testing.assert_allclose(got[path], r, atol=tol, rtol=0, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax(case):
    kw = CASES[case]
    batch = case_batch(kw)
    jm = JM(**TINY, **kw)
    params = random_params(jm, jax_batch(batch), seed=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply({"params": p}, b)["losses"]["lm_loss"]))(params, jax_batch(batch))
    tm = torch_model(kw, params)
    out = tm(torch_batch(batch), deterministic=False)
    out["losses"]["lm_loss"].backward()
    np.testing.assert_allclose(float(out["losses"]["lm_loss"]), float(loss), rtol=LOSS_RTOL)
    assert_grads_close(port_grads(tm), grads)
    # a base the adapters freeze: no gradient in the port, zero in JAX
    paths = flax_paths(tm)
    ref = flatten_flax(jax.device_get(grads))
    bases = [n for n, p in tm.named_parameters() if not p.requires_grad]
    assert bool(bases) == bool(kw.get("llm_lora_rank") or kw.get("vit_lora_rank"))
    for n in bases:
        assert dict(tm.named_parameters())[n].grad is None
        if paths[n] in ref:  # stacked layers are checked through the export above
            assert not np.any(ref[paths[n]]), paths[n]


def _saved_bytes(fn):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def test_chunked_loss_recomputes_each_slice():
    torch.manual_seed(0)
    model = TM(**TINY, device="cpu")
    B, L, V = 2, 130, model.vocab_size
    hidden = torch.randn(B, L, model.hidden)
    labels = torch.randint(0, V, (B, L))
    labels[0, 100:] = -100  # padding
    labels[1, :7] = -100  # the prompt
    h = hidden.clone().requires_grad_()
    ref = model._lm_loss(model.lm_head(h).float(), labels)
    ref["losses"]["lm_loss"].backward()
    ref_grad = h.grad.clone()
    inputs = hidden.numel() * hidden.element_size() + labels.numel() * labels.element_size()
    saved = []
    for chunk in (16, 7, 64):
        h = hidden.clone().requires_grad_()
        out, nbytes = _saved_bytes(lambda: model._lm_loss_chunked(h, labels, chunk=chunk))
        out["losses"]["lm_loss"].backward()
        np.testing.assert_allclose(float(out["losses"]["lm_loss"]),
                                   float(ref["losses"]["lm_loss"]), rtol=1e-6)
        assert float(out["metrics"]["lm_acc"]) == float(ref["metrics"]["lm_acc"])
        np.testing.assert_allclose(h.grad.numpy(), ref_grad.numpy(),
                                   atol=1e-5 * float(ref_grad.abs().max()), rtol=0)
        saved.append(nbytes)
    # each slice keeps only its inputs (the hidden states and labels it
    # reads); one 16-position slice's fp32 logits alone are B·16·V·4 bytes
    assert len(set(saved)) == 1 and saved[0] <= inputs < B * 16 * V * 4, (saved, inputs)


def recipe_batch(seed):
    """Two right-padded rows, each with a run of 6 image slots (one 16×24
    image through Qwen2-ViT: a 2×3 merged grid) and 4 audio slots (16 fbank
    frames through the conv tower): one visual stream, as a trainer's batch
    holds it."""
    rng = np.random.default_rng(seed)
    ids = np.array([[5] + [3] * 6 + [6] + [4] * 4 + [7, 8, 0],
                    [9] + [3] * 6 + [10, 11] + [4] * 4 + [12, 13]])
    mask = (ids != 0).astype(np.int64)
    return {"input_ids": ids, "input_mask": mask, "labels": np.where(mask > 0, ids, -1),
            "image_data": rng.standard_normal((2, 16, 24, 3)).astype(np.float32),
            "audio": rng.standard_normal((2, 16, AUDIO_FEATURES)).astype(np.float32)}


def _recipe_config(**model):
    attrs = dict(lm_preset="omni_tiny_test", qwen2_preset="qwen2_vit_tiny_test",
                 audio_hidden=32, dtype_str="float32", image_token_id=3, audio_token_id=4,
                 **model)
    return build_config(M2_OMNI_7B, opts=recipe_opts(**attrs))


def test_remat_gives_the_same_loss_and_gradients():
    batch = torch_batch(recipe_batch(0))
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        shell = build_model(_recipe_config(remat=str(remat).lower()), device="cpu")
        shell.init(3)
        module = shell.module
        assert module.decoder.remat == remat and module.vision_tower.remat == remat
        loss = module(batch, deterministic=False)["losses"]["lm_loss"]
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in module.named_parameters()
                                     if p.grad is not None}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1) and set(g0) == set(g1) and g0
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_recipe_updates_match_optax_step_for_step():
    cfg = _recipe_config()
    attrs = cfg["model_attributes"]["m2_omni"].to_dict()
    assert attrs["llm_lora_rank"] == attrs["vit_lora_rank"] == 8 and attrs["remat"]
    assert attrs["llm_lora_targets"] == "all" and attrs["scan_layers"]
    jm = JM(**{k: v for k, v in attrs.items() if k in {f.name for f in dataclasses.fields(JM)}})
    batches = [recipe_batch(s) for s in (0, 1)]
    params = random_params(jm, jax_batch(batches[0]), seed=3)
    opt_cfg = cfg["optimizer_attributes"].to_dict()
    tp = cfg["training_parameters"].to_dict()
    assert tp["gradient_accumulation_steps"] == 2 and opt_cfg["params"]["mu_dtype"] == "bfloat16"
    # the port: build_optimizer from the config, make_train_step
    shell = build_model(cfg, device="cpu")
    paths = flax_paths(shell.module)
    tx, _ = build_optimizer(paths, opt_cfg, tp)
    state = TrainState.create(shell.module, tx, flax_to_masters(shell.module, params))
    step = make_train_step(shell, tx)
    trainable = {paths[n] for n in state.trainable}
    # the bench leg's trainable set (bench_llm_train.py's m2omni leg)
    assert trainable == {p for p in paths.values() if any(t in p for t in LORA_TRAINABLE)}
    assert any("vision_tower" in p and "lora" in p for p in trainable)
    # JAX: the package's optax chain on the same config, value_and_grad of the loss
    j_tx, _ = j_build_optimizer(params, opt_cfg, tp)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = j_tx.init(j_params)
    j_vg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.apply({"params": p}, b)["losses"]["lm_loss"]))
    j_update = jax.jit(j_tx.update)
    before = {n: t.clone() for n, t in state.params.items()}
    # the first micro-step's loss and trainable gradients, before any update
    loss, grads = j_vg(j_params, jax_batch(batches[0]))
    first, _ = shell.loss_fn(batches[0], deterministic=False)
    first.backward()
    np.testing.assert_allclose(float(first), float(loss), rtol=LOSS_RTOL)
    assert_grads_close(port_grads(shell.module), grads, trainable)
    for p in shell.module.parameters():
        p.grad = None
    for i in range(4):  # two updates of two micro-batches
        b = batches[i % 2]
        if i:
            loss, grads = j_vg(j_params, jax_batch(b))
        updates, j_state = j_update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        state, scalars = step(state, b)
        np.testing.assert_allclose(float(scalars["total_loss"]), float(loss),
                                   atol=STEP_LOSS_ATOL, rtol=0, err_msg=f"micro-step {i}")
        j_flat = flatten_flax(jax.device_get(j_params))
        masters = flatten_flax(export_flax_params(_with(shell.module, state.params)))
        for path, value in masters.items():
            np.testing.assert_allclose(value, j_flat[path], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"micro-step {i}: {path}")
    moved = {paths[n] for n, t in state.params.items() if not torch.equal(t, before[n])}
    assert moved == trainable
    assert state.opt_state["count"] == 2 and state.opt_state["mini_step"] == 0


def _with(module, masters):
    """A copy of ``module`` holding the fp32 ``masters`` (by name)."""
    twin = copy.deepcopy(module)
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(masters[n])
    return twin
