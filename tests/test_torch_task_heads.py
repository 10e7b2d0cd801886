"""The UniVL task heads in the port against the JAX package, on the CPU.

* ``ClassifierLayer``, all five types (``logit``, ``mlp`` with 2 layers and
  a hidden width, ``weight_norm``, ``bert``, ``transformer_decoder`` over a
  2-D feature and over a sequence): logits and the gradient of every
  parameter and of the input, on seeded numpy parameters carried by
  ``load_flax_params``; ``export_flax_params`` gives every leaf back bit
  for bit (``weight``, ``scale`` and ``queries`` stay untransposed).
* ``univl_classification`` and ``univl_mcqa`` at the tiny presets, fp32:
  ``cls_loss``/``cls_acc`` and ``mcqa_loss``/``mcqa_acc`` and every
  parameter's gradient, on the port's seeded init exported to a flax tree
  with exactly the JAX model's paths, and carried both ways bit for bit;
  MCQA's B·O options go through the text tower in one call, its logit
  scale clamped at 100.
* The first ``video_mcqa`` batch equal to JAX's at atol 0 (frames, option
  ids and masks, targets).
* ``univl_auto``: every ``training_stage`` builds the model JAX builds,
  ``roi`` among them; an unknown stage is a ``KeyError``.

Tolerances (fp32 on both sides, sums in another order): logits, losses and
metrics at atol 1e-5, times the largest logit's magnitude where it passes 1
(MCQA's clamped scale of 100 gives logits near 50); a parameter's gradient within 1e-4 of its largest
JAX entry, floored at 1e-2 of the model's largest (exact zeros hold only
rounding).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.task_loader import TaskLoader as TTaskLoader
from antmmf_torch.models import univl as t_univl
from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules.classifier import ClassifierLayer as TClassifier
from antmmf_torch.trainers import build as _t_registrations  # noqa: F401
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.task_loader import TaskLoader as JTaskLoader
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.modules.classifier import ClassifierLayer as JClassifier
from antmmf_tpu.trainers import build as _j_registrations  # noqa: F401
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            embed_dim=32, dtype_str="float32")


def _grads_close(module, j_grads, what=""):
    flat = flatten_flax(jax.device_get(j_grads))
    paths = flax_paths(module)
    assert sorted(paths.values()) == sorted(flat), what
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in flat.values())
    bad = {}
    for name, p in module.named_parameters():
        ref = to_torch_layout(paths[name], flat[paths[name]])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        if float(np.abs(got - ref).max()) > GRAD_RTOL * max(float(np.abs(ref).max()), floor):
            bad[name] = float(np.abs(got - ref).max())
    assert not bad, (what, bad)


# ------------------------------------------------------------ classifiers
CLASSIFIERS = {
    "logit": dict(),
    "mlp": dict(hidden_dim=24, num_layers=2),
    "weight_norm": dict(),
    "bert": dict(),
    "transformer_decoder": dict(num_layers=2),
    "transformer_decoder_seq": dict(num_layers=1),
}


@pytest.mark.parametrize("kind", sorted(CLASSIFIERS))
def test_classifier_layer_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    ctype = kind.removesuffix("_seq")
    shape = (3, 5, 128) if kind.endswith("_seq") else (3, 128)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = JClassifier(ctype, 7, **CLASSIFIERS[kind])
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
                         + (1.0 if jax.tree_util.keystr(p).endswith("['scale']") else 0.0)),
        abstract)
    w = rng.standard_normal((3, 7)).astype(np.float32)

    def loss(params, x):
        logits = jm.apply({"params": params}, x)
        return (logits * w).sum(), logits

    (_, j_logits), (j_grads, j_dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, x)
    port = TClassifier(ctype, 128, 7, **CLASSIFIERS[kind])
    load_flax_params(port, params)
    tx = torch.tensor(x, requires_grad=True)
    logits = port(tx)
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, atol=ATOL, rtol=0)
    _grads_close(port, j_grads, kind)
    np.testing.assert_allclose(tx.grad.numpy(), j_dx, rtol=0,
                               atol=GRAD_RTOL * float(np.abs(j_dx).max()))
    back = flatten_flax(export_flax_params(port))
    flat = flatten_flax(jax.device_get(params))
    assert sorted(back) == sorted(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(back[path], value, path)
    raw = {"weight_norm": {"weight", "scale"}, "transformer_decoder": {"queries"}}.get(ctype, set())
    assert raw <= {p.split("/")[-1] for p in flat}


def test_classifier_refusals():
    with pytest.raises(ValueError, match="Unknown classifier type"):
        TClassifier("hierarchical", 8, 2)
    # dropout is ported: the bert head drops its input at the given rate
    assert TClassifier("bert", 8, 2, dropout=0.1).dropout.rate == 0.1


# ------------------------------------------------------------ the models
def _cls_batch(B=4, F=2, L=12, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([L, 7, 4, 9][:B])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, F, 32, 32, 3)).astype(np.float32),
            "video_mask": np.ones((B, F), np.int64),
            "caption_input_ids": rng.integers(1, 30522, (B, L)) * mask,
            "caption_input_mask": mask, "caption_segment_ids": np.zeros((B, L), np.int64),
            "targets": np.array([0, 3, 1, 3][:B])}


def _mcqa_batch(B=3, O=5, F=2, L=10, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, L + 1, (B, O))
    mask = (np.arange(L)[None, None] < lens[..., None]).astype(np.int64)
    return {"image_data": rng.standard_normal((B, F, 32, 32, 3)).astype(np.float32),
            "video_mask": np.ones((B, F), np.int64),
            "options_input_ids": rng.integers(1, 30522, (B, O, L)) * mask,
            "options_input_mask": mask, "targets": np.array([0, 4, 2][:B])}


MODELS = {"univl_classification": ({**TINY, "num_labels": 4}, _cls_batch,
                                   ["losses/cls_loss", "metrics/cls_acc", "total_loss"]),
          # a logit scale of e^5 > 100: the clamp is live on both sides
          "univl_mcqa": ({**TINY, "init_logit_scale": 5.0}, _mcqa_batch,
                         ["losses/mcqa_loss", "metrics/mcqa_acc", "total_loss"])}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_task_model_losses_metrics_and_gradients_match_jax(name, monkeypatch):
    attrs, make_batch, keys = MODELS[name]
    config = {"model_attributes": {name: attrs}}
    batch = make_batch()
    shell = t_build(config, device="cpu")
    shell.init(3)
    params = export_flax_params(shell.module)
    j_shell = j_build(config)
    abstract = jax.eval_shape(j_shell.init, jax.random.PRNGKey(0), batch)["params"]
    assert sorted(flatten_flax(params)) == sorted(flatten_flax(abstract))

    def loss_of(params):
        total, (out, scalars) = j_shell.loss_fn({"params": params}, batch, deterministic=True)
        return total, (out["logits"], scalars)

    (_, (j_logits, j_scalars)), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params)
    calls = []
    text = shell.module.base.text_encoder
    real = text.forward
    monkeypatch.setattr(text, "forward", lambda ids, *a: calls.append(ids.shape) or real(ids, *a))
    total, (out, scalars) = shell.loss_fn(batch, deterministic=True)
    total.backward()
    assert sorted(scalars) == keys
    for key in keys:
        np.testing.assert_allclose(float(scalars[key]), float(j_scalars[key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["logits"].detach().numpy(), j_logits, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(j_logits).max())))
    assert out["logits"].dtype == torch.float32
    _grads_close(shell.module, j_grads, name)
    fresh = t_build(config, device="cpu").module  # the bridge both ways, bit for bit
    load_flax_params(fresh, params)
    back = flatten_flax(export_flax_params(fresh))
    for path, value in flatten_flax(params).items():
        np.testing.assert_array_equal(back[path], value, path)
    rows = batch["targets"].shape[0] * (5 if name == "univl_mcqa" else 1)
    assert [tuple(c) for c in calls] == [(rows, batch.get(
        "options_input_ids", batch.get("caption_input_ids")).shape[-1])]


@pytest.fixture(scope="module")
def mcqa_config(tmp_path_factory):
    cfg = {"includes": [os.path.join(REPO, "projects/base_vtp/configs/video_retrieval.local.yml")],
           "task_attributes": {"univl_task": {"datasets": ["video_mcqa"], "dataset_attributes": {
               "video_mcqa": {"data_root_dir": "tests/data/video",
                              "annotations": {"train": "msrvtt_multi_choice_qa.jsonl"},
                              "video_root": "data/mp4", "frames_per_clip": 2,
                              "image": {"size": 64, "resize": 72, "norm_preset": "clip"}}}}},
           "training_parameters": {"num_workers": 0, "batch_size": 2, "test_batch_size": 2}}
    path = tmp_path_factory.mktemp("mcqa") / "mcqa.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("dataset_type", ["train", "val"])
def test_first_mcqa_batch_matches_jax(mcqa_config, dataset_type):
    def first(loader_cls, config):
        loader = loader_cls(config)
        loader.load_task([dataset_type])
        loader.make_dataloaders()
        loader.seed_sampler(dataset_type, 0)
        return next(iter(loader.get_loaders(dataset_type)[0]))

    j = first(JTaskLoader, j_build_config(mcqa_config))
    t = first(TTaskLoader, t_build_config(mcqa_config))
    assert sorted(t.arrays()) == sorted(j.arrays()) == [
        "image_data", "options_input_ids", "options_input_mask", "targets", "video_mask"]
    for key, ref in j.arrays().items():
        assert t[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(t[key], ref, err_msg=key)
    assert t["options_input_ids"].shape == (2, 5, 30)


# ------------------------------------------------------------ univl_auto
@pytest.mark.parametrize("stage,name", sorted(t_univl.STAGES.items()))
def test_univl_auto_dispatches_every_stage(stage, name):
    config = {"model_attributes": {"univl_auto": {**TINY, "training_stage": stage}}}
    module = t_build(config, device="cpu").module
    j_module = j_build(config).module
    assert type(module).__name__ == type(j_module).__name__
    from antmmf_torch.common.registry import registry
    assert type(module) is registry.get_model_class(name)


def test_univl_auto_refuses_an_unknown_stage():
    config = {"model_attributes": {"univl_auto": {**TINY, "training_stage": "ranking"}}}
    with pytest.raises(KeyError, match="ranking"):
        j_build(config)
    with pytest.raises(KeyError, match="ranking"):
        t_build(config, device="cpu")


def test_task_models_refuse_dropout():
    """Dropout is ported: each task model builds at 0.1 and its ViT takes
    the rate; the classification head, which JAX builds without one, keeps
    0."""
    from antmmf_torch.modules.layers import Dropout

    for name in ("univl_classification", "univl_mcqa", "univl_caption"):
        module = t_build({"model_attributes": {name: {**TINY, "dropout": 0.1}}},
                         device="cpu").module
        vit = module.base.img_encoder
        assert {m.rate for m in vit.modules() if isinstance(m, Dropout)} == {0.1}, name
        if name == "univl_classification":
            assert module.cls_head.dropout.rate == 0.0
