"""UniVL ROI document pretraining in the port against the JAX package, on the CPU.

* ``ImageFeatureEncoder``: ``identity``, ``projection`` and
  ``spatial_projection`` with 4- and 5-wide boxes (the spatial kernel is
  [box width + 1, C], [6, C] for ``RegionProcessor``'s boxes): output and
  the gradient of every parameter and of the inputs; its dropout is off in
  evaluation on both sides.
* ``LayoutEmbeddings`` over boxes whose corners and extents leave [0, 1023]
  on both sides (a negative width, coordinates past 1023), and BERT's
  embeddings with the additive ``extra`` summed before the LayerNorm.
* ``MRCHead``: logits, the KL loss and ``mrc_acc``, every gradient; a
  batch without a masked region scores 0 and 0; argmax ties go to the
  first index on both sides.
* ``univl_roi`` at the tiny presets, fp32: every loss term, metric and
  ``total_loss`` and the gradient of every parameter in four settings:
  regions only; regions and OCR with boxes; regions, OCR and the grid
  stream (2 frames, one padded); OCR without boxes (the layout tables get
  no gradient on either side). Ragged captions, padded regions, ragged
  OCR with one empty row. The weights are the port's seeded init exported
  to a flax tree that must have exactly the JAX model's paths and shapes
  (without the grid stream, no ViT), carried back bit for bit.
* ``univl_auto``'s ``roi`` stage builds ``univl_roi`` on both sides.

Tolerances (fp32 on both sides, sums in another order): outputs, losses
and metrics at atol 1e-5; a parameter's gradient within 1e-4 of its
largest JAX entry, floored at 1e-3 of the model's largest (exact zeros
hold only rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.models.layoutlm import LayoutEmbeddings as TLayout
from antmmf_torch.modules.encoders.image_feature_encoder import ImageFeatureEncoder as TEncoder
from antmmf_torch.modules.encoders.text_encoder import BertEncoder as TBert
from antmmf_torch.modules.transformers.heads.mrc import MRCHead as TMRC
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.models.layoutlm import LayoutEmbeddings as JLayout
from antmmf_tpu.modules.encoders.image_feature_encoder import ImageFeatureEncoder as JEncoder
from antmmf_tpu.modules.encoders.text_encoder import BertEncoder as JBert
from antmmf_tpu.modules.transformers.heads.mrc import MRCHead as JMRC
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-3
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            embed_dim=32, cross_layers=1, region_dim=16, region_classes=4, with_mrc=True,
            dtype_str="float32")
B, R, LT, LO, FRAMES = 3, 5, 12, 10, 2
# (grid stream, fields of the batch)
SETTINGS = {
    "regions": (False, ("regions",)),
    "regions_ocr": (False, ("regions", "ocr", "boxes")),
    "regions_ocr_grid": (True, ("regions", "ocr", "boxes", "grid")),
    "ocr_without_boxes": (False, ("regions", "ocr")),
}
LAYOUT = "ocr_layout_embeddings"


def _allclose(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0,
                               err_msg=what)


def _grad_close(t_grads, j_flat, paths, what=""):
    """Each port gradient (None: none reached it) against JAX's by flax path."""
    ref = {n: to_torch_layout(p, j_flat[p]) for n, p in paths.items()}
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in ref.values())
    bad = {}
    for n, g in ref.items():
        got = np.zeros_like(g) if t_grads[n] is None else t_grads[n].numpy()
        err = float(np.abs(got - g).max())
        if err > GRAD_RTOL * max(float(np.abs(g).max()), floor):
            bad[n] = err
    assert not bad, f"{what}: {bad}"
    return ref


# ------------------------------------------------------------------ encoder
@pytest.mark.parametrize("kind,box_dim", [("identity", 4), ("projection", 4),
                                          ("spatial_projection", 4),
                                          ("spatial_projection", 5)])
def test_image_feature_encoder_matches_jax(kind, box_dim):
    rng = np.random.default_rng(box_dim)
    feats = rng.standard_normal((2, 4, 16)).astype(np.float32)
    xy = rng.uniform(0, 0.5, (2, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 0.5, (2, 4, 2))], -1)
    if box_dim == 5:
        boxes = np.concatenate([boxes, rng.uniform(size=(2, 4, 1))], -1)
    boxes = boxes.astype(np.float32)
    j_enc = JEncoder(encoder_type=kind, out_dim=8)
    variables = jax.jit(j_enc.init)(jax.random.PRNGKey(0), feats, boxes)
    t_enc = TEncoder(kind, 16, 8, box_dim)
    if kind != "identity":
        load_flax_params(t_enc, variables["params"])
        assert (flatten_flax(variables["params"]).get("spatial_proj/kernel", np.zeros(
            (box_dim + 1, 8))).shape == (box_dim + 1, 8))

    def j_loss(params, f, b):
        out = j_enc.apply({"params": params}, f, b, deterministic=True)
        return (out * jnp.arange(out.size).reshape(out.shape)).sum() / out.size, out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        variables.get("params", {}), feats, boxes)
    f, b = torch.tensor(feats, requires_grad=True), torch.tensor(boxes, requires_grad=True)
    t_out = t_enc(f, b, deterministic=True)
    assert torch.equal(t_enc(f, b, deterministic=True, generator=torch.Generator()), t_out)
    (t_out * torch.arange(t_out.numel()).reshape(t_out.shape)).sum().div(t_out.numel()).backward()
    _allclose(t_out.detach(), j_out)
    _allclose(f.grad, j_grads[1])
    if kind == "spatial_projection":
        _allclose(b.grad, j_grads[2])
    paths = flax_paths(t_enc)
    flat = flatten_flax(jax.device_get(j_grads[0]))
    for n, p in t_enc.named_parameters():
        _allclose(p.grad, to_torch_layout(paths[n], flat[paths[n]]), what=n)


# ----------------------------------------------------------- layout, extra
def _boxes(rng, shape):
    """Corners in [-50, 1100]: some past 1023, some below 0, some widths negative."""
    return rng.integers(-50, 1100, shape + (4,)).astype(np.int64)


def test_layout_embeddings_match_jax_with_clipping():
    rng = np.random.default_rng(0)
    bbox = _boxes(rng, (2, 9))
    bbox[0, 0] = [900, 10, 100, 5]      # negative width and height: rows 0
    bbox[0, 1] = [1023, 1500, 2000, 2000]
    j_mod = JLayout(hidden_size=8, dtype=jnp.float32)
    variables = jax.jit(j_mod.init)(jax.random.PRNGKey(0), bbox)
    t_mod = TLayout(8, dtype=torch.float32)
    load_flax_params(t_mod, variables["params"])
    weights = rng.standard_normal((2, 9, 8)).astype(np.float32)

    def j_loss(params):
        out = j_mod.apply({"params": params}, bbox)
        return (out * weights).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(variables["params"])
    t_out = t_mod(torch.tensor(bbox))
    (t_out * torch.tensor(weights)).sum().backward()
    _allclose(t_out.detach(), j_out)
    paths, flat = flax_paths(t_mod), flatten_flax(jax.device_get(j_grads))
    for n, p in t_mod.named_parameters():
        _allclose(p.grad, flat[paths[n]], what=n)
    # the clipped rows: a negative width reads row 0, past 1023 reads row 1023
    w = t_mod.w_embed.weight.detach()
    x, y = t_mod.x_embed.weight.detach(), t_mod.y_embed.weight.detach()
    want = x[900] + y[10] + x[100] + y[5] + w[0] + t_mod.h_embed.weight.detach()[0]
    torch.testing.assert_close(t_out[0, 0].detach(), want, rtol=0, atol=1e-6)
    assert t_mod(torch.tensor([[[1023, 1500, 2000, 2000]]])).shape == (1, 1, 8)


def test_embeddings_extra_is_summed_before_the_layer_norm():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 30522, (2, 7))
    extra = rng.standard_normal((2, 7, 64)).astype(np.float32)
    j_bert = JBert(hidden_size=64, num_layers=1, num_heads=2, dtype=jnp.float32)
    variables = jax.jit(j_bert.init)(jax.random.PRNGKey(0), ids)
    t_bert = TBert(hidden_size=64, num_layers=1, num_heads=2, dtype=torch.float32)
    load_flax_params(t_bert, variables["params"])
    j_out = j_bert.apply(variables, ids, None, True, jnp.asarray(extra),
                         method=JBert.embeddings_apply)
    t_out = t_bert.embeddings_apply(torch.tensor(ids), None, torch.tensor(extra))
    _allclose(t_out.detach(), j_out)
    plain = t_bert.embeddings_apply(torch.tensor(ids))
    assert (t_out - plain).abs().max() > 0.1
    _allclose(plain.detach(), j_bert.apply(variables, ids, method=JBert.embeddings_apply))


# ---------------------------------------------------------------------- MRC
def _mrc_case(seed, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p = rng.dirichlet(np.ones(4), (2, 5)).astype(np.float32)
    p[0, 1] = [0.25, 0.25, 0.25, 0.25]  # a tie: the first index on both sides
    p[1, 2] = [0.0, 1.0, 0.0, 0.0]      # zeros: the clamped log
    to_predict = ((rng.random((2, 5)) < 0.5) | (np.arange(5) == 1)).astype(np.int64)
    return x, to_predict * masked, p


@pytest.mark.parametrize("masked", [True, False])
def test_mrc_head_matches_jax(masked):
    x, to_predict, p = _mrc_case(3, masked)
    j_head = JMRC(vocab_size=4, hidden_size=16, dtype=jnp.float32)
    variables = jax.jit(j_head.init)(jax.random.PRNGKey(0), x)
    t_head = TMRC(16, 4, dtype=torch.float32)
    load_flax_params(t_head, variables["params"])

    def j_loss(params, xs):
        logits = j_head.apply({"params": params}, xs)
        scored = j_head.loss_metric(logits, to_predict, p)
        return scored["losses"]["masked_region_classification"], (logits, scored)

    (_, (j_logits, j_scored)), j_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    xs = torch.tensor(x, requires_grad=True)
    t_logits = t_head(xs)
    t_scored = t_head.loss_metric(t_logits, torch.tensor(to_predict), torch.tensor(p))
    t_scored["losses"]["masked_region_classification"].backward()
    assert t_logits.dtype == torch.float32
    _allclose(t_logits.detach(), j_logits)
    for group in ("losses", "metrics"):
        assert sorted(t_scored[group]) == sorted(j_scored[group])
        for key, ref in j_scored[group].items():
            _allclose(float(t_scored[group][key].detach()), float(ref), what=key)
    if not masked:
        assert float(t_scored["losses"]["masked_region_classification"].detach()) == 0.0
        assert float(t_scored["metrics"]["mrc_acc"]) == 0.0
        return
    _allclose(xs.grad, j_grads[1])
    paths, flat = flax_paths(t_head), flatten_flax(jax.device_get(j_grads[0]))
    for n, prm in t_head.named_parameters():
        _allclose(prm.grad, to_torch_layout(paths[n], flat[paths[n]]), what=n)


def test_mrc_accuracy_takes_the_first_index_of_a_tie():
    logits = torch.tensor([[[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 0.0, 0.0]]])
    p = torch.tensor([[[0.0, 0.5, 0.5, 0.0], [0.1, 0.0, 0.0, 0.9]]])
    scored = TMRC(4, 4, dtype=torch.float32).loss_metric(logits, torch.ones(1, 2, dtype=torch.long), p)
    j = JMRC(vocab_size=4, hidden_size=4).loss_metric(jnp.asarray(logits.numpy()),
                                                      np.ones((1, 2)), p.numpy())
    assert float(scored["metrics"]["mrc_acc"]) == float(j["metrics"]["mrc_acc"]) == 0.5


# ---------------------------------------------------------------- univl_roi
def _batch(fields, seed):
    """Ragged captions (a third of the real tokens as MLM targets), padded
    regions (row 2 keeps 2 of 5), ragged OCR (row 1 empty), ITM labels and
    detector distributions with MRC targets."""
    rng = np.random.default_rng(seed)
    lens = np.array([LT, LT - 4, LT - 7])
    mask = (np.arange(LT)[None] < lens[:, None]).astype(np.int64)
    batch = {"caption_input_ids": rng.integers(1, 30522, (B, LT)) * mask,
             "caption_input_mask": mask,
             "caption_segment_ids": np.zeros((B, LT), np.int64),
             "caption_lm_label_ids": np.where((rng.random((B, LT)) < 0.3) & (mask > 0),
                                              rng.integers(1, 30522, (B, LT)), -1),
             "itm_labels": np.array([1, 0, 1], np.int64)}
    if "regions" in fields:
        region_mask = (np.arange(R)[None] < np.array([R, 4, 2])[:, None]).astype(np.int64)
        xy = rng.uniform(0, 0.5, (B, R, 2))
        x1y1 = xy + rng.uniform(0.05, 0.5, (B, R, 2))
        area = np.prod(x1y1 - xy, axis=-1, keepdims=True)
        batch.update(
            region_feature=rng.standard_normal((B, R, 16)).astype(np.float32) * region_mask[
                ..., None],
            region_boxes=(np.concatenate([xy, x1y1, area], -1) * region_mask[..., None]
                          ).astype(np.float32),
            region_mask=region_mask,
            region_to_predict=((rng.random((B, R)) < 0.4) & (region_mask > 0)).astype(np.int64),
            region_cls_dis=rng.dirichlet(np.ones(4), (B, R)).astype(np.float32))
        batch["region_to_predict"][0, 0] = 1
    if "ocr" in fields:
        ocr_mask = (np.arange(LO)[None] < np.array([LO, 0, 6])[:, None]).astype(np.int64)
        batch.update(ocr_input_ids=rng.integers(1, 30522, (B, LO)) * ocr_mask,
                     ocr_input_mask=ocr_mask)
        if "boxes" in fields:
            corner = rng.integers(0, 800, (B, LO, 2))
            batch["ocr_bboxes"] = (np.concatenate(
                [corner, corner + rng.integers(0, 200, (B, LO, 2))], -1) * ocr_mask[..., None])
    if "grid" in fields:
        video_mask = np.ones((B, FRAMES), np.int64)
        video_mask[1, -1] = 0
        batch.update(image_data=rng.random((B, FRAMES, 32, 32, 3), dtype=np.float32),
                     video_mask=video_mask)
    return batch


def _config(grid):
    return {"model_attributes": {"univl_roi": {**TINY, "with_grid_stream": grid}}}


@pytest.fixture(scope="module")
def jax_runs():
    """Per setting: the batch, the weights (the port's seeded init exported,
    which must have exactly the JAX tree of a batch with every field the
    model reads), the JAX scalars and the gradients by flax path."""
    runs = {}
    for i, (name, (grid, fields)) in enumerate(SETTINGS.items()):
        batch = _batch(fields, seed=i)
        shell = j_build(_config(grid))
        full = _batch(("regions", "ocr", "boxes", "grid") if grid else
                      ("regions", "ocr", "boxes"), seed=i)
        abstract = jax.eval_shape(shell.init, jax.random.PRNGKey(0), full)["params"]
        seeded = t_build(_config(grid), device="cpu")
        seeded.init(i)
        params = export_flax_params(seeded.module)
        shapes = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
                  in jax.tree_util.tree_flatten_with_path(abstract)[0]}
        assert {p: v.shape for p, v in flatten_flax(params).items()} == shapes, name

        def loss_of(params):
            total, (out, scalars) = shell.loss_fn({"params": params}, batch, deterministic=True)
            return total, (scalars, out["logits"], out["mrc_logits"])

        (_, (scalars, logits, mrc)), grads = jax.jit(
            jax.value_and_grad(loss_of, has_aux=True))(params)
        runs[name] = dict(batch=batch, params=params, scalars=jax.device_get(scalars),
                          logits=np.asarray(logits), mrc_logits=np.asarray(mrc),
                          grads=flatten_flax(jax.device_get(grads)))
    return runs


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    runs = {}
    for name, j in jax_runs.items():
        shell = t_build(_config(SETTINGS[name][0]), device="cpu")
        load_flax_params(shell.module, j["params"])
        total, (out, scalars) = shell.loss_fn(j["batch"], deterministic=True)
        total.backward()
        runs[name] = dict(shell=shell, out=out, scalars=scalars,
                          grads={n: p.grad for n, p in shell.module.named_parameters()})
    return runs


@pytest.mark.parametrize("name", list(SETTINGS))
def test_losses_and_metrics_match_jax(jax_runs, port_runs, name):
    j, t = jax_runs[name]["scalars"], port_runs[name]["scalars"]
    assert sorted(t) == sorted(j) == [
        "losses/itm_loss", "losses/masked_lm_loss", "losses/masked_region_classification",
        "metrics/itm_acc", "metrics/masked_lm_acc", "metrics/mrc_acc", "total_loss"]
    for key in j:
        _allclose(float(t[key]), float(j[key]), what=f"{name}: {key}")
    out = port_runs[name]["out"]
    _allclose(out["logits"].detach(), jax_runs[name]["logits"], what="logits")
    _allclose(out["mrc_logits"].detach(), jax_runs[name]["mrc_logits"], what="mrc_logits")
    assert float(t["losses/masked_region_classification"]) > 0


@pytest.mark.parametrize("name", list(SETTINGS))
def test_every_gradient_matches_jax(jax_runs, port_runs, name):
    module = port_runs[name]["shell"].module
    paths = flax_paths(module)
    assert sorted(paths.values()) == sorted(jax_runs[name]["grads"])
    ref = _grad_close(port_runs[name]["grads"], jax_runs[name]["grads"], paths, name)
    layout = {n: g for n, g in ref.items() if n.startswith(LAYOUT)}
    if name in ("regions", "ocr_without_boxes"):
        # no boxes reach the layout tables: no gradient on either side
        assert all(port_runs[name]["grads"][n] is None for n in layout)
        assert all(not g.any() for g in layout.values())
    else:
        assert all(np.abs(g).max() > 0 for g in layout.values())
    assert ("base.img_encoder.embeddings.pos_embedding" in paths) == SETTINGS[name][0]


def test_ocr_boxes_reach_the_cross_encoder(jax_runs, port_runs):
    """The same OCR tokens on other boxes give another pooled pair."""
    shell = port_runs["regions_ocr"]["shell"]
    batch = dict(jax_runs["regions_ocr"]["batch"])
    moved = dict(batch, ocr_bboxes=(batch["ocr_bboxes"] + 311) % 1001)
    with torch.no_grad():
        a = shell.module(shell.to_device(batch))
        b = shell.module(shell.to_device(moved))
    assert (a["cross_pooled"] - b["cross_pooled"]).abs().max() > 1e-4
    assert a["mrc_logits"].shape == (B, R, 4)


def test_bridge_carries_the_whole_tree(jax_runs, port_runs):
    for name in SETTINGS:
        j = flatten_flax(jax_runs[name]["params"])
        back = flatten_flax(export_flax_params(port_runs[name]["shell"].module))
        assert sorted(back) == sorted(j)
        for path, value in j.items():
            np.testing.assert_array_equal(back[path], value, path)
    flat = flatten_flax(jax_runs["regions_ocr"]["params"])
    assert flat["region_encoder/spatial_proj/kernel"].shape == (6, 64)
    assert {"region_encoder/proj/kernel", "region_encoder/norm/LayerNorm_0/scale",
            f"{LAYOUT}/x_embed/embedding", f"{LAYOUT}/h_embed/embedding",
            "mrc_head/transform/kernel", "mrc_head/transform_norm/LayerNorm_0/bias",
            "mrc_head/decoder/kernel"} <= set(flat)
    assert not any(p.startswith(("base/img_encoder", "base/img_fc", "base/cross_sim_head"))
                   for p in flat)


def test_univl_auto_roi_stage_builds_univl_roi():
    config = {"model_attributes": {"univl_auto": {**TINY, "training_stage": "roi",
                                                  "with_grid_stream": False}}}
    module = t_build(config, device="cpu").module
    assert type(module).__name__ == type(j_build(config).module).__name__ == "UnivlRoiModel"
    assert not hasattr(module.base, "img_encoder")


def test_tower_dropout_still_raises_with_its_name():
    """Tower dropout is ported: 0.1 reaches the ViT, BERT and the
    cross-encoder; the region encoder keeps its own default 0.1, which
    ``UnivlRoiModel`` never sets (JAX's quirk, kept)."""
    from antmmf_torch.modules.layers import Dropout

    module = t_build({"model_attributes": {"univl_roi": {**TINY, "dropout": 0.1}}},
                     device="cpu").module
    for tower in (module.base.img_encoder, module.base.text_encoder, module.base.cross_encoder):
        assert {m.rate for m in tower.modules() if isinstance(m, Dropout)} == {0.1}
    off = t_build({"model_attributes": {"univl_roi": {**TINY, "dropout": 0.0}}},
                  device="cpu").module
    assert module.region_encoder.dropout.rate == off.region_encoder.dropout.rate == 0.1
