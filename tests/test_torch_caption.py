"""UniVL captioning in the port against the JAX package, on the CPU.

* ``univl_caption`` at the tiny presets, fp32: ``caption_cross_entropy``,
  ``caption_token_acc`` and the gradient of every parameter, for two
  settings: 8 decoder heads of 8 (the einsum core, as the card's 96-wide
  heads) with ``caption_raw_input_ids`` chosen over the masked
  ``caption_input_ids``; 2 heads of 32 (cross-attention on the flash
  route's plain version) with ``generation_input_ids``/``_mask`` chosen
  over the caption fields. Ragged captions and a padded frame in both.
* ``generate``: tokens equal to JAX's and scores within 1e-5, with the
  cache and re-encoding, for 1 and 3 beams; the port's cached tokens equal
  its re-encoded ones.
* ``ids_to_caption`` and ``CaptioningEvaluator`` equal to JAX's, and
  ``caption_predictor`` through the CLI with ``--device cpu`` on a config
  written to ``tmp_path``, against the JAX predictor on the same weights.

The weights are the port's seeded init, exported to a flax tree that must
have exactly the JAX model's paths and shapes; carried into a fresh model
by ``load_flax_params`` and exported again, every leaf comes back bit for
bit (the predictor's CLI loads it from a ``params.npz``). Tolerances (fp32 on both sides, sums in another
order): loss and accuracy at atol 1e-5; a parameter's gradient within 1e-4
of its largest JAX entry, floored at 1e-2 of the model's largest (exact
zeros, such as the key projections' biases, hold only rounding).
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules.metrics.evaluators import build_evaluator as t_evaluator
from antmmf_torch.predictors import cli as t_cli
from antmmf_torch.predictors.caption_predictor import ids_to_caption as t_ids_to_caption
from antmmf_torch.utils.tokenization import BertTokenizer as TTok
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.modules.metrics.evaluators import build_evaluator as j_evaluator
from antmmf_tpu.predictors.caption_predictor import CaptionPredictor as JPredictor
from antmmf_tpu.predictors.caption_predictor import ids_to_caption as j_ids_to_caption
from antmmf_tpu.utils.tokenization import BertTokenizer as JTok
from test_torch_trainer import jitted_jax_init
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR, SCORE_ATOL = 1e-5, 1e-4, 1e-2, 1e-5
VOCAB = "tests/data/vocabs/bert-base-uncased_30522_vocab.txt"
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            embed_dim=32, decoder_layers=2, max_caption_len=8, dtype_str="float32")
SETTINGS = {"heads8_raw": 8, "heads2_generation": 2}


def _config(heads):
    return {"model_attributes": {"univl_caption": {**TINY, "decoder_heads": heads}}}


def _batch(name, B=3, F=2, L=8, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([L, 5, 3][:B])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(1000, 30522, (B, L)) * mask
    ids[:, 0] = 101
    video_mask = np.ones((B, F), np.int64)
    video_mask[1, -1] = 0
    batch = {"image_data": rng.standard_normal((B, F, 32, 32, 3)).astype(np.float32),
             "video_mask": video_mask, "caption_input_ids": np.where(mask > 0, 103, 0),
             "caption_input_mask": mask}
    if name.endswith("raw"):
        batch["caption_raw_input_ids"] = ids
    else:  # the generation fields win over the caption ones
        gen_mask = mask.copy()
        gen_mask[2, :6] = 1  # row 2 scores three pad tokens (id 0) too
        batch.update(generation_input_ids=ids, generation_input_mask=gen_mask,
                     caption_raw_input_ids=ids[:, ::-1].copy())
    return batch


def _seeded(heads, seed):
    """The port's seeded init as a flax tree, checked against the JAX
    model's abstract init, and the port model carrying it."""
    shell = t_build(_config(heads), device="cpu")
    shell.init(seed)
    params = export_flax_params(shell.module)
    j_shell = j_build(_config(heads))
    abstract = jax.eval_shape(j_shell.init, jax.random.PRNGKey(0), _batch("x_raw"))["params"]
    shapes = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
              in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert {p: v.shape for p, v in flatten_flax(params).items()} == shapes
    return shell, j_shell, params


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, heads in SETTINGS.items():
        shell, j_shell, params = _seeded(heads, seed=heads)
        batch = _batch(name, seed=heads)

        def loss_of(params):
            total, (_, scalars) = j_shell.loss_fn({"params": params}, batch, deterministic=True)
            return total, scalars

        (_, j_scalars), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
        total, (t_out, t_scalars) = shell.loss_fn(batch, deterministic=True)
        total.backward()
        out[name] = dict(shell=shell, j_shell=j_shell, params=params, batch=batch,
                         j_scalars=jax.device_get(j_scalars), t_scalars=t_scalars, t_out=t_out,
                         j_grads=flatten_flax(jax.device_get(j_grads)))
    return out


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_loss_and_accuracy_match_jax(runs, name):
    r = runs[name]
    assert sorted(r["t_scalars"]) == sorted(r["j_scalars"]) == [
        "losses/caption_cross_entropy", "metrics/caption_token_acc", "total_loss"]
    for key, ref in r["j_scalars"].items():
        np.testing.assert_allclose(float(r["t_scalars"][key]), float(ref), atol=ATOL, err_msg=key)
    logits = r["t_out"]["logits"]
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (3, 8, 30522)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_every_gradient_matches_jax(runs, name):
    r = runs[name]
    module, j_grads = r["shell"].module, r["j_grads"]
    paths = flax_paths(module)
    assert sorted(paths.values()) == sorted(j_grads)
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in j_grads.values())
    bad = {}
    for n, p in module.named_parameters():
        ref = to_torch_layout(paths[n], j_grads[paths[n]])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        err = float(np.abs(got - ref).max())
        if err > GRAD_RTOL * max(float(np.abs(ref).max()), floor):
            bad[n] = err
    assert not bad, bad
    # the decoder and the ViT learn; img_fc feeds no loss here
    assert float(np.abs(j_grads["decoder/out_proj/kernel"]).max()) > 0
    assert max(float(np.abs(g).max()) for p, g in j_grads.items()
               if p.startswith("base/img_encoder/")) > 0
    assert float(np.abs(j_grads["base/img_fc/kernel"]).max()) == 0


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_bridge_carries_the_caption_tree_both_ways(runs, name):
    """Every leaf of the exported tree, carried into a fresh model by
    ``load_flax_params`` and exported again, bit for bit: the ``nn.Embed``
    tables untransposed, the Dense kernels (``out_proj`` [768→V]) transposed."""
    params = flatten_flax(runs[name]["params"])
    fresh = t_build(_config(SETTINGS[name]), device="cpu").module
    load_flax_params(fresh, runs[name]["params"])
    back = flatten_flax(export_flax_params(fresh))
    assert sorted(back) == sorted(params)
    for path, value in params.items():
        np.testing.assert_array_equal(back[path], value, path)
    emb = dict(fresh.named_parameters())["decoder.token_embed.weight"]
    np.testing.assert_array_equal(emb.detach().numpy(), params["decoder/token_embed/embedding"])
    out = dict(fresh.named_parameters())["decoder.out_proj.weight"]
    np.testing.assert_array_equal(out.detach().numpy(), params["decoder/out_proj/kernel"].T)
    assert {p.split("/")[0] for p in params} == {"base", "decoder"}


def test_the_token_fields_are_chosen_in_jax_order(runs):
    """With the generation fields present, the loss does not change when the
    caption fields do; without them, the raw ids are read, not the masked."""
    r = runs["heads2_generation"]
    batch = {k: v for k, v in r["batch"].items()
             if not k.startswith("caption_") or k == "caption_input_mask"}
    batch["caption_input_mask"] = np.zeros_like(batch["caption_input_mask"])
    with torch.no_grad():
        _, (_, scalars) = r["shell"].loss_fn(batch, deterministic=True)
    assert float(scalars["total_loss"]) == float(r["t_scalars"]["total_loss"])
    raw = runs["heads8_raw"]
    masked_only = {k: v for k, v in raw["batch"].items() if k != "caption_raw_input_ids"}
    with torch.no_grad():
        _, (_, scalars) = raw["shell"].loss_fn(masked_only, deterministic=True)
    assert abs(float(scalars["total_loss"]) - float(raw["t_scalars"]["total_loss"])) > 1e-3


def _generate_batch(seed=5):
    rng = np.random.default_rng(seed)
    video_mask = np.ones((2, 2), np.int64)
    video_mask[1, 1] = 0
    return {"image_data": rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32),
            "video_mask": video_mask}


@pytest.mark.parametrize("K", [1, 3])
def test_generate_matches_jax_cached_and_reencoded(runs, K):
    r = runs["heads8_raw"]
    module, j_module = r["shell"].module, r["j_shell"].module
    batch = _generate_batch()
    variables = {"params": r["params"]}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tokens = {}
    for use_cache in (True, False):
        jt, js = j_module.generate(variables, batch, num_beams=K, max_length=8,
                                   use_cache=use_cache)
        tt, ts = module.generate(t_batch, num_beams=K, max_length=8, use_cache=use_cache)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=str(use_cache))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
        assert (tt[:, 0] == 101).all() and tuple(tt.shape) == (2, 8)
        tokens[use_cache] = tt
    torch.testing.assert_close(tokens[True], tokens[False], rtol=0, atol=0)


def test_ids_to_caption_and_evaluator_match_jax(runs):
    t_tok, j_tok = TTok(VOCAB), JTok(VOCAB)
    ids = t_tok.convert_tokens_to_ids(["[CLS]", "a", "little", "girl", "##s", "[SEP]", "[PAD]"])
    assert t_ids_to_caption(t_tok, ids) == j_ids_to_caption(j_tok, ids) == "a little girls"
    gen, _ = runs["heads8_raw"]["shell"].module.generate(
        {k: torch.from_numpy(v) for k, v in _generate_batch().items()}, num_beams=3, max_length=8)
    gen = gen.numpy()
    refs = np.stack([gen[0], gen[0]])  # one exact, one against another caption
    for row in gen:
        assert t_ids_to_caption(t_tok, row) == j_ids_to_caption(j_tok, row)
    te, je = t_evaluator("captioning"), j_evaluator("captioning")
    for ev in (te, je):
        ev.collect({"caption_raw_input_ids": refs}, {"generated_ids": gen})
        ev.collect({"caption_raw_input_ids": refs}, {})  # no generation: skipped
    t_sum, j_sum = te.summarize(), je.summarize()
    assert sorted(t_sum) == sorted(j_sum) == ["bleu4", "rouge_l"]
    for key in j_sum:
        assert t_sum[key] == j_sum[key], key


def test_caption_predictor_through_the_cli(runs, tmp_path, capsys):
    """``--predictor caption_predictor --device cpu`` with the weights in a
    ``params.npz``: the caption, ids and score of the JAX predictor on the
    same weights and request."""
    r = runs["heads8_raw"]
    cfg = {"model_attributes": {"univl_caption": {**TINY, "decoder_heads": 8}},
           "predictor_parameters": {"num_beams": 3, "vocab_file": VOCAB}}
    config = tmp_path / "caption.yml"
    config.write_text(yaml.safe_dump(cfg))
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    np.savez(model_dir / "params.npz", **flatten_flax(r["params"]))
    frames = _generate_batch()["image_data"][0]
    request = tmp_path / "req.json"
    request.write_text(json.dumps({"image_data": frames.tolist()}))
    t_cli.main(["--config", str(config), "--predictor", "caption_predictor", "--device", "cpu",
                "--model_dir", str(model_dir), "--input", str(request)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jitted_jax_init():  # its init is replaced by r's params below
        pred = JPredictor(cfg).load(with_ckpt=False)
    pred.variables = {"params": jax.tree_util.tree_map(np.asarray, r["params"])}
    ref = pred.predict({"image_data": frames})
    assert isinstance(got["caption"], str) and got["caption"] == ref["caption"]
    np.testing.assert_array_equal(np.asarray(got["generated_ids"]), ref["generated_ids"])
    np.testing.assert_allclose(got["scores"], np.asarray(ref["scores"]), atol=SCORE_ATOL)


def test_caption_dropout_raises_with_its_rate():
    """Dropout is ported: the model builds at 0.1 and the rate reaches the
    ViT and every decoder layer (self- and cross-attention, MLP), as JAX
    passes it."""
    from antmmf_torch.modules.layers import Dropout

    module = t_build({"model_attributes": {"univl_caption": {**TINY, "dropout": 0.1}}},
                     device="cpu").module
    for tower in (module.base.img_encoder, module.decoder):
        assert {m.rate for m in tower.modules() if isinstance(m, Dropout)} == {0.1}
    for layer in module.decoder.decoder.layers():
        assert layer.self_attention.dropout.rate == layer.cross_attention.dropout.rate == \
            layer.mlp.dropout.rate == 0.1
