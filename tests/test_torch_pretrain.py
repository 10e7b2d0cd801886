"""UniVL video-text pretraining in the port against the JAX package, on the CPU.

* The pretraining heads (``MLMHead`` with the tied table, ``ITMHead``,
  ``FOMHead``) and their ``loss_metric``s on seeded inputs, JAX params
  carried by ``load_flax_params``; one label row is all -1, and an all -1
  batch scores 0 in both.
* ``univl_pretrain`` at the tiny presets, fp32: every loss term, every
  metric and ``total_loss``, and the gradient of every parameter, the word
  embedding named among them (the MLM decoder is tied to it), for three
  settings: VTC + VTM + MLM at 8 frames of 224² (the pair stream is
  30 + 8·197 = 1606 tokens, so the cross-encoder takes the flash route, its
  plain versions on the CPU); ``dual_mlm``; FOM given the same frame
  permutation and shuffle mask on both sides (JAX draws them from its
  ``dropout`` stream, the port from the trainer's generator, so the test
  fixes them on both).
* The weights are the port's seeded init, exported to a flax tree that
  must have exactly the JAX model's paths and shapes and carried back into
  the port through ``load_flax_params``; and
  ``attentive_masking`` raises with its name.

Tolerances (fp32 on both sides, sums in another order): logits, losses and
metrics at atol 1e-5; a parameter's gradient within 1e-4 of its largest
JAX entry, floored at 1e-3 of the model's largest (the key projections'
biases have an exact gradient of 0: the softmax ignores a shift shared by
every key, so both sides hold only rounding there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules import attention as t_attention
from antmmf_torch.modules.transformers.heads.fom import FOMHead as TFOM
from antmmf_torch.modules.transformers.heads.itm import ITMHead as TITM
from antmmf_torch.modules.transformers.heads.mlm import MLMHead as TMLM
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.modules.transformers.heads.fom import FOMHead as JFOM
from antmmf_tpu.modules.transformers.heads.itm import ITMHead as JITM
from antmmf_tpu.modules.transformers.heads.mlm import MLMHead as JMLM
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-3
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", embed_dim=32,
            dtype_str="float32")
WORD_EMBEDDINGS = "base.text_encoder.embeddings.word_embeddings.weight"
# (model attributes, B, frames, image size, caption length)
SETTINGS = {
    "vtc_vtm_mlm_224": ({**TINY, "image_size": 224}, 2, 8, 224, 30),
    "dual_mlm": ({**TINY, "image_size": 32, "dual_mlm": True}, 4, 2, 32, 24),
    "fom": ({**TINY, "image_size": 32, "with_fom": True}, 4, 4, 32, 24),
}
FOM_PERM, FOM_SHUFFLE = [2, 0, 3, 1], [True, False, True, True]


def _batch(B, F, size, L, seed):
    """Ragged captions with about a third of the real tokens as MLM targets
    (row 1 has none), and a padded last frame in row 1."""
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 7, L - 15, L - 4][:B])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    labels = np.where((rng.random((B, L)) < 0.3) & (mask > 0),
                      rng.integers(1, 30522, (B, L)), -1)
    labels[1] = -1
    video_mask = np.ones((B, F), np.int64)
    video_mask[1, -1] = 0
    return {"image_data": rng.random((B, F, size, size, 3), dtype=np.float32),
            "video_mask": video_mask,
            "caption_input_ids": rng.integers(1, 30522, (B, L)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, L), np.int64),
            "caption_lm_label_ids": labels}


def _config(model):
    return {"model_attributes": {"univl_pretrain": model}}


@pytest.fixture(scope="module")
def jax_runs():
    """For each setting: the batch, the weights (the port's seeded init
    exported as a flax tree, which must have exactly the paths and shapes of
    the JAX model's own init), the JAX scalars and the gradient of the total
    loss by flax path (FOM in training mode with the permutation and shuffle
    mask fixed)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(FOM_PERM))
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(FOM_SHUFFLE))
        for name, (model, B, F, size, L) in SETTINGS.items():
            batch = _batch(B, F, size, L, seed=len(name))
            shell = j_build(_config(model))
            abstract = jax.eval_shape(shell.init, jax.random.PRNGKey(0), batch)["params"]
            seeded = t_build(_config(model), device="cpu")
            seeded.init(len(name))
            params = export_flax_params(seeded.module)
            shapes = {"/".join(str(k.key) for k in path): tuple(v.shape) for path, v
                      in jax.tree_util.tree_flatten_with_path(abstract)[0]}
            assert {p: v.shape for p, v in flatten_flax(params).items()} == shapes, name
            training = name == "fom"

            def loss_of(params):
                total, (_, scalars) = shell.loss_fn(
                    {"params": params}, batch, deterministic=not training,
                    rngs={"dropout": jax.random.PRNGKey(1)} if training else None)
                return total, scalars

            (_, scalars), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
            runs[name] = dict(batch=batch, params=params, scalars=jax.device_get(scalars),
                              grads=flatten_flax(jax.device_get(grads)))
    return runs


def _port(name, params):
    shell = t_build(_config(SETTINGS[name][0]), device="cpu")
    load_flax_params(shell.module, params)
    if name == "fom":
        shell.module.fom_order = lambda B, F, device, generator: (
            torch.tensor(FOM_PERM, device=device), torch.tensor(FOM_SHUFFLE, device=device))
    return shell


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's total loss, scalars and parameter gradients per setting,
    with the cross-encoder's attention routes recorded."""
    runs = {}
    real_flash = t_attention.flash_attention
    for name, j in jax_runs.items():
        shell = _port(name, j["params"])
        routes = []
        t_attention.flash_attention = \
            lambda q, k, v, **kw: routes.append(q.shape[2]) or real_flash(q, k, v, **kw)
        try:
            total, (out, scalars) = shell.loss_fn(j["batch"], deterministic=name != "fom")
        finally:
            t_attention.flash_attention = real_flash
        total.backward()
        runs[name] = dict(shell=shell, out=out, scalars=scalars, routes=routes,
                          grads={n: p.grad for n, p in shell.module.named_parameters()})
    return runs


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_losses_and_metrics_match_jax(jax_runs, port_runs, name):
    j, t = jax_runs[name]["scalars"], port_runs[name]["scalars"]
    assert sorted(t) == sorted(j)
    for key in j:
        np.testing.assert_allclose(float(t[key]), float(j[key]), atol=ATOL, rtol=0,
                                   err_msg=f"{name}: {key}")
    expected = {"losses/vtc_loss", "losses/itm_loss", "losses/masked_lm_loss", "total_loss"}
    expected |= {"dual_mlm": {"losses/text_masked_lm_loss"},
                 "fom": {"losses/fom_loss"}}.get(name, set())
    assert expected <= set(t)
    out = port_runs[name]["out"]
    assert {"sim", "l1_simi", "itm_logits", "mlm_logits", "logits", "losses",
            "metrics"} <= set(out)
    assert out["mlm_logits"].dtype == torch.float32
    if name == "fom":  # the fixed shuffle scored 3 rows of 4 frames
        assert float(t["losses/fom_loss"]) > 0


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_every_gradient_matches_jax(jax_runs, port_runs, name):
    """Each parameter's gradient, the tied word embedding's included."""
    j_grads, t_grads = jax_runs[name]["grads"], port_runs[name]["grads"]
    paths = flax_paths(port_runs[name]["shell"].module)
    assert sorted(paths.values()) == sorted(j_grads)
    ref = {n: to_torch_layout(p, j_grads[p]) for n, p in paths.items()}
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in ref.values())
    bad = {}
    for n, g in ref.items():
        err = float(np.abs(t_grads[n].numpy() - g).max())
        if err > GRAD_RTOL * max(float(np.abs(g).max()), floor):
            bad[n] = err
    assert not bad, bad
    # the MLM decoder's gradient reaches the embedding beyond the looked-up
    # rows: a detached or copied table would leave these rows at 0
    batch = jax_runs[name]["batch"]
    looked_up = np.unique(batch["caption_input_ids"])
    unseen = np.setdiff1d(np.arange(ref[WORD_EMBEDDINGS].shape[0]), looked_up)
    assert np.abs(ref[WORD_EMBEDDINGS][unseen]).max() > 0
    np.testing.assert_allclose(t_grads[WORD_EMBEDDINGS].numpy()[unseen],
                               ref[WORD_EMBEDDINGS][unseen], rtol=0,
                               atol=GRAD_RTOL * float(np.abs(ref[WORD_EMBEDDINGS]).max()))


def test_pair_stream_takes_the_flash_route(port_runs):
    """8 frames of 224² at patch 16: the VTM and the MLM pass each run both
    cross layers over 30 + 8·197 tokens through ``flash_attention``."""
    assert port_runs["vtc_vtm_mlm_224"]["routes"] == [30 + 8 * 197] * 4
    assert port_runs["dual_mlm"]["routes"] == []


def test_mlm_heads_decode_against_the_embedding_parameter(port_runs):
    """Neither head holds a decoder weight: both score against the word
    embedding's own parameter."""
    module = port_runs["dual_mlm"]["shell"].module
    for head in (module.mlm_head, module.text_mlm_head):
        assert sorted(n for n, _ in head.named_parameters()) == [
            "decoder_bias", "transform.bias", "transform.weight", "transform_norm.bias",
            "transform_norm.weight"]
    assert module.word_embedding_table() is dict(module.named_parameters())[WORD_EMBEDDINGS]


def test_bridge_carries_the_whole_tree(jax_runs, port_runs):
    """The weights went into the port through ``load_flax_params`` (no flax
    leaf missing or unused) and come back out equal; the heads' scopes are
    those of the JAX model."""
    for name in SETTINGS:
        j = flatten_flax(jax_runs[name]["params"])
        back = flatten_flax(export_flax_params(port_runs[name]["shell"].module))
        assert sorted(back) == sorted(j)
        for path, value in j.items():
            np.testing.assert_array_equal(back[path], value, path)
    heads = {p.split("/")[0] for name in ("dual_mlm", "fom")
             for p in flatten_flax(jax_runs[name]["params"])}
    assert heads == {"base", "logit_scale", "mlm_head", "text_mlm_head", "itm_head",
                     "fom_head"}
    assert {"mlm_head/transform/kernel", "mlm_head/transform_norm/LayerNorm_0/scale",
            "mlm_head/decoder_bias", "itm_head/classifier/kernel",
            "fom_head/classifier/kernel"} <= set(flatten_flax(jax_runs["fom"]["params"]))


def test_attentive_masking_raises_with_its_name():
    """Attentive masking is ported: the model builds with it and keeps its
    ratio; with dropout, which is ported too, the word-importance pass
    draws nothing inside a training forward (JAX runs it deterministic)."""
    from antmmf_torch.modules.layers import draws

    module = t_build(_config({**TINY, "image_size": 32, "attentive_masking": True}),
                     device="cpu").module
    assert module.attentive_masking and module.attentive_mask_ratio == 0.15
    module = t_build(_config({**TINY, "image_size": 32, "attentive_masking": True,
                              "dropout": 0.1}), device="cpu").module
    ids = torch.as_tensor(np.random.default_rng(0).integers(1000, 30000, (2, 9)))
    mask = torch.ones_like(ids)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        plain = module.base.text_encoder.word_importance(ids, mask)
        with draws(gen):
            inside = module.base.text_encoder.word_importance(ids, mask)
    assert torch.equal(plain, inside) and torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------- heads
def _head_case(kind, seed):
    """(JAX head, port head, inputs, targets): seeded inputs [3, 5, 24];
    MLM with a table of 40 words of width 16 and row 1 all -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    if kind == "mlm":
        table = rng.standard_normal((40, 16)).astype(np.float32)
        labels = np.where(rng.random((3, 5)) < 0.5, rng.integers(0, 40, (3, 5)), -1)
        labels[1] = -1
        return (JMLM(vocab_size=40, hidden_size=16, dtype=jnp.float32),
                TMLM(24, 40, 16, dtype=torch.float32), (x, table), (labels,))
    if kind == "itm":
        return (JITM(hidden_size=24, dtype=jnp.float32), TITM(24, dtype=torch.float32),
                (x[:, 0],), (rng.integers(0, 2, 3),))
    targets = np.stack([rng.permutation(5) for _ in range(3)])
    valid = np.array([[True] * 5, [False] * 5, [True] * 5])
    return (JFOM(max_positions=8, dtype=jnp.float32), TFOM(24, 8, dtype=torch.float32),
            (x,), (targets, valid))


@pytest.mark.parametrize("kind", ["mlm", "itm", "fom"])
def test_head_and_loss_metric_match_jax(kind):
    """Logits, loss and metric, the gradient of the loss with respect to the
    head's parameters and its inputs (and the tied table)."""
    j_head, t_head, inputs, targets = _head_case(kind, seed=len(kind))
    variables = jax.jit(j_head.init)(jax.random.PRNGKey(0), *inputs)
    load_flax_params(t_head, variables["params"])

    def j_loss(params, *xs):
        logits = j_head.apply({"params": params}, *xs)
        scored = type(j_head).loss_metric(logits, *targets)
        return next(iter(scored["losses"].values())), (logits, scored)

    (_, (j_logits, j_scored)), j_grads = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
            variables["params"], *inputs)
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_logits = t_head(*xs)
    t_scored = type(t_head).loss_metric(t_logits, *(torch.as_tensor(t) for t in targets))
    next(iter(t_scored["losses"].values())).backward()

    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.detach().numpy(), j_logits, atol=ATOL, rtol=0)
    for group in ("losses", "metrics"):
        assert sorted(t_scored[group]) == sorted(j_scored[group])
        for key, ref in j_scored[group].items():
            np.testing.assert_allclose(float(t_scored[group][key].detach()), float(ref),
                                       atol=ATOL, err_msg=key)
    paths = flax_paths(t_head)
    flat = flatten_flax(jax.device_get(j_grads[0]))
    for n, p in t_head.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), to_torch_layout(paths[n], flat[paths[n]]),
                                   atol=ATOL, rtol=0, err_msg=n)
    for x, g in zip(xs, j_grads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["mlm", "fom"])
def test_nothing_to_score_gives_zero(kind):
    """Evaluation captions carry no MLM target (and no frame is shuffled):
    the clamped denominator makes loss and accuracy 0 on both sides."""
    j_head, _, inputs, targets = _head_case(kind, seed=3)
    logits = np.random.default_rng(4).standard_normal((3, 5, 8 if kind == "fom" else 40))
    if kind == "mlm":
        none = (np.full((3, 5), -1),)
        t_scored = TMLM.loss_metric(torch.tensor(logits, dtype=torch.float32),
                                    torch.tensor(none[0]))
    else:
        none = (targets[0], np.zeros((3, 5), bool))
        t_scored = TFOM.loss_metric(torch.tensor(logits, dtype=torch.float32),
                                    *(torch.as_tensor(t) for t in none))
    j_scored = type(j_head).loss_metric(jnp.asarray(logits, jnp.float32), *none)
    for group in ("losses", "metrics"):
        for key, ref in j_scored[group].items():
            assert float(ref) == float(t_scored[group][key]) == 0.0, key
