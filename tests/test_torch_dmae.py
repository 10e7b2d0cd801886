"""DMAE in the port against the JAX package, on the CPU.

* ``wti_similarity`` on seeded tokens, weights and masks (padded words and
  padded frames, and a word whose similarities are all negative, which
  the zero-then-max masking floors at 0) and its gradients; the
  ``RetrievalTrainer._wti_grid`` of both packages on the same host arrays,
  chunked across a chunk edge, and the port's grid against its
  ``wti_similarity``, at atol 1e-6.
* ``TokenWeightHead`` (the softmax over valid tokens only) and its
  gradients, JAX params carried by ``load_flax_params``.
* ``dmae_retrieval`` at the tiny presets, fp32: every output of the JAX
  model (``l1_simi``, ``l3_simi``, the embeddings, the ``wti_*``
  components), both losses and every parameter's gradient, for two
  settings: the local config's widths (embed 32, one temporal head) with a
  padded frame and a NegNCE margin, and embed 128 (two temporal heads of
  64, two temporal layers) with a padded frame. The weights are the port's
  seeded init exported to a flax tree that must have exactly the JAX
  model's paths and shapes. Outputs and losses at atol 1e-5; a gradient
  within 1e-5 of its largest JAX entry, floored at 1e-6 of the model's
  largest.
* ``dropout`` reaches both towers (ported), not the temporal encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.models.dmae import TokenWeightHead as TWeight
from antmmf_torch.models.dmae import wti_similarity as t_wti
from antmmf_torch.trainers.retrieval_trainer import RetrievalTrainer as TRetrieval
from antmmf_torch.utils.weights import (
    export_flax_params,
    flatten_flax,
    flax_paths,
    load_flax_params,
    to_torch_layout,
)
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.models.dmae import TokenWeightHead as JWeight
from antmmf_tpu.models.dmae import wti_similarity as j_wti
from antmmf_tpu.trainers.retrieval_trainer import RetrievalTrainer as JRetrieval
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, GRAD_RTOL, GRAD_FLOOR, GRID_ATOL = 1e-5, 1e-5, 1e-6, 1e-6
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            dtype_str="float32")
SETTINGS = {
    "local_widths_margin": ({**TINY, "embed_dim": 32, "temporal_layers": 1,
                             "neg_nce_margin": 0.1, "neg_nce_weight": 1.5}, 4, 3, 12),
    "two_heads_of_64": ({**TINY, "embed_dim": 128, "temporal_layers": 2}, 3, 4, 10),
}
OUTPUTS = ("l1_simi", "l3_simi", "text_embed", "visual_embed", "wti_text_tokens",
           "wti_text_weights", "wti_video_tokens", "wti_video_weights")


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _wti_inputs(seed=0, Bt=5, Bv=4, Lt=7, Lv=6, D=8):
    rng = np.random.default_rng(seed)
    tt, vt = _unit(rng, Bt, Lt, D), _unit(rng, Bv, Lv, D)
    tm = (np.arange(Lt)[None] < rng.integers(2, Lt + 1, Bt)[:, None]).astype(np.int64)
    vm = (np.arange(Lv)[None] < rng.integers(1, Lv + 1, Bv)[:, None]).astype(np.int64)
    vt[:, :] = np.where(vm[..., None] > 0, vt, 0.3)  # padding carries values the mask must drop
    tt[0, 0] = -vt[:, 0].mean(0) / np.linalg.norm(vt[:, 0].mean(0))  # a word against the frames

    def softmax(x, m):
        x = np.where(m > 0, x, -np.inf)
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    tw, vw = softmax(rng.normal(size=(Bt, Lt)), tm), softmax(rng.normal(size=(Bv, Lv)), vm)
    return tt, tw, vt, vw, tm, vm


def test_wti_similarity_matches_jax():
    tt, tw, vt, vw, tm, vm = _wti_inputs()
    j_val, j_grads = jax.value_and_grad(
        lambda *a: (j_wti(*a, jnp.asarray(tm), jnp.asarray(vm)) ** 2).sum(),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (tt, tw, vt, vw)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (tt, tw, vt, vw)]
    sim = t_wti(*leaves, torch.from_numpy(tm), torch.from_numpy(vm))
    (sim ** 2).sum().backward()
    np.testing.assert_allclose(sim.detach().numpy(),
                               np.asarray(j_wti(*map(jnp.asarray, (tt, tw, vt, vw, tm, vm)))),
                               atol=GRID_ATOL, rtol=0)
    np.testing.assert_allclose((sim ** 2).sum().item(), float(j_val), atol=GRID_ATOL, rtol=0)
    for leaf, jg in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), atol=GRID_ATOL, rtol=0)


def test_wti_grid_matches_jax_and_the_model():
    tt, tw, vt, vw, tm, vm = _wti_inputs(seed=1, Bt=7, Bv=5)
    w = {"wti_text_tokens": tt, "wti_text_weights": tw, "wti_video_tokens": vt,
         "wti_video_weights": vw, "wti_text_mask": tm.astype(np.float32),
         "wti_video_mask": vm.astype(np.float32)}
    rows = np.array([4, 0, 2, 3])  # deduplicated videos, out of order
    port = TRetrieval._wti_grid(w, rows, chunk=3)  # chunks of 3, 3, 1 texts
    np.testing.assert_allclose(port, JRetrieval._wti_grid(w, rows, chunk=256), atol=GRID_ATOL,
                               rtol=0)
    direct = t_wti(*(torch.from_numpy(x) for x in (tt, tw, vt[rows], vw[rows], tm, vm[rows])))
    np.testing.assert_allclose(port, direct.numpy(), atol=GRID_ATOL, rtol=0)


def test_token_weight_head_matches_jax():
    rng = np.random.default_rng(2)
    tokens = rng.normal(size=(3, 9, 16)).astype(np.float32)
    mask = (np.arange(9)[None] < np.array([9, 4, 1])[:, None]).astype(np.int64)
    head = JWeight()
    params = jax.jit(head.init)(jax.random.PRNGKey(0), tokens, mask)["params"]
    j_out, j_vjp = jax.vjp(lambda p, x: head.apply({"params": p}, x, mask), params,
                           jnp.asarray(tokens))
    cot = rng.normal(size=j_out.shape).astype(np.float32)
    j_gp, j_gx = j_vjp(jnp.asarray(cot))
    port = TWeight(16)
    load_flax_params(port, params)
    x = torch.tensor(tokens, requires_grad=True)
    out = port(x, torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), atol=ATOL, rtol=0)
    assert (out.detach().numpy()[mask == 0] == 0).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_gx), atol=ATOL, rtol=0)
    paths = flax_paths(port)
    flat = flatten_flax(jax.device_get(j_gp))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), to_torch_layout(paths[name], flat[paths[name]]),
                                   atol=ATOL, rtol=0, err_msg=name)


def _batch(B, F, L, seed):
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 4, L - 7, L - 2][:B])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    video_mask = np.ones((B, F), np.int64)
    video_mask[1, -1] = 0  # a padded frame
    return {"image_data": rng.random((B, F, 32, 32, 3), dtype=np.float32),
            "video_mask": video_mask,
            "caption_input_ids": rng.integers(1, 30522, (B, L)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, L), np.int64)}


def _config(model):
    return {"model_attributes": {"dmae_retrieval": model}}


@pytest.fixture(scope="module", params=list(SETTINGS))
def runs(request):
    model, B, F, L = SETTINGS[request.param]
    batch = _batch(B, F, L, seed=len(request.param))
    shell = j_build(_config(model))
    abstract = jax.eval_shape(shell.init, jax.random.PRNGKey(0), batch)["params"]
    port = t_build(_config(model), device="cpu")
    port.init(len(request.param))
    params = export_flax_params(port.module)
    shapes = {"/".join(str(k.key) for k in path): tuple(v.shape)
              for path, v in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    assert {p: v.shape for p, v in flatten_flax(params).items()} == shapes

    def loss_of(p):
        total, (output, scalars) = shell.loss_fn({"params": p}, batch, deterministic=False)
        return total, ({k: output[k] for k in OUTPUTS}, scalars)

    (_, (j_out, j_scalars)), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    load_flax_params(port.module, params)
    t_total, (t_out, t_scalars) = port.loss_fn(batch, deterministic=False)
    t_total.backward()
    return dict(j_out=jax.device_get(j_out), j_scalars=jax.device_get(j_scalars),
                j_grads=flatten_flax(jax.device_get(j_grads)), t_out=t_out,
                t_scalars=t_scalars, port=port)


def test_dmae_outputs_match_jax(runs):
    for key in OUTPUTS:
        np.testing.assert_allclose(runs["t_out"][key].detach().numpy(), runs["j_out"][key],
                                   atol=ATOL, rtol=0, err_msg=key)
    for key in ("wti_text_mask", "wti_video_mask"):
        assert key in runs["t_out"]


def test_dmae_losses_match_jax(runs):
    assert sorted(runs["t_scalars"]) == sorted(runs["j_scalars"])
    for key, ref in runs["j_scalars"].items():
        got = runs["t_scalars"][key].item()
        assert np.isfinite(got), key
        np.testing.assert_allclose(got, float(ref), atol=ATOL, rtol=0, err_msg=key)


def test_dmae_gradients_match_jax(runs):
    module = runs["port"].module
    paths = flax_paths(module)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in runs["j_grads"].values())
    for name, p in module.named_parameters():
        ref = to_torch_layout(paths[name], runs["j_grads"][paths[name]])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        tol = max(GRAD_RTOL * np.abs(ref).max(), floor)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)


def test_dmae_dropout_raises():
    """Dropout is ported: 0.1 reaches both towers; the temporal encoder,
    which JAX builds without it, keeps 0."""
    from antmmf_torch.modules.layers import Dropout

    module = t_build(_config({**TINY, "embed_dim": 32, "dropout": 0.1}), device="cpu").module
    for tower, rate in ((module.base.img_encoder, 0.1), (module.base.text_encoder, 0.1),
                        (module.temporal_encoder, 0.0)):
        assert {m.rate for m in tower.modules() if isinstance(m, Dropout)} == {rate}
