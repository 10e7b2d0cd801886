"""Attentive MLM masking in the port against the JAX package, on the CPU.

* ``BertEncoder.word_importance`` (over the layers, the sum of each layer's
  head-mean attention column mass) at the tiny preset, ragged masks, fp32:
  atol 1e-5.
* ``univl_pretrain``'s attentive masking with the draws fixed: JAX draws
  the Gumbel noise and the step's coin from its ``dropout`` stream, the
  port from the trainer's generator, so the test hands JAX's uniforms and
  coin to both (``jax.random.uniform``/``bernoulli`` replaced on the JAX
  side, ``attentive_draws`` on the port's, as FOM's tests fix the
  permutation). Ids and labels are equal exactly, for both branches of the
  coin, with and without the processor's labels, on rows with fewer live
  tokens than ``n_mask`` (L=30 gives 4): their ``finfo.min`` ties go to the
  lowest index in both top-k's and are then removed as special.
* The ``univl_pretrain`` losses in training with ``attentive_masking`` and
  the draws fixed: every term, metric and ``total_loss`` at atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules.encoders.text_encoder import BertEncoder as TBert
from antmmf_torch.utils.text_utils import top_k
from antmmf_torch.utils.weights import export_flax_params, load_flax_params
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.models.univl_pretrain import UnivlForVideoPretraining as JPretrain
from antmmf_tpu.modules.encoders.text_encoder import BertEncoder as JBert
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL = 1e-5
B, L, N_MASK = 4, 30, 4
LENGTHS = [30, 12, 5, 3]  # rows 2 and 3: 3 and 1 live tokens, fewer than N_MASK
MODEL = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
             embed_dim=32, dtype_str="float32", attentive_masking=True)


def _caption(seed):
    """[CLS] tokens [SEP] then padding, the processor's ids and labels (about
    a quarter of the real tokens masked) and the raw ids."""
    rng = np.random.default_rng(seed)
    lens = np.array(LENGTHS)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    raw = rng.integers(1000, 30000, (B, L)) * mask
    raw[:, 0] = 101
    raw[np.arange(B), lens - 1] = 102
    pick = (rng.random((B, L)) < 0.25) & (mask > 0) & (raw != 101) & (raw != 102)
    return dict(raw=raw, mask=mask, seg=np.zeros((B, L), np.int64),
                ids=np.where(pick, 103, raw), labels=np.where(pick, raw, -1))


def _uniform(seed):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (B, L), minval=1e-9,
                                         maxval=1.0))


def test_word_importance_matches_jax():
    c = _caption(0)
    j_bert = JBert(hidden_size=64, num_layers=2, num_heads=2, dtype=jnp.float32)
    variables = jax.jit(j_bert.init)(jax.random.PRNGKey(0), c["raw"])
    t_bert = TBert(hidden_size=64, num_layers=2, num_heads=2, dtype=torch.float32)
    load_flax_params(t_bert, variables["params"])
    j_imp = j_bert.apply(variables, c["raw"], c["mask"], c["seg"], method=JBert.word_importance)
    with torch.no_grad():
        t_imp = t_bert.word_importance(*(torch.tensor(c[k]) for k in ("raw", "mask", "seg")))
    assert t_imp.dtype == torch.float32 and t_imp.shape == (B, L)
    np.testing.assert_allclose(t_imp.numpy(), np.asarray(j_imp), atol=ATOL, rtol=0)
    # a column's mass over 2 layers of queries: each layer's rows sum to L
    np.testing.assert_allclose(t_imp.sum(-1).numpy(), np.full(B, 2.0 * L), rtol=1e-5)
    assert (t_imp[:, 1:][torch.tensor(c["mask"][:, 1:]) == 0] < 1e-6).all()  # padding


@pytest.fixture(scope="module")
def models():
    """The JAX model and the port's on the port's seeded init."""
    config = {"model_attributes": {"univl_pretrain": MODEL}}
    port = t_build(config, device="cpu")
    port.init(0)
    return j_build(config), port, export_flax_params(port.module)


def _fixed(mp, uniform, coin):
    mp.setattr(jax.random, "uniform", lambda key, shape, minval=0.0, maxval=1.0, **kw:
               jnp.asarray(uniform))
    mp.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.asarray(coin))


@pytest.mark.parametrize("coin,with_labels", [(True, True), (False, True), (True, False)])
def test_masked_ids_and_labels_equal_jax(models, coin, with_labels):
    j_shell, port, params = models
    c = _caption(1)
    uniform = _uniform(2)
    labels = c["labels"] if with_labels else None
    with pytest.MonkeyPatch.context() as mp:
        _fixed(mp, uniform, coin)
        j_ids, j_labels = j_shell.module.apply(
            {"params": params}, c["raw"], c["mask"], c["seg"], c["ids"], labels,
            method=JPretrain._attentive_mask, rngs={"dropout": jax.random.PRNGKey(3)})
    module = port.module
    module.attentive_draws = lambda B_, L_, device, generator: (
        torch.tensor(uniform), torch.tensor(coin))
    try:
        t_ids, t_labels = module.attentive_mask(
            *(torch.tensor(c[k]) for k in ("raw", "mask", "seg", "ids")),
            None if labels is None else torch.tensor(labels), None)
    finally:
        del module.attentive_draws
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(j_labels))
    if coin:  # the attentive branch: n_mask a full row, never a special token
        chosen = t_labels.numpy() >= 0
        np.testing.assert_array_equal(chosen.sum(1), [N_MASK, N_MASK, 3, 1])
        assert not (chosen & np.isin(c["raw"], (101, 102, 0))).any()
        assert (t_ids.numpy()[chosen] == 103).all()
    else:
        np.testing.assert_array_equal(t_ids.numpy(), c["ids"])
        np.testing.assert_array_equal(t_labels.numpy(), c["labels"])


def test_finfo_min_ties_take_the_lowest_index():
    scores = np.full((2, 10), np.finfo(np.float32).min, np.float32)
    scores[0, [3, 7]] = [0.5, 1.5]
    scores[1, 9] = -1.0
    _, j_pos = jax.lax.top_k(jnp.asarray(scores), N_MASK)
    _, t_pos = top_k(torch.tensor(scores), N_MASK)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(t_pos.numpy(), [[7, 3, 0, 1], [9, 0, 1, 2]])


def test_pretrain_losses_with_the_draws_fixed_equal_jax(models):
    j_shell, port, params = models
    c = _caption(4)
    rng = np.random.default_rng(5)
    batch = {"image_data": rng.random((B, 2, 32, 32, 3), dtype=np.float32),
             "caption_input_ids": c["ids"], "caption_input_mask": c["mask"],
             "caption_segment_ids": c["seg"], "caption_lm_label_ids": c["labels"],
             "caption_raw_input_ids": c["raw"]}
    uniform = _uniform(6)
    with pytest.MonkeyPatch.context() as mp:
        _fixed(mp, uniform, True)
        _, (_, j_scalars) = j_shell.loss_fn({"params": params}, batch, deterministic=False,
                                            rngs={"dropout": jax.random.PRNGKey(7)})
    load_flax_params(port.module, params)
    port.module.attentive_draws = lambda B_, L_, device, generator: (
        torch.tensor(uniform), torch.tensor(True))
    try:
        _, (_, t_scalars) = port.loss_fn(batch, deterministic=False)
    finally:
        del port.module.attentive_draws
    assert sorted(t_scalars) == sorted(j_scalars)
    for key, ref in j_scalars.items():
        np.testing.assert_allclose(float(t_scalars[key]), float(ref), atol=ATOL, rtol=0,
                                   err_msg=key)
    assert float(t_scalars["losses/masked_lm_loss"]) > 0


def test_draws_come_from_the_generator(models):
    """The same generator state gives the same masked ids; evaluation masks
    nothing beyond the processor."""
    _, port, _ = models
    c = _caption(8)
    args = [torch.tensor(c[k]) for k in ("raw", "mask", "seg", "ids", "labels")]
    outs = [port.module.attentive_mask(*args, torch.Generator().manual_seed(s))
            for s in (11, 11, 12)]
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
    uniform, coin = port.module.attentive_draws(B, L, "cpu", torch.Generator().manual_seed(0))
    assert uniform.min() >= 1e-9 and uniform.max() < 1.0 and coin.dtype == torch.bool
