"""The port's contrastive losses against the JAX package's, on the CPU.

``cross_en``/``symmetric_cross_en``, ``mil_nce``, ``neg_nce``,
``neg_nce_dmae`` and ``moco_nce`` on seeded fp32 similarity matrices, and
the gradient of each with respect to its inputs, at atol 1e-6 (fp32 on both
sides; only the order of the sums differs), the gradients at 1e-6 of their
largest entry where that exceeds 1 (DMAE's NegNCE at logit scale 100
multiplies them by 100). The cases cover a row with no
positive (``mil_nce`` masks it out, and an all-empty mask gives 0), a
matrix with no hard negative (``neg_nce`` keeps only the positive), ties at
the margin (a negative exactly ``margin`` below the positive counts as hard
in both packages) and DMAE's NegNCE with no hard negative (``n_hard``
floored at 1). Also ``clip_similarity``'s clamp of the logit scale to
[1, 100] against the JAX model's ``similarity`` on both sides of the clamp
(similarities and gradients at 1e-6 of their largest entry).
Every loss and gradient is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.univl import clip_similarity
from antmmf_torch.modules.losses import contrastive as T
from antmmf_tpu.models.univl import UnivlForVideoTextRetrieval as JUnivl
from antmmf_tpu.modules.losses import contrastive as J
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL = 1e-6


def _sim(seed, n=6, m=6, spread=3.0):
    return np.random.default_rng(seed).normal(0.0, spread, (n, m)).astype(np.float32)


def _both(t_fn, j_fn, *arrays):
    """(port value, port grads, JAX value, JAX grads) w.r.t. every array."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    t_val = t_fn(*leaves)
    t_val.backward()
    j_val, j_grads = jax.value_and_grad(j_fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    # a detached input (MoCo's key and queue) has no gradient: JAX's is 0
    return (t_val.item(), [np.zeros(x.shape, np.float32) if x.grad is None else x.grad.numpy()
                           for x in leaves], float(j_val),
            [np.asarray(g) for g in j_grads])


def _check(t_fn, j_fn, *arrays):
    t_val, t_grads, j_val, j_grads = _both(t_fn, j_fn, *arrays)
    assert np.isfinite(t_val) and all(np.isfinite(g).all() for g in t_grads)
    np.testing.assert_allclose(t_val, j_val, atol=ATOL, rtol=0)
    for tg, jg in zip(t_grads, j_grads):
        np.testing.assert_allclose(tg, jg, atol=ATOL * max(1.0, np.abs(jg).max()), rtol=0)
    return t_val


@pytest.mark.parametrize("shape", [(6, 6), (4, 7)])
def test_cross_en_and_symmetric_match_jax(shape):
    sim = _sim(1, *shape)
    _check(lambda s: T.cross_en(s), lambda s: J.cross_en(s), sim)
    _check(lambda s: T.cross_en(s, dim=-2), lambda s: J.cross_en(s, axis=-2), sim)
    if shape[0] == shape[1]:
        _check(T.symmetric_cross_en, J.symmetric_cross_en, sim)


def _masks():
    rng = np.random.default_rng(7)
    mask = (rng.random((6, 8)) < 0.3).astype(np.float32)
    mask[np.arange(6), np.arange(6)] = 1.0
    mask[2] = 0.0  # a row with no positive
    return {"identity": np.eye(6, 8, dtype=np.float32), "multi_and_empty_row": mask,
            "all_empty": np.zeros((6, 8), np.float32)}


@pytest.mark.parametrize("name", list(_masks()))
def test_mil_nce_matches_jax(name):
    mask = _masks()[name]
    sim = _sim(2, 6, 8)
    value = _check(lambda s: T.mil_nce(s, torch.from_numpy(mask)),
                   lambda s: J.mil_nce(s, jnp.asarray(mask)), sim)
    if name == "all_empty":
        assert value == 0.0


def _neg_nce_cases():
    rng = np.random.default_rng(3)
    sim = rng.normal(0.0, 1.0, (6, 6)).astype(np.float32)
    no_hard = sim - 10.0 * (1 - np.eye(6, dtype=np.float32))  # every negative far below
    tie = sim.copy()
    tie[0, 3] = tie[0, 0] - 0.25  # exactly the margin below the positive
    tie[4, 1] = tie[4, 4] - 0.25
    return {"margin_0": (sim, 0.0, 1.0), "margin_weighted": (sim, 0.5, 2.5),
            "no_hard_negative": (no_hard, 0.2, 1.5), "tie_at_margin": (tie, 0.25, 2.0)}


@pytest.mark.parametrize("name", list(_neg_nce_cases()))
def test_neg_nce_matches_jax(name):
    sim, margin, weight = _neg_nce_cases()[name]
    _check(lambda s: T.neg_nce(s, margin, weight), lambda s: J.neg_nce(s, margin, weight), sim)
    _check(lambda s: T.neg_nce(s.T, margin, weight), lambda s: J.neg_nce(s.T, margin, weight),
           sim)


@pytest.mark.parametrize("name,scale,c_neg", [("margin_0", 1.0, 0.5),
                                              ("margin_weighted", 1.0, 1.5),
                                              ("no_hard_negative", 1.0, 1.5),
                                              ("tie_at_margin", 100.0, 0.5)])
def test_neg_nce_dmae_matches_jax(name, scale, c_neg):
    sim, margin, _ = _neg_nce_cases()[name]
    kw = dict(logit_scale=scale, c_neg=c_neg, margin=margin)
    _check(lambda s: T.neg_nce_dmae(s, **kw), lambda s: J.neg_nce_dmae(s, **kw), sim)
    _check(lambda s: 0.5 * (T.neg_nce_dmae(s, **kw) + T.neg_nce_dmae(s.T, **kw)),
           lambda s: 0.5 * (J.neg_nce_dmae(s, **kw) + J.neg_nce_dmae(s.T, **kw)), sim)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("temperature", [0.07, 1.0])
def test_moco_nce_matches_jax(temperature):
    rng = np.random.default_rng(5)
    q, k, queue = _unit(rng, 4, 16), _unit(rng, 4, 16), _unit(rng, 32, 16)
    _check(lambda a, b, c: T.moco_nce(a, b, c, temperature),
           lambda a, b, c: J.moco_nce(a, b, c, temperature), q, k, queue)


@pytest.mark.parametrize("logit_scale", [-0.5, 2.6592, 5.0])
def test_clip_similarity_clamp_matches_jax(logit_scale):
    """exp(logit_scale) clamped to [1, 100], below, inside and above."""
    rng = np.random.default_rng(11)
    text, clips = _unit(rng, 5, 16), _unit(rng, 3, 2, 16)
    model = JUnivl(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", embed_dim=16)

    def j_fn(ls, t, c):
        sim = model.apply({"params": {"logit_scale": ls}}, t, c, method=JUnivl.similarity)
        return sim.sum(), sim

    (_, j_sim), j_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.float32(logit_scale), jnp.asarray(text), jnp.asarray(clips))
    leaves = [torch.tensor(np.float32(logit_scale), requires_grad=True),
              torch.tensor(text, requires_grad=True), torch.tensor(clips, requires_grad=True)]
    t_sim = clip_similarity(leaves[1], leaves[2], leaves[0])
    t_sim.sum().backward()
    j_sim = np.asarray(j_sim)
    np.testing.assert_allclose(t_sim.detach().numpy(), j_sim,
                               atol=ATOL * max(1.0, np.abs(j_sim).max()), rtol=0)
    for leaf, jg in zip(leaves, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, atol=ATOL * max(1.0, np.abs(jg).max()),
                                   rtol=0)
