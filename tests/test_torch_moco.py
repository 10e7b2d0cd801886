"""MoCo in the port against the JAX package, on the CPU.

* The queue ops: ``init_queue``, ``enqueue`` (a ring write that wraps
  modulo K, ``filled`` capped at K) and ``queue_negatives`` exactly as
  JAX's; ``momentum_update`` at atol 1e-7; the port's own random queue has
  unit-norm rows (atol 1e-6) and ``filled`` = K.
* ``univl_retrieval`` with a queue at the tiny presets, fp32, JAX's
  variables (params and the ``moco`` collection) carried by
  ``load_flax_variables``: the loss and every parameter's gradient at atol
  1e-5, then the queues after the enqueue at atol 1e-5 with ``ptr`` and
  ``filled`` exact, for four settings: random queues with the online
  embeddings as keys; keys injected in the batch (``_moco_key_text`` /
  ``_moco_key_video``); a queue partly filled whose write wraps; an empty
  queue (every negative masked: the loss is 0, never NaN). A forward with
  ``deterministic=True`` leaves the queues as they are.
The trainer's MoCo state is held against JAX in
``tests/test_torch_moco_trainer.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules import moco as t_moco
from antmmf_torch.utils.weights import (
    flatten_flax,
    flax_paths,
    load_flax_variables,
    to_torch_layout,
)
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.modules import moco as j_moco
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ATOL, QUEUE_ATOL = 1e-5, 1e-5
TINY = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
            embed_dim=16, dtype_str="float32", with_queue=True)


# ------------------------------------------------------------------- queue ops
def _jax_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_queue_ops_match_jax_exactly():
    rng = np.random.default_rng(0)
    j_state = j_moco.init_queue(8, 4)
    t_state = t_moco.init_queue(8, 4)
    for k in ("queue", "ptr", "filled"):
        assert np.array_equal(t_state[k].numpy(), np.asarray(j_state[k])), k
    for step in range(5):  # 3 keys a step into 8 slots: wraps at steps 2 and 5
        keys = rng.normal(size=(3, 4)).astype(np.float32)
        j_state = j_moco.enqueue(j_state, jnp.asarray(keys))
        t_moco.enqueue(t_state, torch.from_numpy(keys))
        j = _jax_state(j_state)
        assert np.array_equal(t_state["queue"].numpy(), j["queue"]), step
        assert int(t_state["ptr"]) == int(j["ptr"]) and int(t_state["filled"]) == int(j["filled"])
        t_negs, t_valid = t_moco.queue_negatives(t_state)
        j_negs, j_valid = j_moco.queue_negatives(j_state)
        assert np.array_equal(t_valid.numpy(), np.asarray(j_valid))
        assert np.array_equal(t_negs.numpy(), np.asarray(j_negs))
    assert int(t_state["filled"]) == 8 and int(t_state["ptr"]) == 15 % 8


def test_momentum_update_matches_jax():
    rng = np.random.default_rng(1)
    m = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), ())]
    p = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), ())]
    j = j_moco.momentum_update([jnp.asarray(x) for x in m], [jnp.asarray(x) for x in p], 0.99)
    t = [torch.from_numpy(x.copy()) for x in m]
    t_moco.momentum_update(t, [torch.from_numpy(x) for x in p], 0.99)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)


def test_port_random_queue_has_unit_rows():
    state = t_moco.init_queue(4096, 512, random_init=True,
                              generator=torch.Generator().manual_seed(1))
    norms = torch.linalg.vector_norm(state["queue"], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6, rtol=0)
    assert int(state["filled"]) == 4096 and int(state["ptr"]) == 0
    assert state["queue"].std().item() > 0.03  # not a constant row


# --------------------------------------------------------------------- model
def _batch(B=4, F=2, size=32, L=12, seed=3):
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 3, L - 6, L - 1][:B])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.random((B, F, size, size, 3), dtype=np.float32),
            "video_mask": np.ones((B, F), np.int64),
            "caption_input_ids": rng.integers(1, 30522, (B, L)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, L), np.int64)}


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _setting(name):
    """(model attributes, batch, moco collection override or None)."""
    rng = np.random.default_rng(len(name))
    batch = _batch()
    if name == "random_queue_online_keys":
        return {**TINY, "with_momentum": True, "queue_size": 32}, batch, None
    if name == "injected_keys":
        batch["_moco_key_text"] = _unit_rows(rng, 4, 16)
        batch["_moco_key_video"] = _unit_rows(rng, 4, 16)
        return {**TINY, "with_momentum": True, "queue_size": 32}, batch, None
    if name == "partial_queue_wrapping":
        def queue():
            q = np.zeros((6, 16), np.float32)
            q[:5] = _unit_rows(rng, 5, 16)
            return {"queue": q, "ptr": np.int32(5), "filled": np.int32(5)}
        return {**TINY, "queue_size": 6}, batch, {"text_queue": queue(), "video_queue": queue()}
    return {**TINY, "queue_size": 8}, batch, None  # empty: every negative masked


SETTINGS = ["random_queue_online_keys", "injected_keys", "partial_queue_wrapping", "empty_queue"]


@pytest.fixture(scope="module", params=SETTINGS)
def model_run(request):
    model, batch, override = _setting(request.param)
    config = {"model_attributes": {"univl_retrieval": model}}
    shell = j_build(config)
    variables = jax.device_get(shell.init(jax.random.PRNGKey(0), batch))
    variables = {"params": variables["params"],
                 "moco": override if override is not None else variables["moco"]}

    j_vars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss_of(params):
        total, (output, scalars) = shell.loss_fn({**j_vars, "params": params}, batch,
                                                 deterministic=False)
        return total, output["_updated_collections"]["moco"]

    (j_loss, j_moco_new), j_grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        j_vars["params"])

    port = t_build(config, device="cpu")
    load_flax_variables(port.module, variables)
    before = {k: v.clone() for k, v in t_moco.queue_buffers(port.module).items()}
    with torch.no_grad():
        port.module({k: torch.as_tensor(v) for k, v in batch.items()}, deterministic=True)
    unchanged = all(torch.equal(before[k], v) for k, v in t_moco.queue_buffers(port.module).items())
    t_loss, _ = port.loss_fn(batch, deterministic=False)
    t_loss.backward()
    port.module.flush_queues()
    return dict(name=request.param, j_loss=float(j_loss), j_moco=jax.device_get(j_moco_new),
                j_grads=flatten_flax(jax.device_get(j_grads)), port=port,
                t_loss=t_loss.item(), eval_unchanged=unchanged)


def test_moco_loss_matches_jax(model_run):
    assert np.isfinite(model_run["t_loss"])
    np.testing.assert_allclose(model_run["t_loss"], model_run["j_loss"], atol=ATOL, rtol=0)
    if model_run["name"] == "empty_queue":
        assert model_run["t_loss"] == 0.0


def test_moco_gradients_match_jax(model_run):
    module = model_run["port"].module
    paths = flax_paths(module)
    for name, p in module.named_parameters():
        ref = to_torch_layout(paths[name], model_run["j_grads"][paths[name]])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=name)


def test_enqueue_matches_jax(model_run):
    assert model_run["eval_unchanged"], "a deterministic forward changed a queue"
    flat = flatten_flax(model_run["j_moco"])
    for path, t in t_moco.queue_buffers(model_run["port"].module).items():
        if path.endswith("queue"):
            np.testing.assert_allclose(t.numpy(), flat[path], atol=QUEUE_ATOL, rtol=0,
                                       err_msg=path)
        else:
            assert int(t) == int(flat[path]), path
