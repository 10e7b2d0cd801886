"""The int8 KV cache and ``extend_cache`` against the JAX package, on the CPU.

``quantize_kv`` is JAX's bit for bit; the cache a prefill and decode steps
write holds exactly ``quantize_kv`` of the keys and values the float cache
holds, slot by slot, at each row's own slots; decode over the int8 cache
matches JAX's (atol 1e-4 on hidden states of spread ~1 after two fp32
layers, as the float cache's tests). Pink's and M2-omni's greedy
``generate`` with ``kv_int8`` give JAX's tokens exactly, and their
``extend_cache`` (ragged turns appended from per-row slots; M2-omni's RoPE
continuation apart from its slot) JAX's logits within atol 1e-4 and its new
positions exactly. Tiny presets in fp32, JAX's params drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.m2_omni import M2Omni as TM
from antmmf_torch.models.pink import PinkModel as TPink
from antmmf_torch.modules import llm as t_llm
from antmmf_torch.utils.weights import load_flax_params
from antmmf_tpu.models.m2_omni import M2Omni as JM
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.modules import llm as j_llm
from test_torch_m2omni import load_reached
from test_torch_qwen2_vit import random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

F32 = torch.float32
ATOL = 1e-4
TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            lora_rank=2, dtype_str="float32")


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_quantize_kv_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 7, 32)) * np.array([1e-3, 1.0, 50.0])[None, :, None, None]
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale's floor
    x[1, 2, 3, :4] = [127.5, -0.5, 1.5, 2.5]  # ties round to even
    q, scale = t_llm.quantize_kv(torch.from_numpy(x))
    jq, jscale = j_llm.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.shape == (2, 3, 7, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("num_kv_heads", [1, 2])
def test_int8_cache_contents_and_decode_match_jax(num_kv_heads):
    """Ragged prompts (4 and 6 of 10 slots), then three single-token steps at
    each row's own slot."""
    rng = np.random.default_rng(3)
    B, L, C, T = 2, 10, 128, 13
    embeds = rng.standard_normal((B, L, C)).astype(np.float32)
    positions = np.broadcast_to(np.arange(L)[None], (B, L)).copy()
    lens = np.array([4, 6])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    jm = j_llm.DecoderLM(num_layers=2, num_heads=4, num_kv_heads=num_kv_heads, lora_rank=2,
                         dtype=jnp.float32)
    variables = {"params": random_params(jm, embeds, positions, seed=4)}
    port = t_llm.DecoderLM(C, 2, 4, num_kv_heads, lora_rank=2, dtype=F32)
    load_flax_params(port, variables["params"])
    port.eval()
    steps = rng.standard_normal((3, B, 1, C)).astype(np.float32)
    with torch.no_grad():
        caches = {q: port.make_cache(B, T, quantized=q) for q in (False, True)}
        for q, cache in caches.items():
            port(torch.from_numpy(embeds), torch.from_numpy(positions), torch.from_numpy(mask),
                 cache=cache)
        j_cache = j_llm.init_decoder_cache(2, B, num_kv_heads, T, 32, jnp.float32,
                                           quantized=True)
        j_prefill = jax.jit(lambda c: jm.apply(variables, embeds, positions, mask, True, cache=c))
        j_step = jax.jit(lambda x, p, c: jm.apply(variables, x, p[:, None], None, True, cache=c,
                                                  decode_pos=p))
        _, j_cache = j_prefill(j_cache)
        for t, x in enumerate(steps):
            pos = lens + t
            outs = {q: port(torch.from_numpy(x), torch.from_numpy(pos)[:, None], cache=cache,
                            decode_pos=torch.from_numpy(pos))[0] for q, cache in caches.items()}
            j_out, j_cache = j_step(x, pos, j_cache)
            close(outs[True], j_out)
            assert 0 < float((outs[True] - outs[False]).abs().max()) < 0.1
    # the float cache holds the same keys and values wherever they do not
    # depend on the cache read: every prefill slot, and layer 0's decode slots
    slot = np.arange(T)[None, None, :, None]
    decoded = (slot >= lens[:, None, None, None]) & (slot < lens[:, None, None, None] + 3)
    for i, (layer, float_layer, j_layer) in enumerate(zip(caches[True], caches[False], j_cache)):
        assert set(layer) == set(j_layer) == {"k", "k_scale", "v", "v_scale"}
        same = (slot < L) & (~decoded if i else True)
        for name in ("k", "v"):
            q, scale = j_llm.quantize_kv(jnp.asarray(float_layer[name].numpy()))
            got_q, got_scale = layer[name].numpy(), layer[f"{name}_scale"].numpy()
            np.testing.assert_array_equal(np.where(same, got_q, 0), np.where(same, q, 0))
            np.testing.assert_array_equal(np.where(same, got_scale, 0),
                                          np.where(same, scale, 0))
            assert not got_q[..., L:, :].any()  # no write past the prompt and steps
            close(layer[f"{name}_scale"], j_layer[f"{name}_scale"], 1e-5)
            assert np.abs(got_q.astype(int) - np.asarray(j_layer[name]).astype(int)).max() <= 1


@pytest.fixture(scope="module")
def pink_int8():
    rng = np.random.default_rng(7)
    batch = {"input_ids": np.array([[5, 6, 7, 8, 0, 0], [9, 10, 11, 12, 13, 14]], np.int64),
             "input_mask": np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int64),
             "image_data": rng.standard_normal((2, 32, 32, 3)).astype(np.float32)}
    jm = JPink(**TINY, kv_int8=True)
    params = random_params(jm, batch, seed=7)
    tm = TPink(**TINY, kv_int8=True, device="cpu")
    load_flax_params(tm, params)
    return jm, {"params": params}, tm.eval(), batch


def test_pink_generate_with_int8_cache_matches_jax(pink_int8):
    jm, variables, tm, batch = pink_int8
    want, want_lens = jm.generate(variables, batch, eos_id=1, max_length=5)
    got, lens = tm.generate({k: torch.as_tensor(v) for k, v in batch.items()}, eos_id=1,
                            max_length=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))


def test_pink_extend_cache_matches_jax(pink_int8):
    """A ragged turn (3 and 2 valid of 3 tokens) appended at each row's own
    slot over the int8 cache (the float cache's extends are held to the JAX
    engine's tokens in ``test_torch_serving_engine.py``)."""
    jm, variables, tm, batch = pink_int8
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    lens = batch["input_mask"].sum(-1)
    turn = np.array([[20, 21, 22], [23, 24, 0]], np.int64)
    tmask = (turn != 0).astype(np.int64)
    start = 4 + lens  # 4 vision tokens
    j_cache = j_llm.init_decoder_cache(2, 2, 1, 16, 32, jnp.float32, quantized=True)
    _, j_cache = jax.jit(lambda c: jm.apply(variables, batch, c, lens,
                                            method=JPink.prefill))(j_cache)
    want, _, want_start = jax.jit(lambda c: jm.apply(variables, turn, tmask, start, c,
                                                     method=JPink.extend_cache))(j_cache)
    with torch.no_grad():
        _, cache = tm.prefill(tb, tm.make_cache(2, 16), torch.as_tensor(lens))
        got, _, new_start = tm.extend_cache(torch.as_tensor(turn), torch.as_tensor(tmask),
                                            torch.as_tensor(start), cache)
    assert cache[0]["k"].dtype == torch.int8
    close(got, want)
    np.testing.assert_array_equal(new_start.numpy(), np.asarray(want_start))


@pytest.fixture(scope="module")
def m2_int8():
    ids = np.array([[5] + [3] * 4 + [6, 7, 8, 0, 0], [9] + [3] * 4 + [10, 11, 12, 13, 14]],
                   np.int64)
    batch = {"input_ids": ids, "input_mask": (ids != 0).astype(np.int64),
             "image_data": np.random.default_rng(6).standard_normal(
                 (2, 1, 32, 32, 3)).astype(np.float32)}
    kw = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
              image_token_id=3, dtype_str="float32", kv_int8=True)
    jm = JM(**kw, audio_token_id=None)
    params = random_params(jm, batch, seed=6)
    tm = TM(**kw, device="cpu")
    load_reached(tm, params)
    return jm, {"params": params}, tm.eval(), batch


def test_m2omni_generate_with_int8_cache_matches_jax(m2_int8):
    jm, variables, tm, batch = m2_int8
    want, want_lens = jm.generate(variables, batch, eos_id=1, max_length=4)
    got, lens = tm.generate({k: torch.as_tensor(v) for k, v in batch.items()}, eos_id=1,
                            max_length=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))


def test_m2omni_extend_cache_matches_jax(m2_int8):
    """A ragged text turn appended at RoPE ``next_p`` from cache slot
    ``lens_full``: the two advance together by the turn's length, 2 apart
    (the image run's 2x2 grid)."""
    jm, variables, tm, batch = m2_int8
    turn = np.array([[20, 21, 22], [23, 0, 0]], np.int64)
    tmask = (turn != 0).astype(np.int64)
    _, j_cache, j_lens, j_next = jax.jit(lambda: jm.apply(variables, batch, 3,
                                                         method=JM.prefill))()
    want, _, want_rope, want_slot = jax.jit(lambda c: jm.apply(
        variables, turn, tmask, j_next, j_lens, c, method=JM.extend_cache))(j_cache)
    with torch.no_grad():
        _, cache, lens_full, next_p = tm.prefill({k: torch.as_tensor(v)
                                                  for k, v in batch.items()}, 3)
        got, _, rope, slot = tm.extend_cache(torch.as_tensor(turn), torch.as_tensor(tmask),
                                             next_p, lens_full, cache)
    assert cache[0]["k"].dtype == torch.int8
    close(got, want)
    np.testing.assert_array_equal(rope.numpy(), np.asarray(want_rope))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    np.testing.assert_array_equal((slot - rope).numpy(), [2, 2])
