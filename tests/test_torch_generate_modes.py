"""The port's decoding modes against the JAX package's, on the CPU.

Pink (``omni_tiny_test`` behind ``vit_tiny_test`` at 32²) and M2-omni (the
same decoder, the ViT spliced at image id 3) in fp32, JAX's params drawn
with numpy from the init's shapes (``test_torch_qwen2_vit.random_params``)
and carried by ``load_flax_params``. Each JAX configuration compiles once:
a module fixture records every JAX scenario of a model, and the port's
cases are held to it:

* beams (K = 3, 4): tokens equal, the best beams' scores at atol 1e-5;
* prompt-lookup speculation (gamma 1, 3, 4; prompts with an image and
  text-only ones; an EOS that the greedy continuation emits mid-chunk):
  tokens equal JAX's (M2-omni's text-only prompts: its greedy alone) and
  the port's greedy ones, the verify steps equal JAX's; Pink's with the
  int8 cache equal its greedy tokens;
* ``prefill_chunked`` at chunks 1, 7 and 128: logits equal ``prefill``'s
  and JAX's ``prefill_chunked``'s at atol 1e-5 of their largest magnitude;
* sampling: the filter is JAX's ``sample_one`` (captured at its draw) on
  the same logits: at top_p 0.9 and at 0.5 with temperature 1.3 the same
  kept set and values; at top_p 1.0 every logit kept, and what JAX drops
  there (the last logits, where its fp32 cumsum rounds to 1.0 or above)
  holds less than 1e-6 of the probability; every sampled token lies in JAX's
  nucleus at its step, the steps replayed through JAX's ``decode_step``
  on the port's tokens; a seed gives the same tokens twice, another seed
  others, and top_p 1e-6 greedy's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.m2_omni import M2Omni as TM
from antmmf_torch.models.pink import PinkModel as TPink
from antmmf_torch.utils.text_utils import top_p_filter
from antmmf_torch.utils.weights import load_flax_params
from antmmf_tpu.models.m2_omni import LM_PRESETS, M2Omni as JM
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.modules.llm import init_decoder_cache
from antmmf_tpu.utils import text_utils as j_text
from antmmf_tpu.utils.speculative import speculative_greedy as j_speculative
from test_torch_m2omni import load_reached
from test_torch_qwen2_vit import assert_close, random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

MAX_NEW = 8
BEAMS = (3, 4)
GAMMAS = (1, 3, 4)
CHUNKS = (1, 7, 128)
PINK = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            lora_rank=2, dtype_str="float32")
M2 = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
          image_token_id=3, audio_token_id=None, dtype_str="float32")
N_IMG = 4  # vision tokens of the tiny ViT at 32²


def pink_batch(text_only=False):
    """Two rows whose prompts repeat a bigram, so prompt lookup finds drafts."""
    rng = np.random.default_rng(11)
    ids = np.array([[5, 6, 7, 8, 5, 6, 0, 0], [9, 10, 11, 12, 13, 9, 10, 11]], np.int64)
    batch = {"input_ids": ids, "input_mask": (ids != 0).astype(np.int64)}
    if not text_only:
        batch["image_data"] = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return batch


def m2_batch(text_only=False):
    rng = np.random.default_rng(12)
    text = [[5, 6, 7, 5, 6, 0], [9, 10, 11, 12, 9, 10]]
    if text_only:
        ids = np.array(text, np.int64)
        return {"input_ids": ids, "input_mask": (ids != 0).astype(np.int64)}
    ids = np.array([[20] + [3] * N_IMG + row for row in text], np.int64)
    return {"input_ids": ids, "input_mask": (ids != 0).astype(np.int64),
            "image_data": rng.standard_normal((2, 1, 32, 32, 3)).astype(np.float32)}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def pick_eos(model, batch):
    """(EOS, row, index): the first token of a greedy continuation, from its
    third on, that the row has not emitted before: EOS cuts the row there."""
    tokens, lens = model.generate(tbatch(batch), eos_id=-1, max_length=MAX_NEW)
    for row in range(tokens.shape[0]):
        gen = tokens[row, int(lens[row]):].tolist()
        for j in range(2, MAX_NEW):
            if gen[j] not in gen[:j]:
                return gen[j], row, j
    raise AssertionError("no greedy continuation changes its token past its second")


def jax_filter(logits, top_p, temperature):
    """JAX's ``sample_one`` filter on ``logits`` [B, V]: captured at the
    draw of ``nucleus_sampling_cached``'s first token."""
    seen = []
    real = jax.random.categorical

    def capture(key, filtered, axis=-1):
        if not isinstance(filtered, jax.core.Tracer):  # the scan traces its step once
            seen.append(np.asarray(filtered))
        return real(key, filtered, axis=axis)

    def no_step(tok, pos, cache):
        return jnp.zeros(logits.shape, jnp.float32), cache

    jax.random.categorical = capture
    try:
        j_text.nucleus_sampling_cached(no_step, jnp.asarray(logits), None,
                                       jnp.zeros(logits.shape[0], jnp.int32),
                                       jax.random.PRNGKey(0), eos_id=0, max_new=1,
                                       top_p=top_p, temperature=temperature)
    finally:
        jax.random.categorical = real
    return seen[0]


# ------------------------------------------------------------------- JAX runs
def pink_spec_fn(jm, Lp, Lv, gamma, eos):
    """JAX Pink's speculative path (``_build_cached_decode``'s gamma branch)
    returning the verify steps too."""
    preset = LM_PRESETS[jm.lm_preset]

    def run(variables, batch):
        mask = batch["input_mask"]
        lens = mask.sum(-1).astype(jnp.int32)
        B = mask.shape[0]
        tokens0 = jnp.concatenate([batch["input_ids"] * mask,
                                   jnp.zeros((B, MAX_NEW), jnp.int32)], 1)
        cache = init_decoder_cache(preset["num_layers"], B, preset["num_kv_heads"],
                                   Lv + Lp + MAX_NEW + gamma + 1,
                                   preset["hidden"] // preset["num_heads"], jnp.float32,
                                   quantized=jm.kv_int8)
        logits0, cache = jm.apply(variables, batch, cache, lens, method=JPink.prefill)

        def chunk_fn(chunk, off, cache):
            return jm.apply(variables, chunk, Lv + lens + off, cache,
                            method=JPink.decode_chunk)

        buf = jnp.pad(tokens0, ((0, 0), (0, gamma + 1)))
        tokens, _, n_steps = j_speculative(chunk_fn, logits0, cache, buf, lens, eos, MAX_NEW,
                                           gamma=gamma)
        return tokens[:, :Lp + MAX_NEW], n_steps

    return jax.jit(run)


def m2_spec_fn(jm, Lp, gamma, eos):
    def run(variables, batch):
        mask = batch["input_mask"]
        lens_text = mask.sum(-1).astype(jnp.int32)
        B = mask.shape[0]
        tokens0 = jnp.concatenate([batch["input_ids"] * mask,
                                   jnp.zeros((B, MAX_NEW), jnp.int32)], 1)
        logits0, cache, lens_full, next_p = jm.apply(variables, batch, MAX_NEW + gamma + 1,
                                                     method=JM.prefill)

        def chunk_fn(chunk, off, cache):
            return jm.apply(variables, chunk, next_p + off, lens_full + off, cache,
                            method=JM.decode_chunk)

        buf = jnp.pad(tokens0, ((0, 0), (0, gamma + 1)))
        tokens, _, n_steps = j_speculative(chunk_fn, logits0, cache, buf, lens_text, eos,
                                           MAX_NEW, gamma=gamma)
        return tokens[:, :Lp + MAX_NEW], n_steps

    return jax.jit(run)


def pink_beam_fn(jm, batch, K, eos):
    B, Lp = batch["input_ids"].shape
    Lv = jm.num_vision_tokens(batch)
    fn = jax.jit(jm._build_cached_decode(Lp, MAX_NEW, eos, K, B, Lp + MAX_NEW, Lv,
                                         Lv + Lp + MAX_NEW, LM_PRESETS[jm.lm_preset], True))
    return lambda variables: fn(variables, *pink_args(batch))


def pink_args(batch):
    B = batch["input_ids"].shape[0]
    tokens0 = np.concatenate([batch["input_ids"] * batch["input_mask"],
                              np.zeros((B, MAX_NEW), np.int64)], 1)
    return jnp.asarray(tokens0, jnp.int32), jnp.asarray(batch["input_mask"], jnp.int32), \
        jnp.asarray(batch["image_data"])


def m2_beam(jm, variables, batch, K, eos):
    B, Lp = batch["input_ids"].shape
    fn = jax.jit(jm._build_cached_decode(Lp, MAX_NEW, eos, K, B, Lp + MAX_NEW,
                                         ("image_data",)))
    tokens0 = np.concatenate([batch["input_ids"] * batch["input_mask"],
                              np.zeros((B, MAX_NEW), np.int64)], 1)
    return fn(variables, jnp.asarray(tokens0, jnp.int32), jnp.asarray(batch["input_mask"]),
              (jnp.asarray(batch["image_data"]),))


@pytest.fixture(scope="module")
def pink():
    batch = pink_batch()
    jm = JPink(**PINK)
    params = random_params(jm, jbatch(batch), seed=21)
    variables = {"params": params}
    tm = TPink(**PINK, device="cpu").eval()
    load_flax_params(tm, params)
    tq = TPink(**PINK, kv_int8=True, device="cpu").eval()
    load_flax_params(tq, params)
    eos, row, cut = pick_eos(tm, batch)
    Lp, Lv = batch["input_ids"].shape[1], N_IMG
    rec = {"eos": eos, "cut": (row, cut)}
    for K in BEAMS:
        rec[f"beam{K}"] = pink_beam_fn(jm, batch, K, eos)(variables)
    for gamma in GAMMAS:
        rec[f"spec{gamma}"] = pink_spec_fn(jm, Lp, Lv, gamma, eos)(variables, jbatch(batch))
    rec["spec_text"] = pink_spec_fn(jm, Lp, 0, 4, eos)(variables, jbatch(pink_batch(True)))
    lens = jnp.asarray(batch["input_mask"].sum(-1), jnp.int32)
    T = Lv + Lp + 8

    def cache():
        p = LM_PRESETS["omni_tiny_test"]
        return init_decoder_cache(p["num_layers"], 2, p["num_kv_heads"], T,
                                  p["hidden"] // p["num_heads"], jnp.float32)

    chunked = jax.jit(lambda v, b, n: [jm.apply(v, b, cache(), n, w,
                                                method=JPink.prefill_chunked)[0]
                                       for w in CHUNKS])  # one compile for the three
    for chunk, logits in zip(CHUNKS, chunked(variables, jbatch(batch), lens)):
        rec[f"chunked{chunk}"] = np.asarray(logits)
    return dict(jm=jm, variables=variables, tm=tm, tq=tq, batch=batch, rec=rec, T=T)


@pytest.fixture(scope="module")
def m2():
    batch = m2_batch()
    jm = JM(**M2)
    params = random_params(jm, jbatch(batch), seed=22)
    variables = {"params": params}
    tm = TM(**M2, device="cpu").eval()
    load_reached(tm, params)
    eos, row, cut = pick_eos(tm, batch)
    Lp = batch["input_ids"].shape[1]
    rec = {"eos": eos, "cut": (row, cut)}
    for K in BEAMS:
        rec[f"beam{K}"] = m2_beam(jm, variables, batch, K, eos)
    for gamma in GAMMAS:
        rec[f"spec{gamma}"] = m2_spec_fn(jm, Lp, gamma, eos)(variables, jbatch(batch))
    return dict(jm=jm, variables=variables, tm=tm, batch=batch, rec=rec)


MODELS = ("pink", "m2")


@pytest.fixture(params=MODELS)
def model(request):
    return request.getfixturevalue(request.param)


# ---------------------------------------------------------------------- beams
@pytest.mark.parametrize("K", BEAMS)
def test_beams_match_jax(model, K):
    eos = model["rec"]["eos"]
    stats = {}
    tokens, _ = model["tm"].generate(tbatch(model["batch"]), eos_id=eos, max_length=MAX_NEW,
                                     num_beams=K, stats=stats)
    want_tokens, want_scores = model["rec"][f"beam{K}"]
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    np.testing.assert_allclose(stats["scores"].numpy(), np.asarray(want_scores), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------- speculation
@pytest.mark.parametrize("case", [f"spec{g}" for g in GAMMAS] + ["spec_text"])
def test_speculation_matches_jax_and_greedy(model, case):
    eos = model["rec"]["eos"]
    gamma = 4 if case == "spec_text" else int(case[4:])
    make = pink_batch if model["tm"].__class__ is TPink else m2_batch
    batch = tbatch(make(case == "spec_text"))
    stats = {}
    tokens, lens = model["tm"].generate(batch, eos_id=eos, max_length=MAX_NEW,
                                        speculative=gamma, stats=stats)
    greedy, _ = model["tm"].generate(batch, eos_id=eos, max_length=MAX_NEW)
    np.testing.assert_array_equal(tokens.numpy(), greedy.numpy())
    if case in model["rec"]:  # M2-omni's text-only prompts: against its greedy alone
        want, n_steps = model["rec"][case]
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
        assert stats["n_steps"] == int(n_steps)
    if case != "spec_text":  # the EOS cut: the row stops there, then pads with EOS
        row, cut = model["rec"]["cut"]
        n = int(lens[row])
        assert (tokens[row, n + cut:n + MAX_NEW] == eos).all()
        assert tokens[row, n + cut - 1] != eos and int(stats["n_generated"][row]) == cut + 1


def test_pink_speculation_with_the_int8_cache(pink):
    eos = pink["rec"]["eos"]
    batch = tbatch(pink["batch"])
    tokens, _ = pink["tq"].generate(batch, eos_id=eos, max_length=MAX_NEW, speculative=3)
    greedy, _ = pink["tq"].generate(batch, eos_id=eos, max_length=MAX_NEW)
    np.testing.assert_array_equal(tokens.numpy(), greedy.numpy())  # held to JAX's int8
    # greedy in tests/test_torch_kv_int8.py
    # speculation is zeroed under beams and sampling, as in JAX
    beams, _ = pink["tq"].generate(batch, eos_id=eos, max_length=MAX_NEW, num_beams=3,
                                   speculative=3)
    assert beams.shape == tokens.shape


# ------------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("chunk", CHUNKS)
def test_pink_prefill_chunked_matches_prefill_and_jax(pink, chunk):
    tm, batch = pink["tm"], tbatch(pink["batch"])
    lens = batch["input_mask"].sum(-1)
    with torch.inference_mode():
        full, full_cache = tm.prefill(batch, tm.make_cache(2, pink["T"]), lens)
        got, cache = tm.prefill_chunked(batch, tm.make_cache(2, pink["T"]), lens, chunk)
    assert_close(got, full.numpy(), 1e-5)
    assert_close(got, pink["rec"][f"chunked{chunk}"], 1e-5)
    for b in range(2):  # every valid slot of the cache as the prefill writes it
        n = N_IMG + int(lens[b])
        for layer, ref in zip(cache, full_cache):
            np.testing.assert_allclose(layer["k"][b, :, :n].numpy(),
                                       ref["k"][b, :, :n].numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------------- sampling
@pytest.mark.parametrize("top_p,temperature", [(0.9, 1.0), (1.0, 1.0), (0.5, 1.3)])
def test_filter_is_jax_sample_one(top_p, temperature):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((16, 1000)) * 3).astype(np.float32)
    logits[1, :2] = [40.0, 40.0 - 1e-6]  # two near-tied leaders
    got = top_p_filter(torch.as_tensor(logits), top_p, temperature).numpy()
    want = jax_filter(logits, top_p, temperature)
    if top_p == 1.0:
        assert (got > -1e9).all()  # every logit kept, as JAX's NaN cutoff keeps them
        np.testing.assert_allclose(got, logits / temperature, rtol=1e-6, atol=0)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits / temperature), -1))
        assert (probs * (want == -1e9)).sum(-1).max() < 1e-6
        return
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_pink_sampled_tokens_lie_in_jax_nucleus(pink):
    """Teacher-forced: JAX's prefill and decode steps on the port's sampled
    tokens; each token is kept by JAX's filter of that step's logits."""
    jm, variables, batch = pink["jm"], pink["variables"], pink["batch"]
    top_p, temperature = 0.8, 1.3
    tokens, lens = pink["tm"].generate(tbatch(batch), eos_id=0, max_length=MAX_NEW,
                                       do_sample=True, top_p=top_p, temperature=temperature,
                                       seed=7)
    tokens, lens = tokens.numpy(), lens.numpy()
    rows = np.arange(2)
    gen = np.stack([tokens[rows, lens + t] for t in range(MAX_NEW)], 1)  # [2, MAX_NEW]
    p = LM_PRESETS["omni_tiny_test"]

    @jax.jit
    def replay(variables, batch, gen):
        cache = init_decoder_cache(p["num_layers"], 2, p["num_kv_heads"], pink["T"],
                                   p["hidden"] // p["num_heads"], jnp.float32)
        lens = batch["input_mask"].sum(-1).astype(jnp.int32)
        logits, cache = jm.apply(variables, batch, cache, lens, method=JPink.prefill)

        def step(cache, t):
            out, cache = jm.apply(variables, gen[:, t], N_IMG + lens + t, cache,
                                  method=JPink.decode_step)
            return cache, out

        _, rest = jax.lax.scan(step, cache, jnp.arange(MAX_NEW - 1))
        return jnp.concatenate([logits[None], rest], 0)  # [MAX_NEW, 2, V]

    logits = np.asarray(replay(variables, jbatch(batch), jnp.asarray(gen, jnp.int32)))
    kept = jax_filter(logits.reshape(MAX_NEW * 2, -1), top_p, temperature) > -1e9
    assert kept[np.arange(MAX_NEW * 2), gen.T.reshape(-1)].all()


def test_sampling_is_a_function_of_the_seed(model):
    tm, batch = model["tm"], tbatch(model["batch"])

    def draw(**kw):
        return tm.generate(batch, eos_id=0, max_length=MAX_NEW, do_sample=True, **kw)[0]

    a, b, c = draw(seed=3), draw(seed=3), draw(seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy, _ = tm.generate(batch, eos_id=0, max_length=MAX_NEW)
    assert torch.equal(draw(seed=3, top_p=1e-6), greedy)


@pytest.mark.parametrize("hashed", [0, 0xFFFFFFFF])
def test_uniforms_stay_inside_the_open_interval(monkeypatch, hashed):
    """The hash's lowest and highest cells give uniforms inside (0, 1) in
    fp32, so a draw's Gumbel noise is finite (a top cell rounded to 1.0
    gives +inf, which wins the draw outside the nucleus)."""
    from antmmf_torch.utils import text_utils

    monkeypatch.setattr(text_utils, "_mix32", lambda x: torch.full_like(x, hashed))
    u = text_utils.position_uniforms(torch.tensor([1]), torch.tensor([2]), 4)
    assert bool(((u > 0) & (u < 1)).all()) and bool(torch.isfinite(-torch.log(-torch.log(u))).all())
    filtered = torch.tensor([[0.0, -1e9, -1e9, -1e9]])
    assert int(text_utils.gumbel_draw(filtered, torch.tensor([1]), torch.tensor([2]))) == 0
