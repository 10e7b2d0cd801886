"""The port's continuous-batching engine against the JAX package's, on the CPU.

``tests/test_serving_engine.py``'s classes (all but ``TestScanLayersEngine``:
the port's cache is always a per-layer list) on the tiny presets in fp32
(``omni_tiny_test`` behind ``vit_tiny_test`` at 32²). JAX's params are drawn
with numpy from the init's shapes and carried into the port by
``utils/weights.py``. Each JAX engine compiles its own programs, so one JAX
engine a configuration runs every JAX scenario once (module fixtures) and
the port's cases are held to the tokens it recorded, exactly; the engine's
tokens do not depend on the window size, the slot count or the cache's
spare slots, so a port case at another window compares with the same
record. The port's engine is also held to the port's own ``generate``.
Sampling is the port's own draw (``serving_engine.position_uniforms``): its
nucleus filter keeps JAX's set on the same logits, top_p → 0 is greedy, a
draw is a function of the request alone, and 20,000 draws over (seed,
position) pairs match the filtered softmax's frequencies within 0.05 in
total variation (sampling alone gives about 0.01).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model
from antmmf_torch.models.m2_omni import M2Omni as TM
from antmmf_torch.models.pink import PinkModel as TPink
from antmmf_torch.predictors import cli as t_cli
from antmmf_torch.predictors import serving_engine as t_se
from antmmf_torch.predictors.serving_engine import (
    ContinuousBatchingEngine,
    M2OmniAdapter,
    PinkAdapter,
)
from antmmf_torch.utils.weights import load_flax_params
from antmmf_tpu.models.m2_omni import M2Omni as JM
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.predictors import serving_engine as j_se
from test_torch_m2omni import load_reached
from test_torch_qwen2_vit import random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

EOS, MAX_NEW, LP = 1, 5, 6
NO_EOS = 999_999  # never generated: turns retire on their budget
EXTRA = 16  # spare cache slots for session turns (invisible to every other request)
TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            lora_rank=2, dtype_str="float32")
M2_TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
               image_token_id=3, audio_token_id=None, dtype_str="float32")
N_IMG = (32 // 16) ** 2  # tokens an image (and a video frame) of the tiny ViT
TURN2 = np.array([17, 23, 31], np.int64)
PINK_CFG = "projects/pink/configs/pink_tiny.local.yml"


def truncate_at_eos(toks, eos=EOS):
    out = []
    for t in toks:
        out.append(int(t))
        if t == eos:
            break
    return out


def pink_requests(seed=100, n=5, lp=LP):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        k = 3 + i % 3
        ids = np.zeros(lp, np.int64)
        ids[:k] = rng.integers(5, 40, k)
        reqs.append((f"req{i}", {"input_ids": ids, "input_mask": (np.arange(lp) < k).astype(np.int64),
                                 "image_data": rng.standard_normal((32, 32, 3)).astype(np.float32)}))
    return reqs


def text_only(data):
    return {k: v for k, v in data.items() if k != "image_data"}


def prefix_setup():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((32, 32, 3)).astype(np.float32)
    pre = rng.integers(5, 40, 3).astype(np.int64)
    suffixes = [rng.integers(5, 40, k).astype(np.int64) for k in (2, 3, 2)]
    return img, pre, suffixes


def full_length_requests():
    """Prompts at max_prompt_len 12 whose last chunk of 8 would be padded past
    the cache, and a short one."""
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(3):
        n = 12 if i != 1 else 5
        ids = np.zeros(12, np.int64)
        ids[:n] = rng.integers(5, 40, n)
        reqs.append((f"b{i}", {"input_ids": ids, "input_mask": (np.arange(12) < n).astype(np.int64),
                               "image_data": rng.standard_normal((32, 32, 3)).astype(np.float32)}))
    return reqs


def m2_requests(n=3, seed=200):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        row = [5] + [3] * N_IMG + list(rng.integers(5, 40, 2 + i % 3))
        ids = np.zeros(LP + N_IMG, np.int64)
        ids[:len(row)] = row
        reqs.append((f"r{i}", {"input_ids": ids, "input_mask": (ids != 0).astype(np.int64),
                               "image_data": rng.standard_normal((1, 32, 32, 3)).astype(
                                   np.float32)}))
    return reqs


def multimodal_requests():
    """Two images (each spliced at its own run) and a one-frame video a request."""
    rng = np.random.default_rng(300)
    reqs = []
    for i in range(3):
        row = [5] + [3] * N_IMG + [20] + [3] * N_IMG + [21] + [6] * N_IMG \
            + list(rng.integers(30, 900, 3))
        ids = np.asarray(row, np.int64)
        reqs.append((f"r{i}", {"input_ids": ids, "input_mask": np.ones_like(ids),
                               "image_data": tuple(rng.standard_normal((32, 32, 3)).astype(
                                   np.float32) for _ in range(2)),
                               "video_data": rng.standard_normal((1, 32, 32, 3)).astype(
                                   np.float32)}))
    return reqs


def drain(eng):
    while eng._queue or any(r is not None for r in eng._slot_req) \
            or any(p is not None for p in eng._slot_pending):
        eng.step()


def session_run(eng):
    """A session of two turns beside a plain request; returns (first turn,
    second turn, the plain request's tokens)."""
    reqs = pink_requests()
    eng.submit("t1", dict(reqs[0][1], session=True))
    eng.submit(*reqs[1])
    for _ in range(4 * MAX_NEW):
        eng.step()
        if "t1" in eng._done and reqs[1][0] in eng._done:
            break
    eng.continue_session("t1", "t2", {"input_ids": TURN2})
    for _ in range(4 * MAX_NEW):
        eng.step()
        if "t2" in eng._done:
            break
    return eng._done["t1"], eng._done["t2"], eng._done[reqs[1][0]]


def prefix_run(eng):
    img, pre, suffixes = prefix_setup()
    eng.register_prefix("sys", {"input_ids": pre, "input_mask": np.ones(3, np.int64),
                                "image_data": img})
    for i, suf in enumerate(suffixes):
        eng.submit(f"p{i}", {"prefix": "sys", "input_ids": suf})
    drain(eng)
    eng.submit("late", {"prefix": "sys", "input_ids": suffixes[0]})
    drain(eng)
    eng.suffix_pad = 3
    for i, suf in enumerate(suffixes):
        eng.submit(f"pad{i}", {"prefix": "sys", "input_ids": suf})
    drain(eng)
    return dict(eng._done)


def pink_scenarios(eng):
    """Every Pink scenario on one engine (2 slots, spare slots for sessions)."""
    reqs = pink_requests()
    out = {"greedy": eng.run(reqs)}
    eng.reset()
    mixed = [reqs[0], ("text_only", text_only(reqs[1][1])), reqs[2]]
    out["mixed"] = eng.run(mixed)["outputs"]
    eng.reset()
    out["prefix"] = prefix_run(eng)
    eng.suffix_pad = None
    for chunk in (2, 3):
        eng.reset()
        eng.chunk = chunk
        out[f"chunk{chunk}"] = eng.run(reqs)["outputs"]
    eng.chunk = None
    eng.reset()
    eng.eos_id = NO_EOS
    out["session"] = session_run(eng)
    eng.eos_id = EOS
    return out


@pytest.fixture(scope="module")
def pink():
    """JAX Pink and its port twin on the same numpy-drawn params, and the
    JAX engines' records."""
    reqs = pink_requests()
    init = {"input_ids": jnp.asarray(reqs[0][1]["input_ids"])[None],
            "input_mask": jnp.asarray(reqs[0][1]["input_mask"])[None],
            "image_data": jnp.asarray(reqs[0][1]["image_data"])[None]}
    jm = JPink(**TINY)
    variables = {"params": random_params(jm, init, seed=3)}
    shell = build_model({"model_attributes": {"pink": TINY}}, device="cpu")
    load_flax_params(shell.module, variables["params"])
    tq = TPink(**TINY, kv_int8=True, device="cpu")
    load_flax_params(tq, variables["params"])

    def jax_engine(model=jm, lp=LP, new=MAX_NEW, extra=EXTRA, **kw):
        ad = j_se.PinkAdapter(model, variables, max_prompt_len=lp, max_new_tokens=new,
                              has_image=True, extra_slots=extra)
        return j_se.ContinuousBatchingEngine(ad, slots=2, max_new_tokens=new, eos_id=EOS, **kw)

    rec = pink_scenarios(jax_engine())
    rec["int8"] = jax_engine(jm.clone(kv_int8=True)).run(reqs[:3])["outputs"]
    eng = jax_engine(lp=12, new=2, extra=0)
    rec["long_whole"] = eng.run(full_length_requests())["outputs"]
    eng.reset()
    eng.chunk = 8
    rec["long_chunk8"] = eng.run(full_length_requests())["outputs"]
    return dict(tm=shell.module.eval(), tq=tq.eval(), rec=rec)


def port_engine(model, lp=LP, new=MAX_NEW, extra=EXTRA, slots=2, **kw):
    ad = PinkAdapter(model, max_prompt_len=lp, max_new_tokens=new, has_image=True,
                     extra_slots=extra)
    return ContinuousBatchingEngine(ad, slots=slots, max_new_tokens=new, eos_id=EOS, **kw)


def generate_tokens(model, data, eos=EOS, max_new=MAX_NEW):
    batch = {"input_ids": torch.as_tensor(data["input_ids"])[None],
             "input_mask": torch.as_tensor(data["input_mask"])[None]}
    if "image_data" in data:
        batch["image_data"] = torch.as_tensor(data["image_data"])[None]
    tokens, lens = model.generate(batch, eos_id=eos, max_length=max_new)
    gen = tokens[0, int(lens[0]): int(lens[0]) + max_new].tolist()
    return truncate_at_eos(gen, eos) if eos == EOS else gen


class TestPinkEngine:
    def test_matches_jax_engine_and_generate(self, pink):
        reqs = pink_requests()
        result = port_engine(pink["tm"]).run(reqs)
        want = pink["rec"]["greedy"]["outputs"]
        assert result["outputs"] == want
        for rid, data in reqs:
            assert want[rid] == generate_tokens(pink["tm"], data), rid
        assert result["total_tokens"] == sum(len(v) for v in result["outputs"].values())
        assert result["latency_p50"] > 0
        assert set(result) == set(pink["rec"]["greedy"])  # stats keys as JAX's

    def test_online_submit_mid_stream(self, pink):
        """A request submitted while another decodes joins at a window boundary."""
        reqs = pink_requests()
        eng = port_engine(pink["tm"], step_tokens=2)
        done = {}
        eng.submit(*reqs[0])
        for rid in eng.step() + eng.step():  # 4 of req0's 5 tokens decoded
            done[rid] = eng._done[rid]
        eng.submit(*reqs[1])
        for _ in range(4 * MAX_NEW):
            for rid in eng.step():
                done[rid] = eng._done[rid]
            if len(done) == 2:
                break
        want = pink["rec"]["greedy"]["outputs"]
        assert done == {rid: want[rid] for rid, _ in reqs[:2]}


class TestM2OmniEngine:
    @pytest.fixture(scope="class")
    def m2(self):
        reqs = m2_requests()
        d = reqs[0][1]
        init = {"input_ids": jnp.asarray(d["input_ids"])[None],
                "input_mask": jnp.asarray(d["input_mask"])[None],
                "image_data": jnp.asarray(d["image_data"])[None]}
        jm = JM(**M2_TINY)
        variables = {"params": random_params(jm, init, seed=4)}
        ad = j_se.M2OmniAdapter(jm, variables, max_prompt_len=LP + N_IMG,
                                max_new_tokens=MAX_NEW, has_image=True)
        rec = j_se.ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW,
                                            eos_id=EOS).run(reqs)["outputs"]
        tm = TM(**M2_TINY, device="cpu")
        load_reached(tm, variables["params"])
        return tm.eval(), rec

    def test_matches_jax_engine(self, m2):
        tm, rec = m2
        ad = M2OmniAdapter(tm, max_prompt_len=LP + N_IMG, max_new_tokens=MAX_NEW,
                           has_image=True)
        eng = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW, eos_id=EOS)
        assert eng.run(m2_requests())["outputs"] == rec
        # rope and cache slot advance apart: the image run of 4 slots is a
        # 2x2 grid, so a row's RoPE position trails its slot by 2
        eng = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW, eos_id=EOS,
                                       step_tokens=1)
        (rid, data), = m2_requests(1)
        eng.submit(rid, data)
        eng.step()
        n = int(data["input_mask"].sum())
        assert (int(eng._state["spos"][0]), int(eng._state["rope"][0])) == (n + 1, n - 1)

    def test_spliced_falls_back_when_placeholders_span_chunks(self, m2):
        """Chunks of 2 < 1 + 4 placeholders: every request admits whole."""
        tm, rec = m2
        ad = M2OmniAdapter(tm, max_prompt_len=LP + N_IMG, max_new_tokens=MAX_NEW,
                           has_image=True)
        eng = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW, eos_id=EOS,
                                       prefill_chunk=2)
        out = eng.run(m2_requests(2))["outputs"]
        assert out == {rid: rec[rid] for rid in out}
        assert ad.T == LP + N_IMG + MAX_NEW

    def test_a_different_prompt_width_is_refused(self, m2):
        tm, _ = m2
        ad = M2OmniAdapter(tm, max_prompt_len=LP + N_IMG, max_new_tokens=MAX_NEW,
                           has_image=True)
        eng = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW, eos_id=EOS)
        (rid, data), = m2_requests(1)
        wide = {**data, "input_ids": np.concatenate([data["input_ids"], [0]]),
                "input_mask": np.concatenate([data["input_mask"], [0]])}
        with pytest.raises(ValueError, match="cache length"):
            eng.run([(rid, data), ("wide", wide)])


class TestDecodeWindow:
    @pytest.mark.parametrize("step_tokens", [1, 3, 8])
    def test_window_sizes_keep_tokens_identical(self, pink, step_tokens):
        """H=1 (per-token admission), H=3 (mid-window retirement, a budget
        of 5 not divisible by 3) and H=8: the JAX engine's tokens."""
        result = port_engine(pink["tm"], step_tokens=step_tokens).run(pink_requests())
        assert result["outputs"] == pink["rec"]["greedy"]["outputs"]


class TestKvInt8Engine:
    def test_matches_jax_engine_and_generate_with_int8_cache(self, pink):
        reqs = pink_requests()[:3]
        result = port_engine(pink["tq"]).run(reqs)
        assert result["outputs"] == pink["rec"]["int8"]
        for rid, data in reqs:
            assert result["outputs"][rid] == generate_tokens(pink["tq"], data), rid
        layer = port_engine(pink["tq"]).ad.make_cache(1)[0]
        assert layer["k"].dtype == torch.int8 and layer["v_scale"].shape[-1] == 1


class TestMultiTurnSessions:
    def test_two_turns_match_jax_and_a_full_reprefill(self, pink):
        eng = port_engine(pink["tm"], step_tokens=2)
        eng.eos_id = NO_EOS
        gen1, gen2, mate = session_run(eng)
        assert (gen1, gen2, mate) == pink["rec"]["session"]
        assert len(gen1) == MAX_NEW
        data0 = pink_requests()[0][1]
        n1 = int(data0["input_mask"].sum())
        full = np.concatenate([data0["input_ids"][:n1], np.asarray(gen1), TURN2])
        assert gen2 == generate_tokens(pink["tm"], {
            "input_ids": full, "input_mask": np.ones_like(full),
            "image_data": data0["image_data"]}, eos=NO_EOS)
        assert mate == generate_tokens(pink["tm"], pink_requests()[1][1], eos=NO_EOS)

    def test_extend_writes_only_its_row(self, pink):
        eng = port_engine(pink["tm"])
        eng.eos_id = NO_EOS
        reqs = pink_requests()
        eng.submit("s", dict(reqs[0][1], session=True))
        eng.submit(*reqs[1])
        drain(eng)
        before = [{k: t.clone() for k, t in layer.items()} for layer in eng._state["cache"]]
        s = eng._sessions["s"][0]
        eng.continue_session("s", "s2", {"input_ids": TURN2, "max_new": 1})
        for old, new in zip(before, eng._state["cache"]):
            for k in old:
                assert torch.equal(old[k][1 - s], new[k][1 - s])
                assert not torch.equal(old[k][s], new[k][s])

    def test_close_session_frees_the_slot(self, pink):
        reqs = pink_requests()
        eng = port_engine(pink["tm"], slots=1, step_tokens=2, extra=8)
        eng.eos_id = NO_EOS
        eng.submit("s1", dict(reqs[0][1], session=True))
        for _ in range(2 * MAX_NEW):
            eng.step()
            if "s1" in eng._done:
                break
        eng.submit(*reqs[2])  # the single slot is held
        assert eng.step() == [] and eng._slot_held[0] == "s1"
        eng.close_session("s1")
        drain(eng)
        assert eng._done[reqs[2][0]] == generate_tokens(pink["tm"], reqs[2][1], eos=NO_EOS)


class TestPrefixCaching:
    def test_prefix_fork_matches_jax_and_the_full_prompt(self, pink):
        eng = port_engine(pink["tm"])
        done = prefix_run(eng)
        rec = pink["rec"]["prefix"]
        assert done == rec
        img, pre, suffixes = prefix_setup()
        for i, suf in enumerate(suffixes):
            n = len(pre) + len(suf)
            full = np.zeros(LP, np.int64)
            full[:n] = np.concatenate([pre, suf])
            assert done[f"p{i}"] == generate_tokens(pink["tm"], {
                "input_ids": full, "input_mask": (np.arange(LP) < n).astype(np.int64),
                "image_data": img}), i
            assert done[f"pad{i}"] == done[f"p{i}"]  # suffix_pad 3 changes nothing
        assert done["late"] == done["p0"]  # the stored row survives admissions
        # the stored row is a copy: the pool never writes it
        cache1 = eng._prefixes["sys"][0]
        assert all(t.data_ptr() != p.data_ptr() for one, big in zip(cache1, eng._state["cache"])
                   for t, p in zip(one.values(), big.values()))


class TestChunkedPrefill:
    @pytest.mark.parametrize("chunk", [2, 3])
    def test_tokens_match_jax_chunked_and_whole(self, pink, chunk):
        result = port_engine(pink["tm"], prefill_chunk=chunk).run(pink_requests())
        assert result["outputs"] == pink["rec"][f"chunk{chunk}"]
        assert result["outputs"] == pink["rec"]["greedy"]["outputs"]
        assert result["ttft_p50"] > 0 and result["tpot_p50"] >= 0

    def test_full_length_prompt_chunk_wider_than_headroom(self, pink):
        """Prompts at max_prompt_len: the last chunk overlaps the one before
        instead of being padded past the cache."""
        reqs = full_length_requests()
        whole = port_engine(pink["tm"], lp=12, new=2, extra=0).run(reqs)["outputs"]
        chunked = port_engine(pink["tm"], lp=12, new=2, extra=0, prefill_chunk=8).run(reqs)
        assert whole == pink["rec"]["long_whole"]
        assert chunked["outputs"] == pink["rec"]["long_chunk8"] == whole

    def test_a_chunk_past_the_cache_raises(self, pink):
        eng = port_engine(pink["tm"], extra=0)
        eng.register_prefix("p", {"input_ids": np.arange(5, 5 + LP)})
        with pytest.raises(ValueError, match="past the cache"):
            eng._extend(0, np.ones(MAX_NEW + 1, np.int64), np.ones(MAX_NEW + 1, np.int64),
                        LP, eng.T - MAX_NEW)

    def test_decode_proceeds_while_prefilling(self, pink):
        reqs = pink_requests()
        eng = port_engine(pink["tm"], prefill_chunk=2, chunks_per_step=1, step_tokens=1)
        eng.submit("short", reqs[0][1])
        eng.step()
        eng.submit("long", reqs[1][1])
        eng.step()
        assert any(p is not None for p in eng._slot_pending)
        s = eng._slot_req.index("short")
        assert len(eng._slot_toks[s]) >= 1
        drain(eng)
        want = pink["rec"]["greedy"]["outputs"]
        assert eng._done["short"] == want[reqs[0][0]] and eng._done["long"] == want[reqs[1][0]]


class TestSamplingControls:
    def test_top_p_zero_equals_greedy_and_mixed_pool_isolated(self, pink):
        reqs = pink_requests()
        mixed = [(reqs[0][0], {**reqs[0][1], "do_sample": True, "top_p": 1e-9,
                               "temperature": 0.7, "seed": 11}),
                 reqs[1],
                 (reqs[2][0], {**reqs[2][1], "do_sample": True, "top_p": 0.9,
                               "temperature": 1.3, "seed": 7})]
        result = port_engine(pink["tm"], slots=3).run(mixed)
        want = pink["rec"]["greedy"]["outputs"]
        for rid, _ in reqs[:2]:
            assert result["outputs"][rid] == want[rid], rid
        assert len(result["outputs"][reqs[2][0]]) >= 1

    def test_seeded_sampling_reproducible_and_schedule_independent(self, pink):
        reqs = pink_requests()
        sample = {**reqs[0][1], "do_sample": True, "top_p": 0.95, "temperature": 1.0,
                  "seed": 42}
        eng = port_engine(pink["tm"])
        alone = eng.run([("a", sample)])["outputs"]["a"]
        eng.reset()
        crowded = eng.run(reqs[1:4] + [("a", sample)])["outputs"]["a"]
        other = port_engine(pink["tm"], slots=3, step_tokens=2).run(
            [("a", sample)] + reqs[1:3])["outputs"]["a"]
        assert alone == crowded == other
        reseeded = port_engine(pink["tm"]).run([("a", {**sample, "seed": 43})])["outputs"]["a"]
        assert reseeded != alone

    def test_nucleus_filter_keeps_jax_set(self):
        rng = np.random.default_rng(5)
        logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
        logits[5, :3] = logits[5].max() + 1  # a tie at the top
        temps = np.array([1.0, 0.7, 1.3, 1e-9, 2.0, 1.0], np.float32)
        top_ps = np.array([0.9, 0.5, 0.95, 0.9, 1.0, 1e-9], np.float32)
        got = t_se.nucleus_filter(torch.as_tensor(logits), torch.as_tensor(temps),
                                  torch.as_tensor(top_ps)).numpy()
        # the expression of antmmf_tpu/predictors/serving_engine.py _step_sample
        lg = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
        srt = jnp.sort(lg, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(srt, -1), axis=-1)
        cutoff_idx = jnp.sum(cum < jnp.asarray(top_ps)[:, None], axis=-1)
        cutoff = jnp.take_along_axis(srt, cutoff_idx[:, None], -1)
        want = np.asarray(jnp.where(lg < cutoff, jnp.float32(-1e9), lg))
        np.testing.assert_array_equal(got > -1e8, want > -1e8)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got[5] > -1e8).sum() == 3  # the tied top survives top_p -> 0

    def test_draws_follow_the_filtered_softmax(self):
        rng = np.random.default_rng(6)
        logits = torch.as_tensor(rng.standard_normal((1, 40)).astype(np.float32) * 2)
        temps, top_ps = torch.tensor([0.8]), torch.tensor([0.9])
        filtered = t_se.nucleus_filter(logits, temps, top_ps)
        probs = torch.softmax(filtered, -1)[0].numpy()
        n = 20000
        i = torch.arange(n)
        draws = t_se.sample_tokens(logits.expand(n, -1), temps.expand(n), top_ps.expand(n),
                                   i % 7, i // 7).numpy()
        freq = np.bincount(draws, minlength=40) / n
        assert 0.5 * np.abs(freq - probs).sum() < 0.05
        assert freq[probs == 0].sum() == 0  # nothing outside the nucleus
        u = t_se.position_uniforms(torch.tensor([3, 3]), torch.tensor([9, 10]), 1000)
        assert 0 < float(u.min()) and float(u.max()) < 1
        assert not torch.equal(u[0], u[1])


class TestStopAndCancel:
    def test_stop_sequence_truncates_and_retires(self, pink):
        rid, data = pink_requests()[0]
        want = pink["rec"]["greedy"]["outputs"][rid]
        idx = next(i for i, t in enumerate(want) if t != want[0])
        eng = port_engine(pink["tm"])
        assert eng.run([(rid, {**data, "stop": [[want[idx]]]})])["outputs"][rid] == want[:idx]
        eng.reset()
        result = eng.run([(rid, {**data, "stop": [[want[idx - 1], want[idx]]]})])
        assert result["outputs"][rid] == want[:idx - 1]

    def test_cancel_queued_and_running(self, pink):
        reqs = pink_requests()
        eng = port_engine(pink["tm"], slots=1, step_tokens=1)
        eng.submit("run", reqs[0][1])
        eng.submit("queued", {**reqs[1][1], "deadline_s": 60.0, "session": True})
        eng.step()
        assert eng.cancel("queued") is True
        assert eng.cancel("run") is True
        assert eng.cancel("nonexistent") is False
        drain(eng)
        assert eng._done["queued"] == []
        assert len(eng._done["run"]) <= 2
        assert eng._cancelled == {"queued", "run"}
        assert not eng._deadline and not eng._session_req

    def test_queued_deadline_drop_leaves_no_entry(self, pink):
        """The reference's _evict_overdue keeps ``_deadline`` and
        ``_session_req`` entries of a queued request it drops."""
        reqs = pink_requests()
        eng = port_engine(pink["tm"], slots=1, step_tokens=1)
        eng.submit("holder", reqs[0][1])
        eng.step()
        eng.submit("starved", {**reqs[1][1], "deadline_s": 0.0, "session": True})
        time.sleep(0.01)
        drain(eng)
        assert "starved" in eng._evicted and eng._done["starved"] == []
        assert "starved" not in eng._deadline and "starved" not in eng._session_req


class TestMixedModalityRequests:
    def test_multi_image_plus_video_request(self):
        m2 = dict(M2_TINY, video_token_id=6)
        reqs = multimodal_requests()
        d = reqs[0][1]
        init = {"input_ids": jnp.asarray(d["input_ids"])[None],
                "input_mask": jnp.asarray(d["input_mask"])[None],
                "image_data": tuple(jnp.asarray(x)[None] for x in d["image_data"]),
                "video_data": jnp.asarray(d["video_data"])[None]}
        jm = JM(**m2)
        variables = {"params": random_params(jm, init, seed=5)}
        Lp = len(d["input_ids"])
        jad = j_se.M2OmniAdapter(jm, variables, max_prompt_len=Lp, max_new_tokens=MAX_NEW,
                                 has_image=True)
        want = j_se.ContinuousBatchingEngine(jad, slots=2, max_new_tokens=MAX_NEW,
                                             eos_id=EOS).run(reqs)["outputs"]
        tm = TM(**m2, device="cpu")
        load_reached(tm, variables["params"])
        ad = M2OmniAdapter(tm.eval(), max_prompt_len=Lp, max_new_tokens=MAX_NEW,
                           has_image=True)
        got = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=MAX_NEW,
                                       eos_id=EOS).run(reqs)["outputs"]
        assert got == want


class TestDeadlineEviction:
    def test_running_and_queued_requests_evict_past_deadline(self, pink):
        reqs = pink_requests()
        eng = port_engine(pink["tm"], slots=1, step_tokens=1)
        eng.submit("tight", {**reqs[0][1], "deadline_s": 0.0})
        eng.submit("fine", reqs[1][1])
        eng.step()  # admitted; the deadline is checked after one window
        time.sleep(0.01)
        drain(eng)
        res = eng.stats(1.0)
        assert "tight" in res["evicted"] and "fine" not in res["evicted"]
        assert len(res["outputs"]["tight"]) < MAX_NEW
        assert res["outputs"]["fine"] == pink["rec"]["greedy"]["outputs"][reqs[1][0]]
        eng.reset()
        eng.submit("holder", reqs[0][1])
        eng.step()
        eng.submit("starved", {**reqs[1][1], "deadline_s": 0.0})
        time.sleep(0.01)
        drain(eng)
        res = eng.stats(1.0)
        assert "starved" in res["evicted"] and res["outputs"]["starved"] == []
        assert len(res["outputs"]["holder"]) == MAX_NEW

    def test_engine_default_timeout_applies(self, pink):
        eng = port_engine(pink["tm"], slots=1, step_tokens=1)
        eng.request_timeout_s = 1e-6
        eng.submit("r", pink_requests()[0][1])
        eng.step()
        drain(eng)
        assert "r" in eng.stats(1.0)["evicted"]

    def test_stats_report_utilization_and_queue_depth(self, pink):
        res = port_engine(pink["tm"], step_tokens=1).run(pink_requests()[:4])
        assert 0.0 < res["slot_utilization"] <= 1.0
        assert res["queue_depth_max"] >= 1
        assert res["steps"] > 0 and res["evicted"] == set()


class TestMixedImageTextOnlyPool:
    def test_text_only_requests_in_image_engine_match_jax(self, pink):
        reqs = pink_requests()
        mixed = [reqs[0], ("text_only", text_only(reqs[1][1])), reqs[2]]
        result = port_engine(pink["tm"]).run(mixed)
        assert result["outputs"] == pink["rec"]["mixed"]
        assert result["outputs"]["text_only"] == generate_tokens(pink["tm"], mixed[1][1])


def test_cli_engine_matches_an_in_process_engine(tmp_path, capsys):
    rng = np.random.default_rng(8)
    rows = [{"id": f"q{i}", "input_ids": rng.integers(5, 900, 4 + i).tolist(), "max_new": 3 + i}
            for i in range(4)]
    path = tmp_path / "reqs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    t_cli.main(["--config", PINK_CFG, "--engine", str(path), "--device", "cpu", "--no_ckpt",
                "--slots", "2", "--step_tokens", "3", "--max_new", "6"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    got = {r["id"]: r["tokens"] for r in lines[:-1]}
    assert set(lines[-1]["stats"]) >= {"tokens_per_s", "ttft_p50", "tpot_p50", "steps"}
    assert all(set(r) == {"id", "tokens", "evicted", "latency_s"} for r in lines[:-1])

    _, config, _ = t_cli.parse(["--config", PINK_CFG, "--engine", str(path)])
    shell = build_model(config, device="cpu")
    shell.init()
    ad = PinkAdapter(shell.module.eval(), max_prompt_len=7, max_new_tokens=6, has_image=False)
    eng = ContinuousBatchingEngine(ad, slots=2, max_new_tokens=6, eos_id=-1, step_tokens=3)
    want = eng.run([(r["id"], {"input_ids": np.asarray(r["input_ids"]), "max_new": r["max_new"]})
                    for r in rows])["outputs"]
    assert got == want and [len(got[r["id"]]) for r in rows] == [3, 4, 5, 6]
