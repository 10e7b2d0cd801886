"""The port's Pink decode-serving slice against the JAX package, on the CPU.

Tiny presets (``omni_tiny_test``: hidden 64, 2 layers, 2 heads of 32, 1 kv
head, vocabulary 1000; ``vit_tiny_test`` at 32², read at its penultimate
layer) in fp32. Weights are numpy draws put into both packages (so LoRA's
``b`` matrices and the norm scales are not trivially 0 and 1); decode records
are quantised once and loaded into both. Tolerances: modules atol 1e-5,
decoder and model outputs atol 1e-4 (hidden states and logits of spread 1 to
10 after two fp32 layers), greedy tokens and record bytes exactly equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.models.base_model import build_model
from antmmf_torch.models.pink import LM_PRESETS as T_LM_PRESETS, PinkModel as TPink
from antmmf_torch.modules import llm as t_llm
from antmmf_torch.modules import lora as t_lora
from antmmf_torch.modules.vision.vit import VisionTransformer as TViT
from antmmf_torch.ops import int4_matmul as t_int4
from antmmf_torch.predictors import cli as t_cli
from antmmf_torch.predictors import quantization as t_quant
from antmmf_torch.utils.conversation import build_prompt as t_build_prompt
from antmmf_torch.utils.weights import export_flax_params, flatten_flax, load_flax_params
from antmmf_tpu.common.configuration import Configuration as JConfiguration
from antmmf_tpu.models.m2_omni import LM_PRESETS as J_LM_PRESETS
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.modules import llm as j_llm
from antmmf_tpu.modules import lora as j_lora
from antmmf_tpu.modules.vision.vit import VisionTransformer as JViT
from antmmf_tpu.predictors import quantization as j_quant
from antmmf_tpu.predictors.generation_predictor import GenerationPredictor as JGenPredictor
from antmmf_tpu.scripts.pink_eval import build_prompt as j_build_prompt
from test_torch_trainer import jitted_jax_init
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

F32 = torch.float32
TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            lora_rank=2, dtype_str="float32")
PINK_CFG = "projects/pink/configs/pink_tiny.local.yml"


def _random_params(module, *args, seed=0, **kw):
    """flax params of ``module`` for ``args``, redrawn from a numpy generator."""
    params = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw),
                            *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else noise

    return jax.tree_util.tree_map_with_path(draw, params)


def _close(port_out, jax_out, atol):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out), atol=atol, rtol=0)


# ------------------------------------------------------------------- modules
def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jm = j_llm.RMSNorm(dtype=jnp.float32)
    params = _random_params(jm, x)
    port = t_llm.RMSNorm(64, dtype=F32)
    load_flax_params(port, params)
    _close(port(torch.from_numpy(x)), jm.apply({"params": params}, x), 1e-5)

    pos = rng.integers(0, 200, (2, 7))
    cos, sin = t_llm.rope_cos_sin(torch.from_numpy(pos), 32)
    j_cos, j_sin = j_llm.rope_cos_sin(jnp.asarray(pos), 32)
    _close(cos, j_cos, 1e-5)
    _close(sin, j_sin, 1e-5)
    q = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    _close(t_llm.apply_rope_cs(torch.from_numpy(q), cos, sin),
           j_llm.apply_rope(jnp.asarray(q), jnp.asarray(pos)), 1e-5)
    _close(t_llm.rope_frequencies(32), j_llm.rope_frequencies(32), 1e-7)


@pytest.mark.parametrize("freeze_base,use_bias", [(True, True), (False, False)])
def test_lora_dense_and_merge(freeze_base, use_bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 24)).astype(np.float32)
    jm = j_lora.LoRADense(16, rank=4, freeze_base=freeze_base, use_bias=use_bias,
                          dtype=jnp.float32)
    params = _random_params(jm, x)
    port = t_lora.LoRADense(24, 16, rank=4, freeze_base=freeze_base, use_bias=use_bias,
                            dtype=F32)
    load_flax_params(port, params)
    _close(port(torch.from_numpy(x)), jm.apply({"params": params}, x), 1e-5)
    # freeze_base freezes the weights, never the output
    assert port.base.weight.requires_grad == (not freeze_base)
    xt = torch.from_numpy(x).requires_grad_()
    port(xt).sum().backward()
    assert xt.grad is not None and port.lora_a.grad is not None

    merged, ref = t_lora.merge_lora_params({"proj": params}), j_lora.merge_lora_params(
        {"proj": params})
    for key, val in flatten_flax(merged).items():
        np.testing.assert_allclose(val, flatten_flax(jax.device_get(ref))[key], atol=1e-6,
                                   rtol=0, err_msg=key)


def test_vit_without_final_norm_and_fewer_layers():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    kw = dict(image_size=32, patch_size=16, embed_dim=64, num_layers=1, num_heads=2)
    jm = JViT(final_norm=False, dtype=jnp.float32, **kw)
    params = _random_params(jm, img)
    port = TViT(final_norm=False, dtype=F32, **kw)
    load_flax_params(port, params)
    assert port.encoder.final_norm is None
    _close(port(torch.from_numpy(img))["sequence"],
           jm.apply({"params": params}, img)["sequence"], 1e-4)


# ------------------------------------------------------------------- decoder
def _decoders(num_kv_heads, lora_rank, seed, B=2, L=10, C=128):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((B, L, C)).astype(np.float32)
    positions = np.broadcast_to(np.arange(L)[None], (B, L)).copy()
    jm = j_llm.DecoderLM(num_layers=2, num_heads=4, num_kv_heads=num_kv_heads,
                         lora_rank=lora_rank, dtype=jnp.float32)
    params = _random_params(jm, embeds, positions, seed=seed)
    port = t_llm.DecoderLM(C, 2, 4, num_kv_heads, lora_rank=lora_rank, dtype=F32)
    load_flax_params(port, params)
    return jm, {"params": params}, port.eval(), embeds, positions


@pytest.mark.parametrize("num_kv_heads,lora_rank", [(2, 0), (4, 2), (1, 2)])
def test_decoder_cache_free_prefill_and_decode(num_kv_heads, lora_rank):
    """Prefill 6 tokens, decode the rest one by one: every hidden state
    matches the JAX module's, and the JAX plain causal forward."""
    jm, variables, port, embeds, positions = _decoders(num_kv_heads, lora_rank, seed=3)
    B, L, C = embeds.shape
    Lp, n_kv = 6, num_kv_heads
    e, p = torch.from_numpy(embeds), torch.from_numpy(positions)
    full = jm.apply(variables, embeds, positions)
    with torch.no_grad():
        _close(port(e, p), full, 1e-4)
        cache = t_llm.init_decoder_cache(2, B, n_kv, L, C // 4, F32)
        j_cache = j_llm.init_decoder_cache(2, B, n_kv, L, C // 4, jnp.float32)
        pre, cache = port(e[:, :Lp], p[:, :Lp], cache=cache)
        j_pre, j_cache = jm.apply(variables, embeds[:, :Lp], positions[:, :Lp], None, True,
                                  cache=j_cache)
        _close(pre, j_pre, 1e-4)
        for t in range(Lp, L):
            pos = torch.full((B,), t)
            step, cache = port(e[:, t:t + 1], pos[:, None], cache=cache, decode_pos=pos)
            j_step, j_cache = jm.apply(variables, embeds[:, t:t + 1], pos.numpy()[:, None],
                                       None, True, cache=j_cache, decode_pos=pos.numpy())
            _close(step, j_step, 1e-4)
            _close(step[:, 0], full[:, t], 1e-4)
        for layer, j_layer in zip(cache, j_cache):
            _close(layer["k"], j_layer["k"], 1e-4)
            _close(layer["v"], j_layer["v"], 1e-4)


@pytest.mark.parametrize("chunk", [1, 3])
def test_decoder_ragged_rows_chunked_decode(chunk):
    """Ragged prompts (4 and 6 tokens of 10 slots) under a padding mask, then
    a ``chunk``-token decode at each row's own slot."""
    jm, variables, port, embeds, positions = _decoders(2, 2, seed=4)
    B, L, C = embeds.shape
    lens = np.array([4, 6])
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.int64)
    e, p = torch.from_numpy(embeds), torch.from_numpy(positions)
    nxt = np.random.default_rng(5).standard_normal((B, chunk, C)).astype(np.float32)
    pos = lens[:, None] + np.arange(chunk)[None]
    with torch.no_grad():
        _close(port(e, p, torch.from_numpy(mask)), jm.apply(variables, embeds, positions, mask),
               1e-4)
        cache = t_llm.init_decoder_cache(2, B, 2, L, C // 4, F32)
        _, cache = port(e, p, torch.from_numpy(mask), cache=cache)
        step, _ = port(torch.from_numpy(nxt), torch.from_numpy(pos), cache=cache,
                       decode_pos=torch.from_numpy(lens))
    j_cache = j_llm.init_decoder_cache(2, B, 2, L, C // 4, jnp.float32)
    _, j_cache = jm.apply(variables, embeds, positions, mask, True, cache=j_cache)
    j_step, _ = jm.apply(variables, nxt, pos, None, True, cache=j_cache, decode_pos=lens)
    _close(step, j_step, 1e-4)


def test_decoder_serves_q4_records_like_jax():
    """One layer at hidden 256 (heads of 64, group 64): the routed
    projections are packed in both packages; prefill takes unpack + matmul,
    the decode step the GEMV's plain version."""
    rng = np.random.default_rng(6)
    B, L, C = 2, 40, 256
    embeds = rng.standard_normal((B, L, C)).astype(np.float32)
    positions = np.broadcast_to(np.arange(L)[None], (B, L)).copy()
    jm = j_llm.DecoderLM(num_layers=1, num_heads=4, dtype=jnp.float32)
    params = {"decoder": jax.device_get(_random_params(jm, embeds, positions, seed=6))}
    records = t_quant.quantize_for_decode(params, min_size=256, group=64)
    ref_records = j_quant.quantize_for_decode(params, min_size=256, bits=4, group=64)
    flat, ref_flat = flatten_flax(records), flatten_flax(ref_records)
    assert set(flat) == set(ref_flat)
    for path, rec in flat.items():
        if isinstance(rec, dict):
            assert set(rec) == set(ref_flat[path])
            for k in rec:
                np.testing.assert_array_equal(rec[k], ref_flat[path][k], err_msg=path)

    port = t_llm.DecoderLM(C, 1, 4, dtype=F32).eval()
    holder = torch.nn.Module()
    holder.decoder = port
    n_packed, n_dequantised = t_quant.load_decode_records(holder, records, F32)
    assert n_packed == 7 and n_dequantised == 0  # down_proj's 688 rows: an int8 record
    assert port.layer_0.attention.q_proj.kernel_q4.shape == (128, 256)
    assert port.layer_0.mlp.down_proj.kernel_q4 is None
    assert port.layer_0.mlp.down_proj.kernel_q8.shape == (688, 256)
    j_vars = j_quant.make_live_vars(ref_records, jnp.float32)()["decoder"]
    cache = t_llm.init_decoder_cache(1, B, 4, L + 1, 64, F32)
    j_cache = j_llm.init_decoder_cache(1, B, 4, L + 1, 64, jnp.float32)
    with torch.no_grad():
        pre, cache = port(torch.from_numpy(embeds), torch.from_numpy(positions), cache=cache)
        j_pre, j_cache = jm.apply({"params": j_vars}, embeds, positions, None, True,
                                  cache=j_cache)
        _close(pre, j_pre, 1e-4)
        nxt = rng.standard_normal((B, 1, C)).astype(np.float32)
        pos = np.full((B,), L)
        step, _ = port(torch.from_numpy(nxt), torch.from_numpy(pos)[:, None], cache=cache,
                       decode_pos=torch.from_numpy(pos))
        j_step, _ = jm.apply({"params": j_vars}, nxt, pos[:, None], None, True, cache=j_cache,
                             decode_pos=pos)
        _close(step, j_step, 1e-4)


# --------------------------------------------------------------------- model
def test_lm_presets_match_jax():
    assert T_LM_PRESETS == J_LM_PRESETS


@pytest.fixture(scope="module")
def pink_tiny():
    rng = np.random.default_rng(7)
    batch = {"input_ids": np.array([[5, 6, 7, 8, 0, 0], [9, 10, 11, 12, 13, 14]], np.int32),
             "input_mask": np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32),
             "image_data": rng.standard_normal((2, 32, 32, 3)).astype(np.float32)}
    jm = JPink(**TINY)
    params = jax.device_get(_random_params(jm, batch, seed=7))
    shell = build_model({"model_attributes": {"pink": TINY}}, device="cpu")
    load_flax_params(shell.module, params)
    return jm, {"params": params}, shell, batch


def _records(params):
    """int4 records of the tiny tree: group 32 packs the 64-row kernels (q4,
    routed to QuantDense), ``down_proj``'s 172 rows fall back to int8."""
    return t_quant.quantize_for_decode(params, min_size=256, group=32)


def test_pink_logits_match_jax(pink_tiny):
    jm, variables, shell, batch = pink_tiny
    ref = jm.apply(variables, batch)["logits"]
    out = shell.apply(batch)
    assert set(out) == {"logits"} and out["logits"].dtype == F32
    _close(out["logits"], ref, 1e-4)
    assert shell.module.num_vision_tokens(batch) == jm.num_vision_tokens(batch) == 4
    # given labels, the LM loss (ported since the training slice) matches JAX's
    labels = np.where(np.asarray(batch["input_mask"]) > 0, np.asarray(batch["input_ids"]), -100)
    want = jm.apply(variables, {**batch, "labels": jnp.asarray(labels)})["losses"]["lm_loss"]
    with torch.inference_mode():
        got = shell.module({**shell.to_device(batch), "labels": torch.as_tensor(labels)})
    assert abs(float(got["losses"]["lm_loss"]) - float(want)) <= 1e-5


def test_pink_exported_params_round_trip(pink_tiny):
    _, variables, shell, _ = pink_tiny
    flat, ref = flatten_flax(export_flax_params(shell.module)), flatten_flax(variables["params"])
    assert set(flat) == set(ref)
    for path in ref:
        np.testing.assert_array_equal(flat[path], ref[path], err_msg=path)


def test_pink_records_are_bitwise_jax(pink_tiny):
    _, variables, _, _ = pink_tiny
    flat = flatten_flax(_records(variables))
    ref = flatten_flax(j_quant.quantize_for_decode(variables, min_size=256, bits=4, group=32))
    assert set(flat) == set(ref)
    kinds = {"q4": 0, "q": 0, "float": 0}
    for path, rec in flat.items():
        if isinstance(rec, dict):
            assert set(rec) == set(ref[path]), path
            kinds["q4" if "q4" in rec else "q"] += 1
            for k in rec:
                assert rec[k].dtype == ref[path][k].dtype
                np.testing.assert_array_equal(rec[k], ref[path][k], err_msg=path)
        else:
            kinds["float"] += 1
            np.testing.assert_array_equal(rec, np.asarray(ref[path]), err_msg=path)
    assert kinds["q4"] > 0 and kinds["q"] > 0 and kinds["float"] > 0
    assert t_quant.is_decode_quantized(_records(variables))
    assert not t_quant.is_decode_quantized(variables)
    routed = t_quant._route_q4_siblings(_records(variables))
    ref_routed = flatten_flax(j_quant._route_q4_siblings(_records(variables)))
    # JAX routes the int4 records; the port also serves the int8 ones on
    # QuantDense paths (each layer's down_proj) as int8 buffers
    int8_paths = [p for p, rec in ref_routed.items() if isinstance(rec, dict)
                  and "/decoder/" in f"/{p}"]
    assert int8_paths and all(p.endswith("mlp/down_proj/kernel") for p in int8_paths)
    want = set(ref_routed) - set(int8_paths)
    want |= {p[:-len("kernel")] + k for p in int8_paths for k in ("kernel_q8", "kernel_scale")}
    assert set(flatten_flax(routed)) == want
    assert set(routed["params"]["lm_head"]) == {"kernel_q4", "kernel_scale"}
    assert set(routed["params"]["vision_tower"]["encoder"]["layer_0"]["attention"]["q_proj"]) \
        == {"kernel", "bias"}


def _quantized_twin(variables):
    shell = build_model({"model_attributes": {"pink": TINY}}, device="cpu")
    t_quant.load_decode_records(shell.module, _records(variables), F32)
    return shell


@pytest.mark.parametrize("quantized", [False, True])
def test_pink_greedy_generate_matches_jax(pink_tiny, quantized, monkeypatch):
    """Tokens equal; cached equal to re-encoding; under teacher forcing on the
    JAX tokens, the prefill and every decode step's logits within atol 1e-4
    (5e-4 on the records, whose int4 grid amplifies the logits' spread)."""
    jm, variables, shell, batch = pink_tiny
    max_new, atol = 5, 1e-4
    j_vars = variables
    if quantized:
        shell, atol = _quantized_twin(variables), 5e-4
        j_vars = _records(variables)
        assert shell.module.lm_head.kernel_q4 is not None
        assert shell.module.decoder.layer_0.mlp.down_proj.kernel_q8 is not None  # int8 fallback
    want, want_lens = jm.generate(j_vars, batch, eos_id=1, max_length=max_new)
    want = np.asarray(want)
    tb = shell.to_device(batch)
    gemv_rows = []
    real = t_int4.int4_gemv
    monkeypatch.setattr(t_int4, "int4_gemv", lambda *a: gemv_rows.append(a[0].shape[0])
                        or real(*a))
    got, lens = shell.module.generate(tb, eos_id=1, max_length=max_new)
    n_cached = len(gemv_rows)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got.numpy(), want)
    again, _ = shell.module.generate(tb, eos_id=1, max_length=max_new, use_cache=False)
    np.testing.assert_array_equal(again.numpy(), want)
    if quantized:
        # per layer q, k, v, o, gate, up (down is int8), and lm_head: 13 GEMVs
        # per forward. At this size the prefill (2 x 10 rows) and the
        # re-encoding forwards (2 x 15 rows, 2 x 11 at lm_head) stay under the GEMV's 32 rows too.
        assert gemv_rows[:n_cached] == [20] * 12 + [2] * (1 + 13 * (max_new - 1))
        assert gemv_rows[n_cached:] == ([30] * 12 + [22]) * max_new
    else:
        assert not gemv_rows

    # teacher forcing on the JAX tokens
    live = j_quant.make_live_vars(j_vars, jnp.float32)()
    lens_np = np.asarray(want_lens)
    Lv, Lp = 4, batch["input_ids"].shape[1]
    j_cache = j_llm.init_decoder_cache(2, 2, 1, Lv + Lp + max_new, 32, jnp.float32)
    j_logits, j_cache = jm.apply(live, batch, j_cache, lens_np, method=JPink.prefill)
    module = shell.module
    with torch.no_grad():
        cache = module.decoder.make_cache(2, Lv + Lp + max_new)
        logits, cache = module.prefill(tb, cache, lens)
        _close(logits, j_logits, atol)
        for t in range(max_new - 1):
            tok = want[np.arange(2), lens_np + t]
            pos = Lv + lens_np + t
            j_logits, j_cache = jm.apply(live, tok, pos, j_cache, method=JPink.decode_step)
            logits, cache = module.decode_step(torch.from_numpy(tok).long(),
                                               torch.from_numpy(pos), cache)
            _close(logits, j_logits, atol)
        chunk = np.array(want[:, 4:7])
        j_chunk, _ = jm.apply(live, chunk, np.array([8, 8]), j_cache, method=JPink.decode_chunk)
        out, _ = module.decode_chunk(torch.from_numpy(chunk).long(), torch.tensor([8, 8]), cache)
        _close(out, j_chunk, atol)


@pytest.mark.parametrize("kw", [dict(num_beams=4), dict(speculative=2), dict(do_sample=True)])
def test_generate_refuses_what_is_not_ported(pink_tiny, kw):
    """The name is kept from when these modes were refused. It checks that
    beams, speculation and sampling are served (held to JAX in
    ``tests/test_torch_generate_modes.py``): speculation gives greedy's
    tokens, beams their scores, sampling the same tokens from the same seed."""
    _, _, shell, batch = pink_tiny
    batch = shell.to_device(batch)
    stats = {}
    tokens, lens = shell.module.generate(batch, eos_id=1, max_length=5, stats=stats, **kw)
    greedy, _ = shell.module.generate(batch, eos_id=1, max_length=5)
    prompt = batch["input_mask"].bool()
    assert tokens.shape == greedy.shape
    assert torch.equal(tokens[:, :6][prompt], greedy[:, :6][prompt])
    if "speculative" in kw:
        assert torch.equal(tokens, greedy) and stats["n_steps"] >= 1
    elif "num_beams" in kw:
        assert stats["scores"].shape == (2,) and bool((stats["scores"] <= 0).all())
    else:
        assert torch.equal(tokens, shell.module.generate(batch, eos_id=1, max_length=5, **kw)[0])


EVA_TINY = dict(visual_tower="eva", eva_preset="eva_tiny_test", image_size=28)


# sequence parallelism stays refused, on the EVA tower, the serial adapters
# and the stacked layout too, and beside the (ported) int8 cache
@pytest.mark.parametrize("kw", [dict(sequence_parallel="ulysses", kv_int8=True, **EVA_TINY),
                                dict(sequence_parallel="ulysses", adapter_style="pink"),
                                dict(sequence_parallel="ring", kv_int8=True),
                                dict(sequence_parallel="ring", scan_layers=True),
                                dict(sequence_parallel="ring")])
def test_pink_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        TPink(**{**TINY, **kw})


# ----------------------------------------------------------------- predictor
TINY_OPTS = ["model_attributes.pink.dtype_str", "float32",
             "model_attributes.pink.vocab_override", "30522",  # the tokenizer's id space
             "predictor_parameters.decode_quant", "int4",
             "predictor_parameters.decode_quant_min_size", "256",
             "predictor_parameters.max_new_tokens", "6",
             "predictor_parameters.max_prompt_len", "48"]
REQUESTS = [{"text": "what is in the picture?"}, {"text": "describe the dog [0.1,0.2,0.5,0.9]"}]


@pytest.fixture(scope="module")
def jax_generation(tmp_path_factory):
    """The JAX GenerationPredictor on the tiny Pink config with
    ``decode_quant: int4``, its float weights (its seeded init, as it hands
    them to ``quantize_for_decode``) dumped as params.npz, and its answers."""
    cfg = JConfiguration.from_file(PINK_CFG).override_with_opts(TINY_OPTS).to_dict()
    quantized = []
    real = j_quant.quantize_for_decode
    with jitted_jax_init(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_quant, "quantize_for_decode",
                   lambda *a, **kw: quantized.append(a[0]) or real(*a, **kw))
        pred = JGenPredictor(cfg).load(with_ckpt=False)
    float_vars = quantized[0]
    assert j_quant.is_decode_quantized(pred.variables)
    assert not j_quant.is_decode_quantized(float_vars)
    tmp = tmp_path_factory.mktemp("pink_serving")
    np.savez(tmp / "params.npz", **flatten_flax(jax.device_get(float_vars["params"])))
    rng = np.random.default_rng(8)
    reqs = [{**r, "image": rng.random((40, 36, 3)).round(4).tolist()} for r in REQUESTS]
    return dict(dir=tmp, reqs=reqs, answers=[pred.predict(r) for r in reqs])


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_cli_generation_matches_jax_predictor(jax_generation, capsys, i):
    d = jax_generation["dir"]
    (d / "req.json").write_text(json.dumps(jax_generation["reqs"][i]))
    t_cli.main(["--config", PINK_CFG, "--predictor", "generation_predictor", "--device", "cpu",
                "--model_dir", str(d), "--input", str(d / "req.json"), *TINY_OPTS])
    out = json.loads(capsys.readouterr().out)
    ref = jax_generation["answers"][i]
    np.testing.assert_array_equal(np.asarray(out["generated_ids"]),
                                  np.asarray(ref["generated_ids"]))
    assert out["generated_text"] == ref["generated_text"]


def test_generation_predictor_serves_records(jax_generation):
    pred, _ = t_cli.build_predictor(
        ["--config", PINK_CFG, "--predictor", "generation_predictor", "--device", "cpu",
         "--no_ckpt", *TINY_OPTS])
    module = pred.shell.module
    assert module.decoder.layer_0.attention.q_proj.kernel_q8 is not None  # an int8 record
    sample = pred.build_sample(jax_generation["reqs"][0]).arrays()
    assert sample["input_ids"].shape == (1, 48) and sample["image_data"].shape == (1, 32, 32, 3)
    out = pred.predict(jax_generation["reqs"][0])
    assert out["generated_ids"].shape == (1, 48 + 6) and isinstance(out["generated_text"], str)


@pytest.mark.parametrize("key,value", [("num_beams", "4"), ("speculative", "2"),
                                       ("do_sample", "true"), ("tensor_parallel", "2"),
                                       ("decode_quant", "int8")])
def test_generation_predictor_refuses_what_is_not_ported(key, value, jax_generation):
    """The name is kept from when these options were refused. It checks that
    ``tensor_parallel`` is refused, and that the decoding options and int8
    weights are served."""
    argv = ["--config", PINK_CFG, "--predictor", "generation_predictor", "--device", "cpu",
            "--no_ckpt", *TINY_OPTS, f"predictor_parameters.{key}", value]
    if key == "tensor_parallel":
        with pytest.raises(NotImplementedError, match="not ported"):
            t_cli.build_predictor(argv)
        return
    pred, _ = t_cli.build_predictor(argv)
    out = pred.predict(jax_generation["reqs"][0])
    assert out["generated_ids"].shape == (1, 48 + 6) and isinstance(out["generated_text"], str)
    if key == "decode_quant":
        module = pred.shell.module
        assert module.decoder.layer_0.attention.q_proj.kernel_q8 is not None
        assert module.lm_head.kernel_q8 is not None
    else:
        assert pred.decode_options[key] == (True if value == "true" else int(value))


@pytest.mark.parametrize("template", ["vicuna_v1", "llama2", "simple", "plain"])
def test_build_prompt_matches_jax(template):
    for q in ("what is this?", "where is the cat [0.1,0.2,0.3,0.4]"):
        assert t_build_prompt(q, template) == j_build_prompt(q, template)
