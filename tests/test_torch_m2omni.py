"""M2-omni in the port against the JAX package, on the CPU.

``M2Omni`` at ``omni_tiny_test`` (hidden 64, 2 layers, 2 heads of 32, 1 kv
head), fp32, with inputs drawn with numpy from a seed and JAX parameters
drawn with numpy (``test_torch_qwen2_vit.random_params``: every LoRA ``b``
live) carried by the weight bridge. Tolerances:

* the model in both layouts (spliced; prefix) with each tower pair (Qwen2-ViT,
  spliced from two visual streams, or the ViT; the conv tower or SANM with
  a ragged ``audio_mask``), 3D RoPE
  on and off, decoder LoRA on all seven projections, tower LoRA,
  ``mlp_depths`` 2 and ``scan_layers``: the logits at atol 1e-5 of their
  largest magnitude, ``lm_loss`` at atol 1e-5, ``lm_acc`` equal;
  ``_lm_loss_chunked`` over chunks of 4 equal to ``_lm_loss`` at atol 1e-6
  and to JAX's at 1e-5;
* the bridge: the port's export equal to the JAX tree bit for bit
  (``vision_proj_{i}``/``audio_proj_{i}``, the conv kernels HWIO, SANM's
  ``fsmn_kernel``, the stacked ``decoder/layers``), and a ``params.npz``
  of it run by JAX to the same logits bit for bit and served by the port
  from that ``model_dir`` to the same logits bit for bit;
* ``get_rope_index``: positions and the next base equal to JAX's and to the
  reference recurrence (``rope_index_recurrence`` below, the scan JAX keeps
  as its oracle) on two images in a row, a video run and ragged rows; a
  mixed image + video row equal to JAX's under both
  ``mixed_vision_grid_positions``; a stream of 33,000 one-slot runs, where
  the port's int64 form gives the recurrence's positions and JAX's int32
  shift (1 << 16 times the run id) has overflowed;
* greedy ``generate`` on ``tests/test_llm_generate.py``'s
  ``omni_tiny_spliced`` rows: the tokens equal to JAX's; the next RoPE
  position is not the next cache slot, and the decode step reads it;
* the splice clips the k-th placeholder to the last modal token (a run
  longer than the tower's output repeats it), as JAX does;
* ``m2_omni_tiny.local.yml`` through ``build_config`` → ``build_model``: the
  logits at atol 1e-5 of their magnitude against JAX's model of the same
  attributes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.checkpoint import find_weights, load_weights
from antmmf_torch.models.m2_omni import AUDIO_FEATURES, M2Omni as TM
from antmmf_torch.utils.weights import export_flax_params, flatten_flax, load_flax_params
from antmmf_tpu.models.m2_omni import M2Omni as JM
from test_torch_qwen2_vit import assert_close, random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

TINY = dict(lm_preset="omni_tiny_test", dtype_str="float32")
QWEN2 = dict(visual_tower="qwen2", qwen2_preset="qwen2_vit_tiny_test")
VIT = dict(visual_tower="vit", vit_preset="vit_tiny_test", image_size=32)
CONV, SANM = dict(audio_hidden=32), dict(audio_tower="sanm", sanm_preset="sanm_tiny_test")
SPLICE = dict(image_token_id=3, audio_token_id=4)
CASES = {
    "qwen2_conv_spliced_lora_all_scan": {**QWEN2, **CONV, **SPLICE, "llm_lora_rank": 2,
                                         "llm_lora_targets": "all", "scan_layers": True},
    "qwen2_sanm_spliced_mlp2_vit_lora": {**QWEN2, **SANM, **SPLICE, "mlp_depths": 2,
                                         "vit_lora_rank": 2},
    "vit_conv_spliced_rope_1d": {**VIT, **CONV, **SPLICE, "rope_3d": False},
    "vit_sanm_prefix": {**VIT, **SANM},
}


def case_batch(kw, seed=0):
    """Two right-padded rows with image runs and an audio run (spliced), or
    the text alone (prefix), the image and audio inputs, and labels. With
    Qwen2-ViT the spliced rows hold two images, two visual streams (a list)
    whose runs a text token separates."""
    rng = np.random.default_rng(seed)
    qwen2 = kw["visual_tower"] == "qwen2"
    if qwen2 and "image_token_id" in kw:  # grids (1, 2, 3) and (1, 2, 2): 6 + 4 slots
        img = [rng.standard_normal((2, 16, 24, 3)), rng.standard_normal((2, 16, 16, 3))]
        runs = [3] * 6 + [11] + [3] * 4
    elif qwen2:
        img, runs = rng.standard_normal((2, 16, 24, 3)), []
    else:  # 2 frames of 4 tokens
        img, runs = rng.standard_normal((2, 2, 32, 32, 3)), [3] * 8
    if kw.get("audio_tower") == "sanm":
        audio = rng.standard_normal((2, 13, 24))  # 4 tokens after compression by 3
    else:
        audio = rng.standard_normal((2, 16, AUDIO_FEATURES))  # 4 tokens after two stride-2 convs
    if "image_token_id" in kw:
        ids = np.array([[5] + runs + [6] + [4] * 4 + [7, 8, 0],
                        [9] + runs + [10, 11] + [4] * 4 + [12, 13]])
    else:
        ids = np.array([[5, 6, 7, 8, 0], [9, 10, 11, 12, 13]])
    mask = (ids != 0).astype(np.int64)
    img = [x.astype(np.float32) for x in img] if isinstance(img, list) else img.astype(np.float32)
    return {"input_ids": ids, "input_mask": mask, "image_data": img,
            "audio": audio.astype(np.float32),
            "audio_mask": (np.arange(audio.shape[1])[None] < np.array([[audio.shape[1]], [9]])
                           ).astype(np.int32),
            "labels": np.where(mask > 0, ids, -1)}


def jax_batch(batch):
    return {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
            for k, v in batch.items()}


def torch_batch(batch):
    return {k: [torch.as_tensor(x) for x in v] if isinstance(v, list) else torch.as_tensor(v)
            for k, v in batch.items()}


def load_reached(model, params):
    """JAX params into the port where flax made them: flax makes a setup
    submodule's params only when its init call reaches it (an init batch
    without audio makes no audio tower), the port builds every tower, so
    the towers JAX lacks keep the port's values."""
    flat = flatten_flax(export_flax_params(model))
    flat.update(flatten_flax(params))
    load_flax_params(model, flat)


def torch_model(kw, params):
    model = TM(**TINY, **kw, device="cpu")
    load_reached(model, params)
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_m2omni_matches_jax(case, tmp_path):
    kw = CASES[case]
    batch = case_batch(kw)
    jm = JM(**TINY, **kw)
    params = random_params(jm, jax_batch(batch), seed=1)
    j_apply = jax.jit(lambda p, b: jm.apply({"params": p}, b))
    ref = j_apply(params, jax_batch(batch))
    tm = torch_model(kw, params)
    with torch.no_grad():
        out = tm(torch_batch(batch))
    assert_close(out["logits"], ref["logits"])
    np.testing.assert_allclose(float(out["losses"]["lm_loss"]), float(ref["losses"]["lm_loss"]),
                               atol=1e-5, rtol=0)
    assert float(out["metrics"]["lm_acc"]) == float(ref["metrics"]["lm_acc"])
    # the chunked loss as a forward
    labels = torch.as_tensor(batch["labels"])
    with torch.no_grad():
        chunked = tm._lm_loss_chunked(out["hidden"], labels, chunk=4)
    np.testing.assert_allclose(float(chunked["losses"]["lm_loss"]),
                               float(out["losses"]["lm_loss"]), atol=1e-6, rtol=0)
    assert float(chunked["metrics"]["lm_acc"]) == float(out["metrics"]["lm_acc"])
    j_chunked = jax.jit(lambda p, h, y: jm.apply({"params": p}, h, y, 4,
                                                 method=JM._lm_loss_chunked))(
        params, ref["hidden"], jnp.asarray(batch["labels"]))
    np.testing.assert_allclose(float(chunked["losses"]["lm_loss"]),
                               float(j_chunked["losses"]["lm_loss"]), atol=1e-5, rtol=0)
    # the bridge back: the JAX tree bit for bit, and a params.npz JAX runs
    exported, flat = flatten_flax(export_flax_params(tm)), flatten_flax(params)
    assert set(exported) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(exported[path], leaf, err_msg=path)
    if kw.get("scan_layers"):
        assert any(p.startswith("decoder/layers/") for p in exported)
        np.savez(tmp_path / "params.npz", **exported)
        with np.load(tmp_path / "params.npz") as npz:
            tree = {}
            for path in npz.files:
                node = tree
                *scopes, name = path.split("/")
                for scope in scopes:
                    node = node.setdefault(scope, {})
                node[name] = jnp.asarray(npz[path])
        again = j_apply(tree, jax_batch(batch))
        np.testing.assert_array_equal(np.asarray(again["logits"]), np.asarray(ref["logits"]))
        served = TM(**TINY, **kw, device="cpu")  # a model_dir's load
        load_weights(served, find_weights(str(tmp_path)))
        with torch.no_grad():
            again = served(torch_batch(batch))["logits"]
        np.testing.assert_array_equal(again.numpy(), out["logits"].numpy())


def rope_index_recurrence(modal_mask, run_start, rel):
    """The reference ``get_rope_index`` recurrence, slot by slot: a text
    slot takes (base, base, base) and advances base by 1; a placeholder slot
    takes its run's base + its relative (t, h, w) and sets base to the run's
    base + the run's largest coordinate so far + 1."""
    B, L = modal_mask.shape
    pos, nxt = np.zeros((B, L, 3), np.int64), np.zeros(B, np.int64)
    for b in range(B):
        base = run_base = run_max = 0
        for i in range(L):
            cur = int(rel[b, i].max())
            if run_start[b, i]:
                run_base, run_max = base, cur
            elif modal_mask[b, i]:
                run_max = max(run_max, cur)
            pos[b, i] = run_base + rel[b, i] if modal_mask[b, i] else base
            base = run_base + run_max + 1 if modal_mask[b, i] else base + 1
        nxt[b] = base
    return pos, nxt


def grid(t, h, w):
    return [(a, b, c) for a in range(t) for b in range(h) for c in range(w)]


LAYOUTS = {
    # T [image 1x2x2] T T [image 1x2x2] T: two streams of one image each
    "two_images": ([[7] + [3] * 4 + [8, 9] + [3] * 4 + [10]], grid(1, 2, 2) * 2),
    # T [video 2x2x3] T T
    "video_run": ([[7] + [3] * 12 + [8, 9]], grid(2, 2, 3)),
    # ragged rows, a run at the start of one and at the end of the other
    "ragged_rows": ([[3] * 6 + [7, 8, 9, 10], [7, 8, 9, 10] + [3] * 6], grid(1, 2, 3)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_get_rope_index_matches_jax_and_the_recurrence(layout):
    ids, modal = LAYOUTS[layout]
    ids = np.array(ids)
    modal_pos = np.broadcast_to(np.array(modal)[None], (len(ids),) + np.shape(modal)).copy()
    rel, start = TM._modal_rel_positions(torch.as_tensor(ids == 3), torch.as_tensor(modal_pos))
    pos, nxt = TM.get_rope_index(torch.as_tensor(ids == 3), start, rel)
    j_rel, j_start = jax.jit(JM._modal_rel_positions)(jnp.asarray(ids == 3),
                                                      jnp.asarray(modal_pos))
    j_pos, j_nxt = jax.jit(JM.get_rope_index)(jnp.asarray(ids == 3), j_start, j_rel)
    want_pos, want_nxt = rope_index_recurrence(ids == 3, start.numpy(), rel.numpy())
    assert pos.dtype == torch.int64
    np.testing.assert_array_equal(rel.numpy(), np.asarray(j_rel))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_nxt))
    np.testing.assert_array_equal(nxt.numpy(), want_nxt)


def test_get_rope_index_past_32768_runs():
    """33,000 runs of one slot each, back to back, rel (0, 0, 1): the run
    ids pass 32,767, where JAX's int32 shift overflows."""
    runs = 33_000
    modal_mask = run_start = np.ones((1, runs), bool)
    rel = np.tile(np.array([[0, 0, 1]]), (runs, 1))[None]
    pos, nxt = TM.get_rope_index(torch.as_tensor(modal_mask), torch.as_tensor(run_start),
                                 torch.as_tensor(rel))
    want_pos, want_nxt = rope_index_recurrence(modal_mask, run_start, rel)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(nxt.numpy(), want_nxt)
    j_pos, _ = jax.jit(JM.get_rope_index)(jnp.asarray(modal_mask), jnp.asarray(run_start),
                                          jnp.asarray(rel))
    j_pos = np.asarray(j_pos)
    cut = 32_767  # the slots of the runs whose id·2¹⁶ still fits int32
    np.testing.assert_array_equal(j_pos[:, :cut], want_pos[:, :cut])
    assert not np.array_equal(j_pos, want_pos)  # the overflow (ROADMAP queue C)


@pytest.mark.parametrize("mixed", [False, True])
def test_mixed_image_and_video_positions_match_jax(mixed):
    """A row with an image run and a video run: with the reference's quirk
    (``mixed_vision_grid_positions`` off) the image slots keep sequential
    text positions; on, both runs get their grids."""
    kw = {**QWEN2, "image_token_id": 3, "video_token_id": 5,
          "mixed_vision_grid_positions": mixed}
    rng = np.random.default_rng(3)
    ids = np.array([[7] + [3] * 6 + [8] + [5] * 12 + [9, 10]])
    batch = {"input_ids": ids, "input_mask": np.ones_like(ids),
             "image_data": rng.standard_normal((1, 16, 24, 3)).astype(np.float32),
             "video_data": rng.standard_normal((1, 4, 16, 24, 3)).astype(np.float32)}
    jm = JM(**TINY, **kw)
    params = random_params(jm, jax_batch(batch), seed=4)
    j_pos, j_next, j_logits = jax.jit(lambda p, b: (
        *jm.apply({"params": p}, b, b["input_ids"], True, method=JM._assemble_spliced)[1:],
        jm.apply({"params": p}, b)["logits"]))(params, jax_batch(batch))
    tm = torch_model(kw, params)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        _, pos, nxt = tm._assemble_spliced(tb, tb["input_ids"])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_next))
    image = pos[0, 1:7].numpy()
    assert (image == np.arange(1, 7)[:, None]).all() != mixed  # sequential text positions
    assert_close(tm(tb)["logits"], j_logits)


@pytest.fixture(scope="module")
def omni_tiny_spliced():
    """``tests/test_llm_generate.py``'s fixture: the ViT tower at 32², image
    id 3, two rows with a run of 4 image slots, one right-padded."""
    model = JM(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
               image_token_id=3, audio_token_id=None, dtype_str="float32")
    rng = jax.random.PRNGKey(0)
    ids = jnp.array([[5] + [3] * 4 + [6, 7, 8, 0, 0], [9] + [3] * 4 + [10, 11, 12, 13, 14]],
                    jnp.int32)
    batch = {"input_ids": ids, "input_mask": (ids != 0).astype(jnp.int32),
             "image_data": jax.random.normal(rng, (2, 1, 32, 32, 3))}
    return model, {"params": random_params(model, batch, seed=6)}, batch


def test_generate_greedy_matches_jax(omni_tiny_spliced):
    jm, variables, batch = omni_tiny_spliced
    want, want_lens = jm.generate(variables, batch, eos_id=1, max_length=4)
    tm = TM(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
            image_token_id=3, dtype_str="float32", device="cpu")
    load_reached(tm, variables["params"])
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    got, lens = tm.generate(tb, eos_id=1, max_length=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    # the image run's 2x2 grid advances the RoPE base by 2 over its 4 slots
    with torch.inference_mode():
        logits, cache, lens_full, next_p = tm.prefill(tb, 4)
        np.testing.assert_array_equal(next_p.numpy(), lens_full.numpy() - 2)
        token = logits.argmax(-1)
        cache_copy = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        right, _ = tm.decode_step(token, next_p, lens_full, cache)
        wrong, _ = tm.decode_step(token, lens_full, lens_full, cache_copy)
    assert not torch.allclose(right, wrong, atol=1e-4)


def test_splice_clips_a_long_run_to_the_last_modal_token():
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal((1, 8, 4)).astype(np.float32)
    modal = rng.standard_normal((1, 3, 4)).astype(np.float32)
    ids = np.array([[7, 3, 3, 3, 3, 3, 8, 9]])  # 5 placeholders for 3 modal tokens
    got = TM._splice_embeds(torch.as_tensor(embeds), torch.as_tensor(ids), 3,
                            torch.as_tensor(modal)).numpy()
    ref = np.asarray(JM._splice_embeds(jnp.asarray(embeds), jnp.asarray(ids), 3,
                                       jnp.asarray(modal)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 1:6], modal[0, [0, 1, 2, 2, 2]])
    np.testing.assert_array_equal(got[0, [0, 6, 7]], embeds[0, [0, 6, 7]])


def test_builds_from_the_fixture_config():
    """``m2_omni_tiny.local.yml`` through the port's config path
    (``build_config`` → ``build_model``), held against the JAX model of the
    same attributes on a spliced batch (image ids 999, audio ids 998)."""
    from antmmf_torch.common.build import build_config
    from antmmf_torch.models.base_model import build_model

    cfg = build_config("projects/m2_omni/configs/m2_omni_tiny.local.yml")
    shell = build_model(cfg, device="cpu")
    assert isinstance(shell.module, TM) and shell.module.decoder.layer_0.attention.lora_targets
    attrs = dict(cfg["model_attributes"]["m2_omni"])
    batch = case_batch(VIT)
    ids = batch["input_ids"]
    batch["input_ids"] = np.where(ids == 3, 999, np.where(ids == 4, 998, ids))
    jm = JM(**attrs)
    params = random_params(jm, jax_batch(batch), seed=2)
    ref = jax.jit(lambda p, b: jm.apply({"params": p}, b))(params, jax_batch(batch))
    load_reached(shell.module, params)
    with torch.no_grad():
        out = shell.module(torch_batch(batch))
    assert_close(out["logits"], ref["logits"])


def test_unported_options_raise_by_key():
    for kv_int8 in (False, True):  # the int8 cache is ported; sequence parallelism is not
        with pytest.raises(NotImplementedError, match="sequence_parallel"):
            TM(**TINY, **VIT, sequence_parallel="ring", kv_int8=kv_int8, device="cpu")
    assert TM(**TINY, **VIT, kv_int8=True, device="cpu").decoder.make_cache(
        1, 4, quantized=True)[0]["k"].dtype == torch.int8
    # beams, sampling and speculation decode (held to JAX in
    # tests/test_torch_generate_modes.py)
    tm = TM(**TINY, **VIT, image_token_id=3, device="cpu")
    batch = {"input_ids": torch.ones(1, 3, dtype=torch.long)}
    for key, value in (("num_beams", 2), ("do_sample", True), ("speculative", 3)):
        tokens, lens = tm.generate(batch, max_length=4, **{key: value})
        assert tokens.shape == (1, 3 + 4) and int(lens[0]) == 3, key
