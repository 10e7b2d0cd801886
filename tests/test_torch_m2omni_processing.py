"""M2-omni's unified processor and its serving in the port against the JAX
package, on the CPU.

Tolerances:

* ``smart_resize``, ``patchify``/``frames_from_patches``, the chat and
  system templates, the token expansions, the special-token tokenisation,
  the fbank (``log_mel_fbank``, LFR, CMVN, ``SANMAudioProcessor``), the
  simplified processor and ``M2OmniUnifiedProcessor`` (text with an image
  and audio; a conversation with a video): equal to the JAX copies, atol 0;
* the port's numpy bicubic resize against Pillow's BICUBIC at upscale and
  downscale sizes: atol 0 (the JAX package calls Pillow);
* ``GenerationPredictor`` with ``unified_processor`` on
  ``tests/test_caption_predictor.py::test_generation_predictor_m2omni_conversation``'s
  config (a vocabulary whose ids fit ``omni_tiny_test``'s 1000): the prompt
  ids and the generated tokens equal to JAX's for a text request with an
  image and for a conversation; a video and an audio request served;
* the CLI on ``m2_omni_7b.yml`` with ``serving_opts`` and the tiny presets
  serves a conversation on the CPU.
"""

import json
import wave as wave_file

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from antmmf_torch.datasets.processors import audio_processors as t_ap
from antmmf_torch.datasets.processors import m2omni_processing as t_mp
from antmmf_torch.predictors import cli
from antmmf_torch.predictors.generation_predictor import GenerationPredictor
from antmmf_torch.predictors.m2_omni_serving import M2_OMNI_7B, serving_opts
from antmmf_tpu.datasets.processors import audio_processors as j_ap
from antmmf_tpu.datasets.processors import m2omni_processing as j_mp
from test_torch_m2omni import load_reached
from test_torch_qwen2_vit import random_params
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

# enough words of the prompts and the system template for a tiny vocabulary
WORDS = ("you are a helpful language , vision and audio assistant . able to understand the "
         "visual content that user provides assist with variety of tasks using natural "
         "< > | _ start header id end eot system what is in here describe image video "
         "listen this").split()


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    return str(path)


def wave(seconds=2.6, seed=0):
    return np.random.default_rng(seed).standard_normal(int(16000 * seconds)).astype(np.float32) * 0.1


def assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_smart_resize_and_patches_match_jax():
    for args in ((375, 500, 28, 448 * 448, 448 * 448), (24, 24, 8, 576, 576), (1000, 60, 28),
                 (56, 56, 28, 56 * 56, 28 * 28 * 1280), (4000, 3000, 28)):
        assert t_mp.smart_resize(*args) == j_mp.smart_resize(*args)
    with pytest.raises(ValueError, match="aspect ratio"):
        t_mp.smart_resize(28, 28 * 201)
    frames = np.random.default_rng(1).standard_normal((3, 3, 16, 24)).astype(np.float32)
    flat, grid = t_mp.patchify(frames, 4, 2, 2)
    j_flat, j_grid = j_mp.patchify(frames, 4, 2, 2)
    assert grid == j_grid == (2, 4, 6)
    np.testing.assert_array_equal(flat, j_flat)
    dense = t_mp.frames_from_patches(flat, grid, 4, 2, 2)
    np.testing.assert_array_equal(dense, j_mp.frames_from_patches(j_flat, j_grid, 4, 2, 2))
    np.testing.assert_array_equal(dense[:3], frames.transpose(0, 2, 3, 1))  # the 4th repeats


@pytest.mark.parametrize("size,out", [((375, 500), (392, 532)), ((30, 33), (112, 84)),
                                      ((64, 48), (24, 40)), ((500, 375), (56, 28)),
                                      ((17, 200), (28, 56))])
def test_bicubic_resize_equals_pillow(size, out):
    img = np.random.default_rng(size[0]).integers(0, 256, size + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((out[1], out[0]), Image.BICUBIC))
    np.testing.assert_array_equal(t_mp.resize_bicubic(img, *out), ref)
    np.testing.assert_array_equal(t_mp.resize_bicubic(img, *out), j_mp.resize_bicubic(img, *out))


def test_templates_expansion_and_tokens_match_jax(tiny_vocab):
    img = np.zeros((24, 24, 3), np.uint8)
    conv = [{"role": "user", "content": [
        {"type": "image", "image": [img, img]}, {"type": "video", "video": "v.mp4"},
        {"type": "audio", "audio": "a.wav"}, {"type": "text", "text": "describe this"}]},
        {"role": "assistant", "content": [{"type": "text", "text": "图像"}]}]
    text = t_mp.apply_chat_template(conv, add_generation_prompt=True)
    assert text == j_mp.apply_chat_template(conv, add_generation_prompt=True)
    assert "你是" in text and text.count("<image>") == 2
    grids = np.array([[1, 4, 6], [2, 2, 2], [1, 2, 2], [1, 2, 4]])  # 2 + 2 images
    texts = [text, "<image> and <image>"]
    for name, args in (("expand_image_tokens", (grids,)), ("expand_video_tokens", (grids[:1],)),
                       ("expand_audio_tokens", (5,))):
        assert getattr(t_mp, name)(texts, *args) == getattr(j_mp, name)(texts, *args)
    assert t_mp.expand_audio_tokens(["no marker"], 2) == ["no marker<audio><audioPatch>"
                                                          "<audioPatch></audio>\n"]
    proc = t_mp.M2OmniUnifiedProcessor({"text": {"vocab_file": tiny_vocab}})
    j_proc = j_mp.M2OmniUnifiedProcessor({"text": {"vocab_file": tiny_vocab}})
    expanded = t_mp.expand_image_tokens(texts, grids)[0]
    assert proc._tokenize_ids(expanded) == j_proc._tokenize_ids(expanded)


def test_fbank_and_audio_processors_match_jax():
    w = wave()
    for fn, args in (("log_mel_fbank", (w, 16000, 80)), ("mel_filterbank", (80, 512, 16000))):
        np.testing.assert_array_equal(getattr(t_ap, fn)(*args), getattr(j_ap, fn)(*args))
    feats = t_ap.log_mel_fbank(w, up_sample=True)
    lfr = t_ap.apply_lfr(feats)
    np.testing.assert_array_equal(lfr, j_ap.apply_lfr(feats))
    np.testing.assert_array_equal(t_ap.apply_cmvn(lfr), j_ap.apply_cmvn(lfr))
    stats = np.random.default_rng(2).random((2, 560)).astype(np.float32)
    np.testing.assert_array_equal(t_ap.de_normalize(lfr, *stats), j_ap.de_normalize(lfr, *stats))
    item = {"waveform": w}
    out = t_ap.SANMAudioProcessor({})(item)
    assert_same(out, j_ap.SANMAudioProcessor({})(item))
    assert out["fbank"].shape == (256, 560) and out["num_frames"] == 43  # 2.6 s at LFR 6
    simple = {"text": "<image> what is <audio> here", "image": np.zeros((40, 40, 3), np.uint8),
              "waveform": w}
    cfg = {"image": {"size": 32}, "num_image_tokens": 4, "num_audio_tokens": 3}
    assert_same(t_ap.M2OmniProcessor(cfg)(simple), j_ap.M2OmniProcessor(cfg)(simple))


def test_unified_processor_matches_jax(tiny_vocab):
    rng = np.random.default_rng(3)
    cfg = {"text": {"vocab_file": tiny_vocab, "max_seq_length": 96},
           "image": {"min_pixels": 576, "max_pixels": 576, "patch_size": 4},
           "video": {"min_pixels": 256, "max_pixels": 256}, "num_audio_tokens": 5}
    proc, j_proc = t_mp.M2OmniUnifiedProcessor(cfg), j_mp.M2OmniUnifiedProcessor(cfg)
    img = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    video = rng.integers(0, 256, (3, 20, 20, 3), dtype=np.uint8)
    for item in ({"text": "what is in <image> here <audio>", "images": [img], "waveform": wave()},
                 {"conversation": [{"role": "user", "content": [
                     {"type": "video", "video": list(video)}, {"type": "text", "text": "describe"}]}]}):
        out = proc(item)
        assert_same(out, j_proc(item))
    assert out["video_data"][0].shape == (4, 16, 16, 3)  # 3 frames padded to 4, 16²


def test_a_video_path_without_opencv_raises(monkeypatch):
    monkeypatch.setattr(t_mp, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        t_mp.fetch_video({"video": "clip.mp4"})
    with pytest.raises(RuntimeError, match="OpenCV"):
        t_mp.fetch_image({"image": "frame.jpg"})


def predictor_config(vocab):
    """``test_generation_predictor_m2omni_conversation``'s config, with a
    vocabulary inside omni_tiny_test's 1000 ids and the conv audio tower at
    32 (JAX's predictor makes no audio params: its init example has none)."""
    return {
        "model_attributes": {"m2_omni": {
            "lm_preset": "omni_tiny_test", "visual_tower": "qwen2",
            "qwen2_preset": "qwen2_vit_tiny_test", "image_token_id": 1, "audio_token_id": 2,
            "audio_hidden": 32, "dtype_str": "float32"}},
        "predictor_parameters": {
            "max_new_tokens": 4, "vocab_file": vocab,
            "unified_processor": {
                "text": {"vocab_file": vocab, "max_seq_length": 48},
                "image": {"min_pixels": 576, "max_pixels": 576, "patch_size": 4,
                          "merge_size": 2}}}}


def test_generation_predictor_serves_unified_requests_as_jax(tiny_vocab, monkeypatch):
    from antmmf_tpu.common.registry import registry
    from antmmf_tpu.models.base_model import ModelShell
    import antmmf_tpu.predictors  # noqa: F401

    # JAX's predictor draws its init eagerly, op by op (about 230 compiles
    # here); the port takes JAX's params whatever they are, so draw them
    # with numpy from the init's shapes instead
    monkeypatch.setattr(ModelShell, "init", lambda self, rng, batch: {
        "params": random_params(self.module, batch, seed=7)})
    config = predictor_config(tiny_vocab)
    j_pred = registry.get_predictor_class("generation_predictor")(config)
    j_pred.load(with_ckpt=False)
    pred = GenerationPredictor({**config, "predictor_parameters": {
        **config["predictor_parameters"], "device": "cpu"}}).load(with_ckpt=False)
    load_reached(pred.shell.module, j_pred.variables["params"])
    img = np.random.default_rng(4).integers(0, 256, (24, 24, 3), dtype=np.uint8)
    for request in ({"text": "what is in <image> here", "images": [img]},
                    {"conversation": [{"role": "user", "content": [
                        {"type": "image", "image": img},
                        {"type": "text", "text": "describe the image"}]}]}):
        sample = pred.build_sample(request).arrays()
        j_sample = j_pred.build_sample(request).arrays()
        assert_same({k: sample[k] for k in j_sample}, j_sample)
        out, j_out = pred.predict(request), j_pred.predict(request)
        np.testing.assert_array_equal(out["generated_ids"], np.asarray(j_out["generated_ids"]))
        assert out["generated_text"] == j_out["generated_text"]


def test_generation_predictor_serves_video_and_audio(tiny_vocab):
    """A video (frames as ``image_data``: 4 frames → 2 temporal groups of
    3x3 merged tokens) and a waveform (the conv tower's 64 tokens) in one
    request, on the port alone: JAX's predictor builds its params from an
    image-only example and so has no audio tower."""
    config = predictor_config(tiny_vocab)
    pp = config["predictor_parameters"]
    pp["device"] = "cpu"
    pp["unified_processor"].update(text={"vocab_file": tiny_vocab, "max_seq_length": 128},
                                   video={"min_pixels": 576, "max_pixels": 576},
                                   num_audio_tokens=64)
    pred = GenerationPredictor(config).load(with_ckpt=False)
    video = np.random.default_rng(5).integers(0, 256, (4, 24, 24, 3), dtype=np.uint8)
    request = {"text": "describe <video> and <audio>", "video": video, "waveform": wave(1.0)}
    sample = pred.build_sample(request).arrays()
    assert sample["image_data"].shape == (1, 4, 24, 24, 3)
    assert sample["audio"].shape == (1, 256, 560) and sample["audio_mask"].sum() == 17
    ids = sample["input_ids"][0]
    assert (ids == 1).sum() == 2 * 9 and (ids == 2).sum() == 64  # the video and audio runs
    out = pred.predict(request)
    assert out["generated_ids"].shape == (1, 128 + 4)
    assert isinstance(out["generated_text"], str)
    assert isinstance(pred.predict(pred.example_data())["generated_text"], str)


def test_generation_predictor_refusals(tiny_vocab):
    config = predictor_config(tiny_vocab)
    for key, value in (("num_beams", 2), ("do_sample", True), ("speculative", 2),
                       ("decode_quant", "int4"), ("tensor_parallel", 2)):
        pp = {**config["predictor_parameters"], "device": "cpu", key: value}
        with pytest.raises(NotImplementedError, match=key):
            GenerationPredictor({**config, "predictor_parameters": pp}).load(with_ckpt=False)


def test_cli_serves_a_conversation_on_the_composed_config(tiny_vocab, tmp_path, capsys):
    """``python -m antmmf_torch.predictors.cli`` on ``m2_omni_7b.yml`` with
    ``serving_opts``, cut to the tiny presets (and to small images and
    ids inside their vocabulary)."""
    up = "predictor_parameters.unified_processor"
    opts = serving_opts(lm_preset="omni_tiny_test", qwen2_preset="qwen2_vit_tiny_test",
                        audio_hidden=32, image_token_id=1, audio_token_id=2,
                        dtype_str="float32")
    opts += [f"{up}.image.min_pixels", "576", f"{up}.image.max_pixels", "576",
             f"{up}.image.patch_size", "4", f"{up}.text.vocab_file", tiny_vocab,
             "predictor_parameters.vocab_file", tiny_vocab,
             "predictor_parameters.max_new_tokens", "3"]
    image, audio = str(tmp_path / "image.png"), str(tmp_path / "audio.wav")
    cv2.imwrite(image, np.random.default_rng(6).integers(0, 256, (24, 24, 3), dtype=np.uint8))
    with wave_file.open(audio, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((wave(0.5) * 32767).astype(np.int16).tobytes())
    request = tmp_path / "req.json"
    request.write_text(json.dumps({"conversation": [{"role": "user", "content": [
        {"type": "image", "image": image}, {"type": "audio", "audio": audio},
        {"type": "text", "text": "what is in here"}]}]}))
    torch.manual_seed(0)
    cli.main(["--config", M2_OMNI_7B, "--predictor", "generation_predictor", "--device", "cpu",
              "--no_ckpt", "--input", str(request), *opts])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(out["generated_text"], str)
    assert np.asarray(out["generated_ids"]).shape == (1, 640 + 3)
