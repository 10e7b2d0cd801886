"""The port's UniVL retrieval serving path against the JAX package, on the CPU.

The tiny presets (vit_tiny_test, bert_tiny_test, D=32 heads) run in fp32:
the whole model at token_merge_r 0 and 1 with the same numpy-drawn weights,
and the predictor and CLI against the JAX ``BatchPredictor`` on the same
weights (the JAX predictor's init, dumped to ``params.npz``). Tolerance:
atol 1e-4 on ``text_embed``, ``visual_embed`` and ``sim`` (four fp32 layers
and a logit scale of 14.3 between the inputs and ``sim``).
"""

import json

import jax
import numpy as np
import pytest
import torch

from antmmf_torch.common.configuration import Configuration as TConfiguration
from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor as TProc
from antmmf_torch.models.base_model import build_model
from antmmf_torch.predictors import cli as t_cli
from antmmf_torch.predictors.base_predictor import BasePredictor as TPredictor
from antmmf_torch.utils.weights import flatten_flax, load_flax_params
from antmmf_tpu.common.configuration import Configuration as JConfiguration
from antmmf_tpu.datasets.processors.text_processors import MaskedTokenProcessor as JProc
from antmmf_tpu.models.univl import UnivlForVideoTextRetrieval as JUnivl
from antmmf_tpu.predictors.base_predictor import BatchPredictor as JBatchPredictor

ATOL = 1e-4
SERVING = "projects/base_vtp/configs/serving.yml"
TINY = ["model_attributes.univl_retrieval.vit_preset", "vit_tiny_test",
        "model_attributes.univl_retrieval.bert_preset", "bert_tiny_test",
        "model_attributes.univl_retrieval.image_size", "32",
        "model_attributes.univl_retrieval.embed_dim", "32",
        "model_attributes.univl_retrieval.dtype_str", "float32"]
TINY_MODEL = dict(vit_preset="vit_tiny_test", bert_preset="bert_tiny_test", image_size=32,
                  embed_dim=32, dtype_str="float32")
CAPTIONS = ["a dog runs on the beach", "two people play tennis!",
            "Crème brûlée is served — 很好吃", "a cat"]


def _batch(rng, B=3, F=2):
    lens = np.array([30, 12, 5])[:B]
    mask = (np.arange(30)[None] < lens[:, None]).astype(np.int64)
    return {"image_data": rng.random((B, F, 32, 32, 3), dtype=np.float32),
            "caption_input_ids": rng.integers(1, 30522, size=(B, 30)) * mask,
            "caption_input_mask": mask,
            "caption_segment_ids": np.zeros((B, 30), np.int64)}


def _random_params(params, rng):
    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32) * 0.2
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return noise + 1.0
        return np.float32(2.6592) if leaf.ndim == 0 else noise  # logit_scale

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("r", [0, 1])
def test_tiny_model_matches_jax(r):
    rng = np.random.default_rng(r)
    batch = _batch(rng)
    jm = JUnivl(token_merge_r=r, **TINY_MODEL)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)["params"], rng)
    ref = jax.jit(jm.apply)({"params": params}, batch)

    shell = build_model({"model_attributes": {"univl_retrieval": {
        **TINY_MODEL, "token_merge_r": r}}}, device="cpu")
    load_flax_params(shell.module, params)
    out = shell.apply(batch)
    assert set(out) == {"l1_simi", "sim", "text_embed", "visual_embed", "logits"}
    for key in ("text_embed", "visual_embed", "sim"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(out["l1_simi"].numpy(), out["sim"].numpy())
    np.testing.assert_array_equal(out["logits"].numpy(), out["sim"].numpy())


@pytest.fixture(scope="module")
def jax_serving(tmp_path_factory):
    """The JAX BatchPredictor on serving.yml (tiny overrides), its params
    dumped as params.npz, and its answers to a request file."""
    cfg = JConfiguration.from_file(SERVING).override_with_opts(TINY)
    pred = JBatchPredictor(cfg.to_dict()).load(with_ckpt=False)
    tmp = tmp_path_factory.mktemp("serving")
    np.savez(tmp / "params.npz", **flatten_flax(jax.device_get(pred.variables["params"])))
    rng = np.random.default_rng(7)
    reqs = [{"caption": c, "image_data": rng.random((2, 32, 32, 3)).round(4).tolist()}
            for c in CAPTIONS]
    (tmp / "reqs.jsonl").write_text("\n".join(json.dumps(r) for r in reqs))
    (tmp / "req.json").write_text(json.dumps(reqs[0]))
    return dict(dir=tmp, batch=pred.predict_batch(reqs), one=pred.predict(reqs[0]))


def _assert_results_close(port, ref):
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_allclose(np.asarray(port[key]), np.asarray(ref[key]), atol=ATOL,
                                   rtol=0, err_msg=key)


def test_cli_batch_matches_jax_predictor(jax_serving, capsys):
    d = jax_serving["dir"]
    t_cli.main(["--config", SERVING, "--device", "cpu", "--model_dir", str(d),
                "--batch", str(d / "reqs.jsonl"), *TINY])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == len(CAPTIONS)
    for port, ref in zip(lines, jax_serving["batch"]):
        _assert_results_close(port, ref)


def test_cli_input_matches_jax_predictor(jax_serving, capsys):
    d = jax_serving["dir"]
    t_cli.main(["--config", SERVING, "--device", "cpu", "--model_dir", str(d),
                "--input", str(d / "req.json"), *TINY])
    _assert_results_close(json.loads(capsys.readouterr().out), jax_serving["one"])


def test_model_dir_without_params_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="params.npz"):
        t_cli.build_predictor(["--config", SERVING, "--device", "cpu",
                               "--model_dir", str(tmp_path), *TINY])


def test_default_device_predictor_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    cfg = TConfiguration.from_file(SERVING).override_with_opts(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TPredictor(cfg).load(with_ckpt=False)


def test_configuration_overrides_match_jax():
    opts = [*TINY, "model_attributes.univl_retrieval.token_merge_r=0",
            "predictor_parameters.seed", "3", "predictor_parameters.tag", "none"]
    port = TConfiguration.from_file(SERVING).override_with_opts(opts)
    ref = JConfiguration.from_file(SERVING).override_with_opts(opts)
    assert port.to_dict() == ref.to_dict()
    assert port.get_dotted("model_attributes.univl_retrieval.image_size") == 32


def test_tokenization_matches_jax():
    cfg = {"vocab_file": "tests/data/vocabs/bert-base-uncased_30522_vocab.txt",
           "max_seq_length": 30}
    port, ref = TProc(cfg), JProc(cfg)
    for text in CAPTIONS + [" ".join(["word"] * 40), "unaffable ##x [CLS]"]:
        a, b = port({"text": text}, probability=0.0), ref({"text": text}, probability=0.0)
        for key in ("input_ids", "input_mask", "segment_ids"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{text!r} {key}")
    with pytest.raises(NotImplementedError):
        port({"text": "a"})  # masking (default probability 0.15) is not ported
