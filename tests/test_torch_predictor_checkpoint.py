"""Serving a model that ``antmmf_torch.run`` saved, on the CPU.

``build_predictor --model_dir <save_dir>`` reads a trainer's ``save_dir`` in
the JAX predictor's order (``*_final``, then ``models/best``, then the
newest ``models/model_<n>`` by number, ``model_1000`` after ``model_999``),
with a ``params.npz`` as the fallback. Two runs of the port's trainer, two
iterations each: ``video_retrieval.local.yml`` (UniVL retrieval, served by
``base_predictor``) and the composed ``pink_7b.yml`` recipe at the tiny
presets (the EVA tower, remat, the ``scan_layers`` layout; served by
``generation_predictor``). Each predictor on the ``save_dir`` is held at
atol 0 (the same outputs, the same tokens) against one given a
``params.npz`` exported from the same masters (stacked for the Pink model,
as JAX writes it) beside the run's ``config.yaml``.
"""

import os
import shutil

import numpy as np
import pytest

from antmmf_torch import run
from antmmf_torch.common.checkpoint import find_weights
from antmmf_torch.models.pink import recipe_opts
from antmmf_torch.predictors import cli as t_cli
from antmmf_torch.utils.weights import export_flax_variables, flatten_flax
from test_torch_task_trainer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETRIEVAL = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
PINK = os.path.join(REPO, "projects", "pink", "configs", "pink_instruct.local.yml")
DATA = "task_attributes.pink_task.dataset_attributes.pink_instruct"
PINK_OPTS = recipe_opts(lm_preset="omni_tiny_test", eva_preset="eva_tiny_test", image_size=28,
                        dtype_str="float32") + [f"{DATA}.image.size", "28",
                                                f"{DATA}.image.resize", "32"]
GENERATION = ["--predictor", "generation_predictor", "predictor_parameters.max_new_tokens", "5",
              "predictor_parameters.max_prompt_len", "24"]


def _train(save_dir, config, *extra):
    trainer = run.main(["--config", config, "training_parameters.save_dir", str(save_dir),
                        "training_parameters.device", "cpu", "training_parameters.max_iterations",
                        "2", "training_parameters.snapshot_interval", "1",
                        "training_parameters.run_type", "train", *extra])
    assert trainer.state.step == 2
    return trainer


def _exported(trainer, save_dir, root):
    """A ``params.npz`` of the trainer's masters beside the run's config."""
    npz_dir = root / "npz"
    npz_dir.mkdir()
    shutil.copy(save_dir / "config.yaml", npz_dir / "config.yaml")
    params = export_flax_variables(trainer.shell.module, trainer.state)["params"]
    np.savez(npz_dir / "params.npz", **flatten_flax(params))
    return npz_dir


def _predictor(config, model_dir, *extra):
    return t_cli.build_predictor(["--config", config, "--device", "cpu", "--model_dir",
                                  str(model_dir), *extra])[0]


def test_retrieval_save_dir_serves_like_its_params_npz(tmp_path):
    save_dir = tmp_path / "save"
    trainer = _train(save_dir, RETRIEVAL)
    assert find_weights(str(save_dir)).endswith("univl_retrieval_final")
    npz_dir = _exported(trainer, save_dir, tmp_path)
    rng = np.random.default_rng(0)
    request = {"image_data": rng.random((2, 64, 64, 3), dtype=np.float32),
               "caption": "a man is driving a car"}
    got = _predictor(RETRIEVAL, save_dir).predict(request)
    want = _predictor(RETRIEVAL, npz_dir).predict(request)
    assert sorted(got) == sorted(want) and got
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    untrained = _predictor(RETRIEVAL, save_dir, "--no_ckpt").predict(request)
    assert not np.array_equal(np.asarray(untrained["sim"]), np.asarray(want["sim"]))


def test_pink_save_dir_generates_like_its_params_npz(tmp_path):
    save_dir = tmp_path / "save"
    trainer = _train(save_dir, PINK, *PINK_OPTS)
    assert find_weights(str(save_dir)).endswith("pink_final")
    npz_dir = _exported(trainer, save_dir, tmp_path)
    with np.load(npz_dir / "params.npz") as npz:  # the layout a scan_layers JAX model writes
        assert any(k.startswith("decoder/layers/") for k in npz.files)
        assert not any(k.startswith("decoder/layer_") for k in npz.files)
    image = np.random.default_rng(1).random((40, 36, 3)).round(4)
    request = {"text": "what is in the picture?", "image": image.tolist()}
    got = _predictor(PINK, save_dir, *GENERATION).predict(request)
    want = _predictor(PINK, npz_dir, *GENERATION).predict(request)
    np.testing.assert_array_equal(got["generated_ids"], want["generated_ids"])
    assert got["generated_text"] == want["generated_text"]
    assert got["generated_ids"].shape == (1, 24 + 5)


@pytest.mark.parametrize("files,want", [
    (["pink_final", "models/best", "models/model_999", "models/model_1000"], "pink_final"),
    (["models/best", "models/model_999", "models/model_1000", "params.npz"], "models/best"),
    (["models/model_999", "models/model_1000", "models/model_2", "params.npz"],
     "models/model_1000"),
    (["params.npz"], "params.npz"),
])
def test_the_lookup_order_is_the_jax_predictor_s(tmp_path, files, want):
    for name in files:
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    assert find_weights(str(tmp_path)) == str(tmp_path / want)


def test_a_model_dir_without_weights_raises(tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "model_x").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="params.npz"):
        find_weights(str(tmp_path))
