"""The pretraining data path and trainer in the port against the JAX package,
on the CPU.

* ``MaskedTokenProcessor`` bit for bit against the JAX processor at the same
  seed, over many draws of the fixture captions: plain token masking,
  whole-word masking, significant masking (the stopword heuristic and a
  term list), sentence pairs with ``trim_start_token``, and the Chinese
  vocabulary. The ids and labels of every call are equal, so both
  generators drew alike.
* The first train and val batch of ``video_text_pretrain`` on
  ``univl_pretrain.local.yml`` are equal at atol 0: training captions
  masked, evaluation captions not (labels all -1), raw ids unmasked.
* One JAX ``BaseTrainer`` run on ``univl_pretrain.local.yml`` (seed 1, 4
  steps, ``log_interval`` 1, full validation every 2 steps, the text
  processors seeded) against the port's trainer on the same config on the
  CPU, restarted from the JAX initial parameters written as a flax-path
  ``params.npz``: each logged loss term, ``total_loss`` and
  ``val/total_loss`` at atol 1e-4 (fp32 sums in another order, compounded
  by the updates); each full validation's and the test inference's loss
  terms at atol 1e-4, and the
  best iteration and value that early stopping keeps (``val/total_loss``,
  minimised) equal.
* ``snps3_pretrain.local.yml`` (dual MLM, FOM, significant masking) and
  ``cnvid_pretrain.local.yml`` (the Chinese vocabulary) train through
  ``antmmf_torch.run`` on the CPU with every loss term present and finite.
"""

import json
import os

import jax
import numpy as np
import pytest

from antmmf_torch import run
from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.task_loader import TaskLoader as TTaskLoader
from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor as TProc
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.task_loader import TaskLoader as JTaskLoader
from antmmf_tpu.datasets.processors.text_processors import MaskedTokenProcessor as JProc
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_trainer import jax_saves_skipped, jitted_jax_init
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "univl_pretrain.local.yml")
SNPS3 = os.path.join(REPO, "projects", "snps3_vtp", "configs", "snps3_pretrain.local.yml")
CNVID = os.path.join(REPO, "projects", "cnvid_vtp", "configs", "cnvid_pretrain.local.yml")
TEXT = "task_attributes.univl_task.dataset_attributes.video_text_pretrain.text"
STEPS, LOSS_ATOL = 4, 1e-4
OPTS = ["training_parameters.seed", "1", "training_parameters.max_iterations", str(STEPS),
        "training_parameters.log_interval", "1", "training_parameters.snapshot_interval", "2",
        "training_parameters.num_workers", "0", f"{TEXT}.seed", "5"]
ZH_VOCAB = "tests/data/vocabs/bert-base-chinese_21128_vocab.txt"


def _captions(*names):
    out = []
    for name in names:
        with open(os.path.join(DATA, "video", name), encoding="utf-8") as f:
            out += [json.loads(line)["caption"] for line in f if line.strip()]
    return out


EN = ("msrvtt_train.jsonl", "msrvtt_test.jsonl")
PROCESSOR_CASES = {
    "plain": ({"mask_probability": 0.3, "max_seq_length": 24}, EN),
    "wwm": ({"wwm": True, "mask_probability": 0.5, "max_seq_length": 16}, EN),
    "significant": ({"wwm": True, "significant_masking": True, "mask_probability": 0.3,
                     "max_seq_length": 24}, EN),
    "significant_terms": ({"significant_masking": True, "significant_boost": 3.0,
                           "significant_terms": ["person", "girl", "system", "gymnastics"],
                           "mask_probability": 0.25, "max_seq_length": 24}, EN),
    "pair_trim_start": ({"mask_probability": 0.4, "max_seq_length": 20,
                         "trim_start_token": True}, EN),
    "chinese": ({"vocab_file": ZH_VOCAB, "wwm": True, "mask_probability": 0.3,
                 "max_seq_length": 24}, ("VATEX_CN.jsonl",)),
}


@pytest.mark.parametrize("case", sorted(PROCESSOR_CASES))
def test_masked_processor_bit_for_bit(case):
    """40 passes over the captions from one seed: every call's arrays equal."""
    cfg, files = PROCESSOR_CASES[case]
    cfg = {**cfg, "seed": 11}
    t, j = TProc(cfg), JProc(cfg)
    captions = _captions(*files)
    masked = 0
    for rep in range(40):
        for i, caption in enumerate(captions):
            item = {"text": caption}
            if case.startswith("pair"):
                item["text_b"] = captions[(i + rep + 1) % len(captions)]
            got, ref = t(item), j(item)
            for key in ("input_ids", "input_mask", "segment_ids", "lm_label_ids"):
                assert got[key].dtype == ref[key].dtype == np.int64
                np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{case}: {key}")
            masked += int((got["lm_label_ids"] != -1).sum())
            # probability 0 draws nothing and masks nothing
            raw = t(item, probability=0.0)
            assert (raw["lm_label_ids"] == -1).all()
            np.testing.assert_array_equal(raw["input_ids"], j(item, probability=0.0)["input_ids"])
    assert masked > 0
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def _first_batch(loader_cls, config, dataset_type):
    loader = loader_cls(config)
    loader.load_task([dataset_type])
    loader.make_dataloaders()
    loader.seed_sampler(dataset_type, 0)
    return next(iter(loader.get_loaders(dataset_type)[0]))


@pytest.mark.parametrize("dataset_type", ["train", "val"])
def test_first_pretrain_batch_matches_jax(dataset_type):
    opts = ["training_parameters.num_workers", "0", f"{TEXT}.seed", "5"]
    j = _first_batch(JTaskLoader, j_build_config(CFG, opts=opts), dataset_type)
    t = _first_batch(TTaskLoader, t_build_config(CFG, opts=opts), dataset_type)
    assert sorted(t.arrays()) == sorted(j.arrays())
    for key, ref in j.arrays().items():
        assert t[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(t[key], ref, err_msg=key)
    labels, ids, raw = t["caption_lm_label_ids"], t["caption_input_ids"], \
        t["caption_raw_input_ids"]
    if dataset_type == "train":  # masked: targets hold the raw ids
        assert (labels != -1).any() and (ids != raw).any()
        np.testing.assert_array_equal(labels[labels != -1], raw[labels != -1])
    else:
        assert (labels == -1).all() and (ids == raw).all()


def _record_validations(trainer):
    results, real = [], trainer.evaluate_set

    def evaluate_set(dataset_type="val"):
        results.append((dataset_type, real(dataset_type)))
        return results[-1][1]

    trainer.evaluate_set = evaluate_set
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    jt = j_build_trainer(j_build_config(CFG, opts=OPTS + ["training_parameters.save_dir", jdir]))
    with jitted_jax_init():
        jt.load()
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    j_vals = _record_validations(jt)
    with jax_saves_skipped():
        jt.train()
    tt = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", tdir, "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", npz]))
    tt.load()
    t_vals = _record_validations(tt)
    tt.train()
    return dict(jax=jt, port=tt, j_vals=j_vals, t_vals=t_vals)


TERMS = ("losses/vtc_loss", "losses/itm_loss", "losses/masked_lm_loss", "total_loss")


@pytest.mark.parametrize("key", [f"{split}/{term}" for split in ("train", "val")
                                 for term in TERMS])
def test_trainer_losses_match_jax_step_for_step(runs, key):
    port, ref = (list(runs[n].meter.meters[key].deque) for n in ("port", "jax"))
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, atol=LOSS_ATOL, rtol=0)


def test_full_validations_and_best_match_jax(runs):
    """Full validations at steps 2 and 4, the final one and the test
    inference (its split falls back to the train annotations): the loss terms
    within LOSS_ATOL; evaluation captions carry no MLM target, so
    ``masked_lm_loss`` is 0 there; ``best`` follows ``val/total_loss``
    minimised, at the same iteration with the same value."""
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals] == ["val"] * 3 + ["test"]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert sorted(t) == sorted(j)
        for key in j:
            assert abs(t[key] - j[key]) <= LOSS_ATOL, key
        assert t["losses/masked_lm_loss"] == 0.0
    je, te = runs["jax"].early_stopping, runs["port"].early_stopping
    assert te.monitored_metric == je.monitored_metric == "val/total_loss"
    assert te.minimize and je.minimize
    assert te.best_iteration == je.best_iteration
    assert abs(te.best_value - je.best_value) <= LOSS_ATOL
    assert runs["port"].state.step == STEPS


@pytest.mark.parametrize("config,terms", [
    (SNPS3, ("vtc_loss", "itm_loss", "masked_lm_loss", "text_masked_lm_loss", "fom_loss")),
    (CNVID, ("vtc_loss", "itm_loss", "masked_lm_loss")),
], ids=["snps3", "cnvid"])
def test_pretrain_configs_run_through_the_cli(tmp_path, config, terms):
    trainer = run.main(["--config", config, "training_parameters.device", "cpu",
                        "training_parameters.save_dir", str(tmp_path),
                        "training_parameters.max_iterations", "2",
                        "training_parameters.log_interval", "1",
                        "training_parameters.snapshot_interval", "2",
                        "training_parameters.seed", "2"])
    assert trainer.state.step == 2
    meters = trainer.meter.meters
    for term in terms:
        values = list(meters[f"train/losses/{term}"].deque)
        assert len(values) == 2 and np.isfinite(values).all(), term
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "model_2"]
    assert (tmp_path / "univl_pretrain_final").exists()


def test_final_snapshot_names_the_last_step(tmp_path):
    """Three steps over epochs of two batches: the run stops inside the
    second epoch, and the final snapshot is ``model_3`` holding step 3 (the
    JAX loop counts the batch it drops and writes ``model_4``)."""
    trainer = run.main(["--config", CFG, "training_parameters.device", "cpu",
                        "training_parameters.save_dir", str(tmp_path),
                        "training_parameters.batch_size", "2",
                        "training_parameters.max_iterations", "3",
                        "training_parameters.snapshot_interval", "100",
                        "training_parameters.seed", "2"])
    assert trainer.state.step == 3 and len(trainer.timings["step_s"]) == 3
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "model_3"]
