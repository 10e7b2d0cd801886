"""The port's data layer and retrieval metrics against the JAX package, on
the CPU.

* The task loaders of ``video_retrieval.local.yml`` give equal arrays for
  the first train and val batch (atol 0): the same samples in the same
  order, the same random frame indices from the same seed, the same decode,
  resize and tokenisation.
* ``random_sampler``'s order equals the JAX sampler's for seeds 0-2 and
  epochs 0-2; ``pad_last`` and ``drop_last`` cut batches alike.
* An LMDB written by the port's ``LmdbLiteWriter`` reads back the same
  through the JAX ``LmdbVideoDatabase``, and the other way round, with the
  same sampled frames.
* ``GlobalRetrievalRecallEvaluator`` and ``mm_retrieval_recall`` on seeded
  embeddings with repeated video ids (rows repeated as ``pad_last`` repeats
  them): results within 1e-6.
* Config assembly: the priority defaults < yaml < override file < command
  line, and a frozen result.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.task_loader import TaskLoader as TTaskLoader
from antmmf_torch.datasets.database.video_database import LmdbVideoDatabase as TLmdbDB
from antmmf_torch.datasets.loader import DataLoader as TDataLoader
from antmmf_torch.datasets.samplers import RandomSampler as TRandomSampler
from antmmf_torch.modules.metrics.evaluators import \
    GlobalRetrievalRecallEvaluator as TEvaluator
from antmmf_torch.modules.metrics.metrics import Metrics as TMetrics
from antmmf_torch.trainers.build import build_trainer as _registers_port  # noqa: F401
from antmmf_torch.utils.lmdb_lite import LmdbLiteWriter as TWriter
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.task_loader import TaskLoader as JTaskLoader
from antmmf_tpu.datasets.database.video_database import LmdbVideoDatabase as JLmdbDB
from antmmf_tpu.datasets.loader import DataLoader as JDataLoader
from antmmf_tpu.datasets.samplers import RandomSampler as JRandomSampler
from antmmf_tpu.modules.metrics.evaluators import \
    GlobalRetrievalRecallEvaluator as JEvaluator
from antmmf_tpu.modules.metrics.metrics import Metrics as JMetrics
from antmmf_tpu.trainers.build import build_trainer as _registers_jax  # noqa: F401
from antmmf_tpu.utils.lmdb_lite import LmdbLiteWriter as JWriter
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
METRIC_ATOL = 1e-6


def _first_batch(loader_cls, config, dataset_type):
    loader = loader_cls(config)
    loader.load_task([dataset_type])
    loader.make_dataloaders()
    loader.seed_sampler(dataset_type, 0)
    return next(iter(loader.get_loaders(dataset_type)[0]))


@pytest.mark.parametrize("dataset_type", ["train", "val"])
def test_first_batch_matches_jax(dataset_type):
    opts = ["training_parameters.num_workers", "0"]
    j = _first_batch(JTaskLoader, j_build_config(CFG, opts=opts), dataset_type)
    t = _first_batch(TTaskLoader, t_build_config(CFG, opts=opts), dataset_type)
    assert sorted(t.arrays()) == sorted(j.arrays())
    for key, ref in j.arrays().items():
        assert t[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(t[key], ref, err_msg=key)
    assert (t.metadata["caption_text"], t.metadata["dataset_type"]) == \
        (j.metadata["caption_text"], j.metadata["dataset_type"])
    assert (t["caption_lm_label_ids"] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sampler_order_matches_jax(seed):
    data = list(range(37))
    ts, js = TRandomSampler(data, seed=seed), JRandomSampler(data, seed=seed)
    for epoch in range(3):
        ts.set_epoch(epoch)
        js.set_epoch(epoch)
        assert list(ts) == list(js)


@pytest.mark.parametrize("drop_last,pad_last", [(True, False), (False, True), (False, False)])
def test_loader_cuts_batches_as_jax(drop_last, pad_last):
    data = [{"x": np.array([i])} for i in range(10)]
    collate = lambda samples: np.concatenate([s["x"] for s in samples])  # noqa: E731
    got = [list(b) for b in TDataLoader(data, 4, collate_fn=collate, num_workers=2,
                                        drop_last=drop_last, pad_last=pad_last)]
    ref = [list(b) for b in JDataLoader(data, 4, collate_fn=collate, num_workers=2,
                                        drop_last=drop_last, pad_last=pad_last)]
    assert got == ref


def _clips(seed):
    rng = np.random.default_rng(seed)
    return {f"video{i}": rng.integers(0, 256, (5 + i, 6, 8, 3), dtype=np.uint8)
            for i in range(3)}


@pytest.mark.parametrize("writer,reader", [(TWriter, JLmdbDB), (JWriter, TLmdbDB)],
                         ids=["port_writes", "jax_writes"])
def test_lmdb_clips_cross_read(tmp_path, writer, reader):
    clips = _clips(3)
    w = writer(str(tmp_path / "clips.lmdb") + os.sep)
    for name, frames in clips.items():
        buf = io.BytesIO()
        np.save(buf, frames)
        w.put(name, buf.getvalue())
    w.save()
    other = JLmdbDB if reader is TLmdbDB else TLmdbDB
    db, twin = reader(str(tmp_path / "clips.lmdb"), seed=5), other(str(tmp_path / "clips.lmdb"),
                                                                  seed=5)
    for name, frames in clips.items():
        for training in (False, True):
            got = db.get(name + ".mp4", n_clips=2, frames_per_clip=2, is_training=training)
            ref = twin.get(name + ".mp4", n_clips=2, frames_per_clip=2, is_training=training)
            np.testing.assert_array_equal(got, ref)
            assert np.isin(got.reshape(-1, 6, 8, 3)[:, None], frames[None]).all()


def _retrieval_batches(seed):
    """Three eval batches over 7 videos with repeated ids; the last batch
    wraps its first rows, as ``pad_last`` does."""
    rng = np.random.default_rng(seed)
    vids = np.array([0, 0, 1, 2, 2, 2, 3, 4, 5, 6, 6, 0])
    vids = np.concatenate([vids, vids[:4]])
    text = rng.standard_normal((len(vids), 16)).astype(np.float32)
    video = rng.standard_normal((7, 16)).astype(np.float32)[vids]
    return [({"image_vid": vids[i:i + 4]},
             {"text_embed": text[i:i + 4], "visual_embed": video[i:i + 4]})
            for i in range(0, len(vids), 4)]


@pytest.mark.parametrize("seed", [0, 1])
def test_global_retrieval_recall_matches_jax(seed):
    t, j = TEvaluator(), JEvaluator()
    for batch, output in _retrieval_batches(seed):
        t.collect(batch, output)
        j.collect(batch, output)
    got, ref = t.summarize(), j.summarize()
    assert sorted(got) == sorted(ref) and "mean_recall" in got
    for k in ref:
        assert abs(got[k] - ref[k]) <= METRIC_ATOL, k


@pytest.mark.parametrize("topk", [1, 5, 10, "median-rank"])
def test_mm_retrieval_recall_matches_jax(topk):
    rng = np.random.default_rng(7)
    sim = rng.standard_normal((12, 12)).astype(np.float32)
    sim[3, 5] = sim[3, 3]  # a tie with the positive
    cfg = [{"type": "mm_retrieval_recall", "name": "m", "params": {"topk": topk}}]
    got = TMetrics(cfg)({}, {"sim": torch.from_numpy(sim)})["m"]
    ref = JMetrics(cfg)({}, {"sim": jnp.asarray(sim)})["m"]
    assert abs(float(got) - float(ref)) <= METRIC_ATOL


def test_config_priority_and_freeze(tmp_path):
    override = tmp_path / "override.yml"
    override.write_text("training_parameters:\n  batch_size: 8\n  log_interval: 3\n")
    cfg = t_build_config(CFG, str(override), ["training_parameters.log_interval", "5"])
    tp = cfg["training_parameters"]
    assert (tp["batch_size"], tp["log_interval"], tp["snapshot_interval"], tp["patience"]) == \
        (8, 5, 4, 30000)  # override, command line, yaml, defaults
    assert cfg.frozen and tp.frozen
    with pytest.raises(AttributeError):
        cfg.set_dotted("training_parameters.seed", 3)
    with pytest.raises(AttributeError):
        tp["seed"] = 3
    ref = j_build_config(CFG, str(override), ["training_parameters.log_interval", "5"])
    assert cfg.to_dict() | {"config_path": None} == ref.to_dict() | {"config_path": None}
