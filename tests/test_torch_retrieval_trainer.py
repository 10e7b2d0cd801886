"""The port's retrieval trainer and head-only training against the JAX
package, and the quality anchor's analog, on the CPU.

* Stage 2: ``video_retrieval.local.yml`` with the cross-encoder,
  ``trainer retrieval_trainer``, ``stage2_topk`` 1 and ``stage2_chunk`` 3
  (4 captions over 2 videos: 4 pairs, so the last chunk holds one). Both
  trainers evaluate the val set at the JAX trainer's initial parameters
  (the port restarted from them): the same candidates, their cross-encoder
  scores at atol 1e-4, every non-candidate at −1e30 in both, and the L1 and
  L2 recalls equal.
* ``training_head_only`` (``m2_raap/configs/adaptation.yml``'s stage 1) on
  ``video_retrieval.local.yml`` for two steps from the same parameters:
  the towers get no gradient (their biases and norms, which take no weight
  decay, end bit for bit where they started), AdamW's decoupled weight
  decay still moves their kernels in both packages, and the port's tower
  weights equal JAX's at atol 1e-6, ``logit_scale`` at 1e-5.
  ``restart: true`` with ``resume_file: null`` is accepted and loads nothing.
* The analog of ``tests/test_quality_anchor.py``: its seeded 64-clip
  corpus (gratings with a binary block id, 2 frames at 32², captions of two
  unique ids), built here the same way; the port's tiny ``univl_retrieval``
  starts from the JAX model's initial parameters (``PRNGKey(0)``), trains
  200 steps at B=16 (AdamW lr 2e-3, weight decay 0.01 on every parameter,
  as ``optax.adamw``) through ``TrainState``/``make_train_step``, and must
  clear the JAX test's bands on the whole corpus: R@1 ≥ 70, R@5 ≥ 90,
  median rank ≤ 2, with the loss of the last 10 steps below half that of
  the first 10.
* Two reference defects that the port keeps for parity (ROADMAP C): stage
  2's all-ones visual mask, and the rank of a ground truth tied with the
  −1e30 non-candidates, which ``np.argsort``'s order decides.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.models.base_model import build_model as t_build
from antmmf_torch.modules.metrics.evaluators import _ranks_with_multi_gt as t_ranks
from antmmf_torch.optimizer.build import NO_DECAY_PATTERNS, AdamW
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.trainers.retrieval_trainer import RetrievalTrainer as TRetrieval
from antmmf_torch.trainers.train_state import TrainState, make_train_step
from antmmf_torch.utils.weights import export_flax_variables, flatten_flax, load_flax_params
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.models.base_model import build_model as j_build
from antmmf_tpu.modules.metrics.evaluators import _ranks_with_multi_gt as j_ranks
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from antmmf_tpu.trainers.retrieval_trainer import RetrievalTrainer as JRetrieval
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
SCORE_ATOL, TOWER_ATOL, HEAD_ATOL = 1e-4, 1e-6, 1e-5
STAGE2 = ["training_parameters.trainer", "retrieval_trainer",
          "model_attributes.univl_retrieval.with_cross_encoder", "true",
          "training_parameters.stage2_topk", "1", "training_parameters.stage2_chunk", "3",
          "training_parameters.seed", "1"]
HEAD_ONLY = ["model_attributes.univl_retrieval.training_head_only", "true",
             "training_parameters.max_iterations", "2", "training_parameters.seed", "1",
             "training_parameters.run_type", "train", "training_parameters.snapshot_interval",
             "100"]

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several test
    processes side by side, whose thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_trainer(opts, save_dir):
    jt = j_build_trainer(j_build_config(CFG, opts=opts + ["training_parameters.save_dir",
                                                          save_dir]))
    with jitted_jax_init():
        jt.load()
    npz = os.path.join(save_dir, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    return jt, npz


def _port_trainer(opts, save_dir, npz):
    tt = t_build_trainer(t_build_config(CFG, opts=opts + [
        "training_parameters.save_dir", save_dir, "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", npz]))
    tt.load()
    return tt


def _capture_scores(trainer):
    scores = []
    real = trainer._stage2_rescore

    def rescore(*args):
        scores.append(real(*args))
        return scores[-1]

    trainer._stage2_rescore = rescore
    return scores


# ------------------------------------------------------------------- stage 2
@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_s2", "port_s2"))
    jt, npz = _jax_trainer(STAGE2, jdir)
    j_scores = _capture_scores(jt)
    j_metrics = jt.evaluate_set("val")
    tt = _port_trainer(STAGE2, tdir, npz)
    t_scores = _capture_scores(tt)
    t_metrics = tt.evaluate_set("val")
    return dict(j=(j_metrics, j_scores[0]), t=(t_metrics, t_scores[0]))


def test_stage2_candidates_and_scores_match_jax(stage2):
    (_, j), (_, t) = stage2["j"], stage2["t"]
    assert t.shape == j.shape == (4, 2)
    cand_t, cand_j = t > -1e29, j > -1e29
    assert np.array_equal(cand_t, cand_j) and cand_t.sum() == 4
    assert (t[~cand_t] == -1e30).all() and (j[~cand_j] == -1e30).all()
    np.testing.assert_allclose(t[cand_t], j[cand_j], atol=SCORE_ATOL, rtol=0)


def test_stage2_recalls_match_jax(stage2):
    (jm, _), (tm, _) = stage2["j"], stage2["t"]
    keys = [k for k in jm if k.startswith(("l1_", "l2_")) or k == "mean_recall"]
    assert any(k.startswith("l2_simi_t2v") for k in keys)
    assert sorted(tm) == sorted(jm)
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}


def _stage2_masks(trainer_cls, as_array):
    """The visual masks that ``_stage2_rescore`` hands the cross-encoder, for
    3 texts against 2 videos of 2 frames × 3 tokens, top 2, chunks of 4."""
    rng = np.random.default_rng(4)
    trainer = trainer_cls.__new__(trainer_cls)
    trainer.tp, trainer.state, masks = {"stage2_chunk": 4}, None, []

    def rescore(state, tseq, tmask, vseq, vmask):
        masks.append(np.asarray(vmask))
        return as_array(np.zeros(len(vmask), np.float32))

    trainer._rescore_step = rescore
    tseq, tmask = rng.normal(size=(3, 5, 4)).astype(np.float32), np.ones((3, 5), np.int64)
    vis = rng.normal(size=(2, 2, 3, 4)).astype(np.float32)
    l1 = rng.normal(size=(3, 2)).astype(np.float32)
    if trainer_cls is TRetrieval:
        tseq, tmask, vis = (torch.from_numpy(x) for x in (tseq, tmask, vis))
    trainer._stage2_rescore(tseq, tmask, vis, l1, 2)
    return masks


def test_stage2_visual_mask_is_all_ones_in_both():
    """A reference defect kept for parity (ROADMAP C): stage 2 attends every
    frame token, whatever ``video_mask`` says."""
    port = _stage2_masks(TRetrieval, torch.from_numpy)
    ref = _stage2_masks(JRetrieval, jnp.asarray)
    assert [m.shape for m in port] == [(4, 6), (2, 6)]  # 6 pairs: a chunk of 4, then 2
    assert all((m == 1).all() for m in port)
    assert all((m == 1).all() for m in ref) and ref[0].shape == (4, 6)


def test_tied_non_candidates_rank_by_argsort_order():
    """A reference defect kept for parity (ROADMAP C): a ground truth tied at
    −1e30 with the other non-candidates ranks where ``np.argsort`` puts it
    among them; both packages give the same ranks."""
    rng = np.random.default_rng(9)
    scores = np.full((16, 16), -1e30, np.float32)
    for i in range(16):  # top 2 candidates a text, its own video among them in half the rows
        cols = [i, (i + 1) % 16] if i % 2 else [(i + 1) % 16, (i + 2) % 16]
        scores[i, cols] = rng.normal(size=2)
    gt = [[i] for i in range(16)]
    port, ref = t_ranks(scores, gt), j_ranks(scores, gt)
    assert np.array_equal(port, ref)
    missed = ref[0::2]  # own video not a candidate: anywhere from 2 to 15
    assert (missed >= 2).all() and (missed <= 15).all() and len(set(missed.tolist())) > 1


# ----------------------------------------------------------------- head only
@pytest.fixture(scope="module")
def head_only(tmp_path_factory):
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_head", "port_head"))
    jt, npz = _jax_trainer(HEAD_ONLY, jdir)
    init = flatten_flax(jax.device_get(jt.state.variables["params"]))
    with jax_saves_skipped():
        jt.train()
    tt = _port_trainer(HEAD_ONLY, tdir, npz)
    tt.train()
    return dict(init=init, j=flatten_flax(jax.device_get(jt.state.variables["params"])),
                t=flatten_flax(export_flax_variables(tt.shell.module, tt.state)["params"]),
                steps=tt.state.step)


def test_head_only_towers_match_jax(head_only):
    assert head_only["steps"] == 2
    j, t, init = head_only["j"], head_only["t"], head_only["init"]
    assert sorted(t) == sorted(j)
    towers = [p for p in j if p.startswith("base/")]
    for path in towers:
        np.testing.assert_allclose(t[path], j[path], atol=TOWER_ATOL, rtol=0, err_msg=path)
        if any(re.fullmatch(pat, path.lower()) for pat in NO_DECAY_PATTERNS):
            assert np.array_equal(t[path], init[path]), path  # no gradient, no decay
    moved = [p for p in towers if p.endswith("kernel") and not np.array_equal(t[p], init[p])]
    assert moved and all(not np.array_equal(j[p], init[p]) for p in moved)
    np.testing.assert_allclose(t["logit_scale"], j["logit_scale"], atol=HEAD_ATOL, rtol=0)
    assert t["logit_scale"] != init["logit_scale"]


def test_restart_without_a_resume_file_is_accepted(tmp_path):
    tt = t_build_trainer(t_build_config(CFG, opts=HEAD_ONLY + [
        "training_parameters.save_dir", str(tmp_path), "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", "null"]))
    tt.load()
    assert tt.resume_info == {"mode": "none"} and tt.state.step == 0


# ------------------------------------------------------------ quality anchor
N_CLIPS, FRAMES, SIZE, TEXT_LEN, BATCH, STEPS = 64, 2, 32, 8, 16, 200


def _corpus():
    """``tests/test_quality_anchor.py``'s corpus: clip i a grating of its own
    frequency and phase, its id as a 3×3 block code in channel 2; caption i
    [CLS] w_2i w_2i+1 [SEP]."""
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    videos = np.zeros((N_CLIPS, FRAMES, SIZE, SIZE, 3), np.float32)
    for i in range(N_CLIPS):
        theta, freq = 2 * np.pi * i / N_CLIPS, 2.0 + (i % 8)
        base = np.sin(2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy))
        code = np.zeros((SIZE, SIZE), np.float32)
        for b in range(9):
            r0, c0 = (b // 3) * 10, (b % 3) * 10
            code[r0:r0 + 10, c0:c0 + 10] = 1.0 if (i >> b) & 1 else -1.0
        for f in range(FRAMES):
            videos[i, f, :, :, 0] = base
            videos[i, f, :, :, 1] = np.cos(2 * np.pi * freq * (xx - yy) + 0.5 * f)
            videos[i, f, :, :, 2] = code
    videos += rng.normal(0, 0.02, videos.shape).astype(np.float32)
    ids = np.zeros((N_CLIPS, TEXT_LEN), np.int64)
    ids[:, 0], ids[:, 3] = 101, 102
    ids[:, 1] = 2000 + 2 * np.arange(N_CLIPS)
    ids[:, 2] = 2001 + 2 * np.arange(N_CLIPS)
    return videos, ids, (ids > 0).astype(np.int64)


def _batch(corpus, idx):
    videos, ids, mask = corpus
    return {"image_data": videos[idx], "video_mask": np.ones((len(idx), FRAMES), np.int64),
            "caption_input_ids": ids[idx], "caption_input_mask": mask[idx],
            "caption_segment_ids": np.zeros((len(idx), TEXT_LEN), np.int64)}


@pytest.fixture(scope="module")
def anchor():
    config = {"model_attributes": {"univl_retrieval": {
        "vit_preset": "vit_tiny_test", "bert_preset": "bert_tiny_test", "image_size": SIZE,
        "embed_dim": 32, "dtype_str": "float32"}}}
    corpus = _corpus()
    params = jax.jit(j_build(config).init)(jax.random.PRNGKey(0),
                                           _batch(corpus, np.arange(2)))["params"]
    shell = t_build(config, device="cpu")
    load_flax_params(shell.module, jax.device_get(params))
    names = [n for n, _ in shell.module.named_parameters()]
    tx = AdamW(lambda count: 2e-3, weight_decay=0.01, decay_mask=dict.fromkeys(names, True))
    state, step = TrainState.create(shell.module, tx), make_train_step(shell, tx)
    order = np.random.default_rng(7)
    losses = []
    for _ in range(STEPS):
        state, scalars = step(state, _batch(corpus, order.choice(N_CLIPS, BATCH, replace=False)))
        losses.append(float(scalars["total_loss"]))
    with torch.inference_mode():
        out = shell.module.encode(shell.to_device(_batch(corpus, np.arange(N_CLIPS))))
    t, v = (out[k].float().numpy() for k in ("text_embed", "visual_embed"))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pos = ((-(t @ v.T)).argsort(axis=1) == np.arange(N_CLIPS)[:, None]).argmax(axis=1)
    return losses, {"r1": float((pos == 0).mean() * 100), "r5": float((pos < 5).mean() * 100),
                    "median_rank": float(np.median(pos) + 1)}


def test_anchor_loss_converges(anchor):
    losses, _ = anchor
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10]), (losses[:10], losses[-10:])


def test_anchor_retrieval_quality_band(anchor):
    _, rec = anchor
    assert rec["r1"] >= 70.0, rec
    assert rec["r5"] >= 90.0, rec
    assert rec["median_rank"] <= 2.0, rec
