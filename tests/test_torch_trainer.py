"""The port's training framework against the JAX trainer, on the CPU.

One JAX ``BaseTrainer`` run on ``video_retrieval.local.yml`` (seed 1, 6
steps, ``log_interval`` 1, ``snapshot_interval`` 4, the fixture's
{data: 4, model: 2} mesh over 8 CPU devices) is shared by the module. The
port's trainer runs the same config on the CPU, restarted (``restart``,
``resume_file``) from the JAX trainer's initial parameters written as a
flax-path ``params.npz``, so the tolerant load runs too. Both read the same
fixture videos with the same random frames, batch by batch.

Tolerances: each step's ``train/total_loss`` and ``val/total_loss`` at
atol 1e-4 (fp32 sums in another order, compounded over the updates);
``grad_norm`` at rtol 1e-3; the learning rate exactly (the same fp32
schedule); the full validation's recalls exactly (ranks of 4 captions over
2 videos). Resuming from ``model_4`` restores the step, the masters, the
AdamW moments and the generator bit for bit.
"""

import contextlib
import functools
import os

import jax
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.checkpoint import Checkpoint
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.checkpoint import Checkpoint as JCheckpoint, merge_params_tolerant
from antmmf_tpu.models.base_model import ModelShell as JModelShell
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several test
    processes side by side, whose thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def jitted_jax_init():
    """The JAX trainer's model init (``ModelShell.init``) under ``jax.jit``:
    the same initialisers, keys and example batch compiled once, where the
    eager init compiles several hundred small operations one by one (the
    parameters agree with the eager ones to a few fp32 ulps)."""
    real = JModelShell.init

    def init(self, rng, example_batch):
        return jax.jit(functools.partial(real, self))(rng, example_batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModelShell, "init", init)
        yield


@contextlib.contextmanager
def jax_saves_skipped():
    """The JAX trainer's Orbax snapshots (``model_<n>``, ``best``,
    ``<model>_final``) left unwritten: no port test reads them (the port
    restarts from the ``params.npz`` each fixture writes), and they cost
    seconds of CPU a fixture."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("save", "save_final_weights", "finalize_writes"):
            mp.setattr(JCheckpoint, name, lambda self, *args, **kw: None)
        yield

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
STEPS, LOSS_ATOL, GRAD_NORM_RTOL = 6, 1e-4, 1e-3
OPTS = ["training_parameters.seed", "1", "training_parameters.max_iterations", str(STEPS),
        "training_parameters.log_interval", "1", "training_parameters.snapshot_interval", "4"]
RECALLS = ("t2v-r@1", "t2v-r@5", "t2v-r@10", "t2v-median_rank", "v2t-r@1", "v2t-r@5",
           "v2t-median_rank", "mean_recall")


def _record_validations(trainer):
    """Keep every evaluate_set result (the full validations at step 4 and at
    the end, then the test inference)."""
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
    init = flatten_flax(jax.device_get(jt.state.variables["params"]))
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **init)
    j_vals = _record_validations(jt)
    with jax_saves_skipped():
        jt.train()

    tt = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", tdir, "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", npz]))
    tt.load()
    saved = {}
    real_save = tt.checkpoint.save

    def save(state, iteration=None, tag=None):
        if iteration == 4:
            saved["state"] = (state.step, {n: t.clone() for n, t in state.params.items()},
                              {k: {n: t.clone() for n, t in state.opt_state[k].items()}
                               for k in ("mu", "nu")}, state.opt_state["count"],
                              state.generator.get_state())
        return real_save(state, iteration, tag)

    tt.checkpoint.save = save
    t_vals = _record_validations(tt)
    tt.train()
    return dict(jax=jt, port=tt, j_vals=j_vals, t_vals=t_vals, init=init, npz=npz,
                saved=saved["state"], port_dir=tdir)


def _series(trainer, key):
    return list(trainer.meter.meters[key].deque)


def test_restart_loads_every_jax_leaf(runs):
    """The restart carried every flax leaf: the tolerant load found no
    missing, mismatched or unexpected path."""
    assert runs["port"].resume_info == {"mode": "restart", "loaded": len(runs["init"]),
                                        "missing": 0, "shape_mismatch": 0, "unexpected": 0}


@pytest.mark.parametrize("key,atol", [("train/total_loss", LOSS_ATOL),
                                      ("val/total_loss", LOSS_ATOL)])
def test_step_losses_match_jax(runs, key, atol):
    np.testing.assert_allclose(_series(runs["port"], key), _series(runs["jax"], key),
                               atol=atol, rtol=0)


def test_grad_norm_matches_jax(runs):
    np.testing.assert_allclose(_series(runs["port"], "train/grad_norm"),
                               _series(runs["jax"], "train/grad_norm"), rtol=GRAD_NORM_RTOL)


def test_lr_matches_jax_exactly(runs):
    assert _series(runs["port"], "lr") == _series(runs["jax"], "lr")


def test_batch_metrics_match_jax(runs):
    for key in ("train/metrics/r@1", "train/metrics/r@5", "val/metrics/r@1"):
        assert _series(runs["port"], key) == _series(runs["jax"], key), key


def test_full_validations_match_jax(runs):
    """The recalls at step 4, at the end and of the test inference exactly;
    the validation loss within LOSS_ATOL."""
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals] == ["val", "val", "test"]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert {k: t[k] for k in RECALLS} == {k: j[k] for k in RECALLS}
        assert abs(t["total_loss"] - j["total_loss"]) <= LOSS_ATOL


def test_overfits_the_fixture(runs):
    """``video_retrieval.local.sh``'s check: R@1 = 100 after 6 steps."""
    final = runs["t_vals"][1][1]
    assert final["t2v-r@1"] == 100.0 and runs["port"].state.step == STEPS


def test_snapshots_on_disk(runs):
    d = runs["port_dir"]
    assert sorted(os.listdir(os.path.join(d, "models"))) == ["best", "model_4", "model_6"]
    for name in ("univl_retrieval_final", "config.yaml", "git_info.json"):
        assert os.path.exists(os.path.join(d, name)), name


def test_resume_from_model_4_is_bit_for_bit(runs):
    step, masters, moments, count, gen = runs["saved"]
    t = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", runs["port_dir"], "training_parameters.device", "cpu",
        "training_parameters.resume_file", os.path.join(runs["port_dir"], "models", "model_4")]))
    t.load()
    assert t.state.step == step == 4 and t.state.opt_state["count"] == count == 4
    for name, ref in masters.items():
        assert torch.equal(t.state.params[name], ref), name
    for k in ("mu", "nu"):
        for name, ref in moments[k].items():
            assert torch.equal(t.state.opt_state[k][name], ref), (k, name)
    assert torch.equal(t.state.generator.get_state(), gen)
    # the module's copies are refreshed from the masters
    module = dict(t.shell.module.named_parameters())
    assert all(torch.equal(module[n].detach(), masters[n]) for n in masters)


def test_max_ckpt_num_collects_old_snapshots(runs, tmp_path):
    cfg = t_build_config(CFG, opts=["training_parameters.save_dir", str(tmp_path),
                                    "training_parameters.max_ckpt_num", "2"])
    ck = Checkpoint(cfg)
    for it in (2, 4, 6):
        ck.save(runs["port"].state, it)
    ck.save_best(runs["port"].state)
    assert sorted(os.listdir(ck.models_dir)) == ["best", "model_4", "model_6"]
    assert ck.latest_path() == os.path.join(ck.models_dir, "model_6")


def test_tolerant_load_reports_like_jax(runs, tmp_path):
    """A tree with a leaf dropped, one of the wrong shape, one unknown and a
    renamed prefix: the port's report names the same missing, mismatched and
    unexpected paths as ``merge_params_tolerant``."""
    init = dict(runs["init"])
    mapping = {"old_base/": "base/"}
    tree = {("old_base/" + k[len("base/"):] if k.startswith("base/text_fc") else k): v
            for k, v in init.items()}
    dropped = "base/img_fc/kernel"
    del tree[dropped]
    tree["base/img_encoder/embeddings/cls_token"] = np.zeros((1, 1, 3), np.float32)
    tree["head/unknown/kernel"] = np.zeros((2, 2), np.float32)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **tree)

    def nest(flat):
        out = {}
        for path, leaf in flat.items():
            node = out
            *scopes, name = path.split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[name] = leaf
        return out

    _, j_report = merge_params_tolerant(nest(init), nest(tree), mapping)
    state = runs["port"].state
    before = {n: t.clone() for n, t in state.params.items()}
    _, t_report = Checkpoint(runs["port"].config, load_only=True).load_model_weights(
        state, npz, mapping)
    for kind in ("missing", "unexpected"):
        assert sorted(t_report[kind]) == sorted(j_report[kind]), kind
    assert t_report["missing"] == [dropped]
    assert [m.split(":")[0] for m in t_report["shape_mismatch"]] == \
        [m.split(":")[0] for m in j_report["shape_mismatch"]] == ["base/img_encoder/embeddings/cls_token"]
    for n, t in before.items():  # put the trained state back
        state.params[n].copy_(t)
    state.sync_model()
