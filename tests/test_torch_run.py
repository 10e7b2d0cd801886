"""``python -m antmmf_torch.run`` on the CPU, and what it refuses.

* ``main([...])`` with ``training_parameters.device cpu`` trains the
  fixture config through the whole loop (steps, validation, snapshots,
  final weights, test inference);
* without it the trainer asks for the card, and on a machine without CUDA
  that raises before any data is read: it never becomes a CPU run;
* knobs of paths that are not ported raise with the key's name:
  ``sequence_parallel`` beside a (ported) nonzero ``dropout``, Pink's
  ``sequence_parallel`` beside ``scan_layers`` and beside
  ``visual_tower: eva`` with the (ported) ``kv_int8``; those ported since
  (``steps_per_dispatch`` 2, ``remat_policy``, ``num_nodes`` 2, which one
  process ignores as the JAX trainer does) train the fixture;
* the retrieval variants run to the end on the CPU: the MoCo config
  (``video_retrieval_moco.local.yml``), DMAE through ``retrieval_trainer``
  (``dmae_vtp/configs/msrvtt_retrieval.local.yml``), ``loss_type``
  ``mil_nce`` and ``neg_nce``, and ``retrieval_trainer`` with the
  cross-encoder's stage 2; without ``device cpu`` each asks for the card;
* a SIGTERM saves a snapshot at the next step boundary and ends the run.
"""

import os
import signal

import pytest
import torch

from antmmf_torch import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "projects", "base_vtp", "configs")
CFG = os.path.join(CONFIGS, "video_retrieval.local.yml")
PINK = os.path.join(REPO, "projects", "pink", "configs", "pink_instruct.local.yml")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes side by
    side, whose thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(save_dir, config=CFG, *extra):
    return ["--config", config, "training_parameters.save_dir", str(save_dir),
            "training_parameters.max_iterations", "2", "training_parameters.log_interval", "1",
            "training_parameters.snapshot_interval", "2", "training_parameters.seed", "3",
            *extra]


def test_cli_trains_the_fixture_on_the_cpu(tmp_path):
    trainer = run.main(_argv(tmp_path, CFG, "training_parameters.device", "cpu"))
    assert trainer.state.step == 2 and trainer.device.type == "cpu"
    assert next(trainer.shell.module.parameters()).device.type == "cpu"
    assert len(trainer.timings["step_s"]) == 2
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "model_2"]
    assert (tmp_path / "univl_retrieval_final").exists()
    assert 0 <= trainer.early_stopping.best_value <= 100


@pytest.mark.parametrize("device", [None, "cuda"])
def test_default_device_is_the_card(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    extra = () if device is None else ("training_parameters.device", device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(_argv(tmp_path, CFG, *extra))
    assert not (tmp_path / "models").exists()


@pytest.mark.parametrize("config,extra,key", [
    (CFG, ("training_parameters.steps_per_dispatch", "2"), None),
    (CFG, ("training_parameters.remat_policy", "dots_saveable"), None),
    # sequence parallelism is ported: in one process its knob trains
    # (over ranks: tests/test_torch_sequence_parallel.py)
    (CFG, ("model_attributes.univl_retrieval.dropout", "0.1",
           "model_attributes.univl_retrieval.sequence_parallel", "ulysses"), None),
    (CFG, ("training_parameters.num_nodes", "2"), None),
    (PINK, ("model_attributes.pink.scan_layers", "true",
            "model_attributes.pink.sequence_parallel", "ring"), None),
    (PINK, ("model_attributes.pink.visual_tower", "eva",
            "model_attributes.pink.eva_preset", "eva_tiny_test",
            "model_attributes.pink.image_size", "28",
            "task_attributes.pink_task.dataset_attributes.pink_instruct.image.size", "28",
            "model_attributes.pink.kv_int8", "true",
            "model_attributes.pink.sequence_parallel", "ulysses"), None),
], ids=["steps_per_dispatch", "remat_policy", "dropout", "num_nodes", "pink_scan_layers",
        "pink_eva"])
def test_unported_knobs_raise(tmp_path, config, extra, key):
    argv = _argv(tmp_path, config, "training_parameters.device", "cpu", *extra)
    if key is None:  # ported: the knob trains
        assert run.main(argv).state.step == 2
        return
    with pytest.raises(NotImplementedError, match=key):
        run.main(argv)


VARIANTS = {
    "moco": (os.path.join(CONFIGS, "video_retrieval_moco.local.yml"), ()),
    "dmae": (os.path.join(REPO, "projects", "dmae_vtp", "configs", "msrvtt_retrieval.local.yml"),
             ()),
    "mil_nce": (CFG, ("model_attributes.univl_retrieval.loss_type", "mil_nce")),
    "neg_nce": (CFG, ("model_attributes.univl_retrieval.loss_type", "neg_nce")),
    "stage2": (CFG, ("training_parameters.trainer", "retrieval_trainer",
                     "model_attributes.univl_retrieval.with_cross_encoder", "true",
                     "training_parameters.stage2_topk", "2")),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_cli_runs_the_retrieval_variants_on_the_cpu(tmp_path, name):
    config, extra = VARIANTS[name]
    trainer = run.main(_argv(tmp_path, config, "training_parameters.device", "cpu", *extra))
    assert trainer.state.step == 2 and trainer.device.type == "cpu"
    assert sorted(os.listdir(tmp_path / "models")) == ["best", "model_2"]
    losses = trainer.meter.meters["train/total_loss"].deque
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(list(losses))))
    if name == "moco":
        assert int(trainer.shell.module.text_queue.ptr) == 2 * 4
    if name in ("dmae", "stage2"):
        key = "l3_simi_t2v-mean_recall" if name == "dmae" else "l2_simi_t2v-r@1"
        assert 0 <= trainer.evaluate_set("val")[key] <= 100


@pytest.mark.parametrize("name", list(VARIANTS))
def test_retrieval_variants_ask_for_the_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    config, extra = VARIANTS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(_argv(tmp_path, config, *extra))
    assert not (tmp_path / "models").exists()


def test_world_size_from_the_environment_raises(tmp_path, monkeypatch):
    """A world size in the environment without the launcher's rendezvous
    (``antmmf_torch.utils.launch``) never becomes a run of one process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="world size 2"):
        run.main(_argv(tmp_path, CFG, "training_parameters.device", "cpu"))


def test_sigterm_saves_a_snapshot_and_stops(tmp_path):
    """A SIGTERM during step 2 (a preempted job) saves ``model_2`` at the
    step boundary and ends the run without the final validation; the
    previous handler is back afterwards."""
    from antmmf_torch.common.build import build_config
    from antmmf_torch.trainers.build import build_trainer

    args = run.get_parser().parse_args(_argv(tmp_path, CFG, "training_parameters.device", "cpu",
                                             "training_parameters.max_iterations", "4",
                                             "training_parameters.snapshot_interval", "10"))
    trainer = build_trainer(build_config(args.config, None, args.opts))
    trainer.load()
    step, calls = trainer._train_step, []

    def preempted_step(state, batch):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(state, batch)

    trainer._train_step = preempted_step
    before = signal.getsignal(signal.SIGTERM)
    trainer.train()
    assert len(calls) == 2 and trainer.state.step == 2
    assert os.listdir(tmp_path / "models") == ["model_2"]
    assert not (tmp_path / "univl_retrieval_final").exists()
    assert signal.getsignal(signal.SIGTERM) == before
