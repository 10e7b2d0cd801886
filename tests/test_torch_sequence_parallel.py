"""Sequence parallelism in the port's models and trainer against JAX, on the CPU.

One spawn of 2 gloo ranks (``antmmf_torch.utils.launch`` running
``torch_sp_worker.py``) holds every scenario; the references run in this
process meanwhile, one JAX compile a configuration. Gradients come back as
the train step reduces them, the mean over the ranks, and are held against
the gradient one device computes on the global batch.

* Pink (``omni_tiny_test`` behind ``vit_tiny_test`` at 32², LoRA 2 on q and
  v, fp32) over ``{seq: 2}`` with ``ring`` and with ``ulysses``, and over
  ``{data: 2}`` without the knob: the LM loss and every gradient against
  ``jax.value_and_grad`` of the JAX model on the whole batch (4 rows,
  4 vision + 13 text positions: the stream of 17 pads to 18, and text
  position 4, the last of rank 0's slice, predicts a label on rank 1's);
* M2-omni (the ViT and the conv tower, spliced, LoRA 2 on the decoder's
  seven projections, remat: the ring's sends recomputed in the backward)
  over ``{seq: 2}`` (17 positions, the label of the first slot of rank 1's
  slice predicted across the boundary) and over ``{data: 2}``: the loss,
  ``lm_acc`` and every gradient against JAX. Tolerances: the loss at rtol
  1e-5, each gradient within 1e-4 of its largest JAX entry (as
  ``tests/test_torch_m2omni_train.py`` holds one process);
* ``video_retrieval.local.yml`` with ``long_video.yml``'s overrides
  (``sequence_parallel: ulysses``, ``remat_policy: dots_saveable``) and the
  cross-encoder over ``{seq: 2}``: Ulysses in the ViT (2 heads over 17
  tokens, padded to 18) and in the cross-encoder's pair stream, 2 steps of
  the trainer's step on numpy batches against the JAX trainer's jitted step
  on one device at the same overrides and batches, from the port's init
  (the knob does nothing on one device, and remat changes no value): the
  scalars at rtol 1e-5, the masters at atol 2e-6;
* ``antmmf_torch.run`` on ``pink_instruct.local.yml`` over ``{seq: 2}`` with
  ``sequence_parallel: ring`` for 4 iterations, restarted from the JAX
  trainer's initial parameters (drawn with numpy from its init's shapes,
  written as a ``params.npz``), against that JAX trainer's run (the
  port's ``tests/test_trainer_sp.py``): each logged ``lm_loss`` at atol
  1e-4, as ``tests/test_torch_pink_trainer.py`` holds one process.

The draws of dropout differ by rank under sequence parallelism; every
scenario runs at dropout 0.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.utils.launch import launch
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.models.base_model import ModelShell as JModelShell
from antmmf_tpu.models.m2_omni import M2Omni as JM
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_distributed_trainer import (COMMON, MINING, as_port, global_batches, jax_steps,
                                            one_process)
from test_torch_m2omni import CONV, SPLICE, TINY as M2_TINY, VIT, case_batch, jax_batch
from test_torch_m2omni_train import assert_grads_close
from test_torch_qwen2_vit import random_params
from test_torch_trainer import jax_saves_skipped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
RETRIEVAL = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
PINK_CFG = os.path.join(REPO, "projects", "pink", "configs", "pink_instruct.local.yml")
LOSS_RTOL, RUN_ATOL, MASTER_ATOL = 1e-5, 1e-4, 2e-6
PINK_TINY = dict(lm_preset="omni_tiny_test", vit_preset="vit_tiny_test", image_size=32,
                 lora_rank=2, dtype_str="float32")
M2_KW = {**M2_TINY, **VIT, **CONV, **SPLICE, "llm_lora_rank": 2, "llm_lora_targets": "all",
         "remat": True}
SEQ2, DATA2 = {"seq": 2}, {"data": 2}
RUN_STEPS = 4
RUN_OPTS = ["training_parameters.seed", "5", "training_parameters.log_interval", "1",
            "training_parameters.num_workers", "0", "training_parameters.run_type", "train",
            "training_parameters.max_iterations", str(RUN_STEPS),
            "training_parameters.snapshot_interval", "100"]
LONG_VIDEO = ["model_attributes.univl_retrieval.sequence_parallel", "ulysses",
              "model_attributes.univl_retrieval.n_clips", "2",
              "training_parameters.remat_policy", "dots_saveable"]


def pink_batch(seed=0, B=4, Lt=13):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (B, Lt))
    lens = np.array([Lt, Lt - 3, Lt - 5, Lt - 1])[:B]
    mask = (np.arange(Lt)[None] < lens[:, None]).astype(np.int64)
    labels = np.where(mask > 0, ids, -100)
    labels[:, :4] = -100  # the instruction
    return {"input_ids": ids * mask, "input_mask": mask, "labels": labels,
            "image_data": rng.standard_normal((B, 1, 32, 32, 3)).astype(np.float32)}


PINK_BATCH, M2_BATCH = pink_batch(), case_batch(M2_KW)
PINK_PARAMS = jax.device_get(random_params(JPink(**PINK_TINY), jax_batch(PINK_BATCH), seed=3))
M2_PARAMS = jax.device_get(random_params(JM(**M2_KW), jax_batch(M2_BATCH), seed=4))
MODELS = {
    "pink_ring": ("pink", {**PINK_TINY, "sequence_parallel": "ring"}, SEQ2),
    "pink_ulysses": ("pink", {**PINK_TINY, "sequence_parallel": "ulysses"}, SEQ2),
    "pink_data": ("pink", PINK_TINY, DATA2),
    "m2_ring": ("m2", {**M2_KW, "sequence_parallel": "ring"}, SEQ2),
    "m2_data": ("m2", M2_KW, DATA2),
}
BATCHES = global_batches(seed=3)


def model_spec(name):
    kind, kw, mesh = MODELS[name]
    params, batch = (PINK_PARAMS, PINK_BATCH) if kind == "pink" else (M2_PARAMS, M2_BATCH)
    return {"kind": kind, "kw": kw, "mesh": mesh, "params": flatten_flax(params),
            "batch": batch}


def retrieval_opts(tmp, name, *mesh):
    return [*COMMON, *MINING, *LONG_VIDEO, *mesh,
            "training_parameters.save_dir", os.path.join(tmp, name)]


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX trainer on pink_instruct.local.yml, loaded with parameters
    drawn with numpy from its init's shapes (no init to compile), written
    for the port's run to restart from."""
    tmp = str(tmp_path_factory.mktemp("jax_pink"))
    jt = j_build_trainer(j_build_config(PINK_CFG, opts=RUN_OPTS + [
        "training_parameters.save_dir", tmp]))

    def drawn_init(shell, rng, example_batch):
        return {"params": random_params(shell.module, example_batch, seed=6)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JModelShell, "init", drawn_init)
        jt.load()
    npz = os.path.join(tmp, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    return jt, npz


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """The spawn starts as soon as the JAX initial parameters exist and runs
    while this process computes the references."""
    tmp = str(tmp_path_factory.mktemp("sp_models"))
    spec, out = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out")
    os.makedirs(out)
    seq = ["training_parameters.mesh.data", "1", "training_parameters.mesh.seq", "2"]
    run_spec = {"config": PINK_CFG, "keys": ["train/losses/lm_loss", "train/total_loss"],
                "opts": [*RUN_OPTS, *seq, "training_parameters.mesh.model", "1",
                         "training_parameters.device", "cpu",
                         "model_attributes.pink.sequence_parallel", "ring",
                         "training_parameters.restart", "true",
                         "training_parameters.resume_file", jax_init[1],
                         "training_parameters.save_dir", os.path.join(tmp, "run")]}
    torch.save({"scenarios": [(n, "model", model_spec(n)) for n in MODELS] + [
        ("univl", "steps", {"config": RETRIEVAL, "batches": BATCHES,
                            "opts": retrieval_opts(tmp, "univl", *seq)}),
        ("run", "run", run_spec)]}, spec)

    def run():
        code = launch([os.path.join(HERE, "torch_sp_worker.py"), spec, out], nproc=2,
                      poll_seconds=0.2, extra_env={"OMP_NUM_THREADS": "1"})
        assert code == 0
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]

    return concurrent.futures.ThreadPoolExecutor(1).submit(run)


def jax_loss_and_grads(kind, kw):
    params, batch = (PINK_PARAMS, PINK_BATCH) if kind == "pink" else (M2_PARAMS, M2_BATCH)
    cls = JPink if kind == "pink" else JM
    # one device: the knob does nothing there, and remat changes no value
    model = cls(**{k: v for k, v in kw.items() if k not in ("sequence_parallel", "remat")})

    def loss_of(p, b):
        out = model.apply({"params": p}, b, deterministic=False)
        return out["losses"]["lm_loss"], out.get("metrics", {}).get("lm_acc", jnp.nan)

    (loss, acc), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params, jax_batch(batch))
    return float(loss), float(acc), grads


def jax_univl(tmp):
    """The JAX trainer's step at long_video.yml's overrides on one device,
    from the port's seeded init: (scalars a step, the masters after)."""
    port = one_process(RETRIEVAL, tmp, *MINING, *LONG_VIDEO, "training_parameters.mesh.data", "1")
    scalars, _, state = jax_steps(RETRIEVAL, port, *MINING, *LONG_VIDEO, batches=BATCHES)
    return scalars, as_port(port.shell.module, state.variables["params"])


@pytest.fixture(scope="module")
def references(ranks, jax_init, tmp_path_factory):
    """Every reference, while the ranks run: one compile a model (the SP and
    data-parallel scenarios of a model share it: its flags change nothing
    on one device), the JAX retrieval step at long_video.yml's overrides,
    and the JAX trainer's run."""
    refs = {kind: jax_loss_and_grads(kind, PINK_TINY if kind == "pink" else M2_KW)
            for kind in ("pink", "m2")}
    refs["univl"] = jax_univl(str(tmp_path_factory.mktemp("univl_one")))
    jt = jax_init[0]
    with jax_saves_skipped():
        jt.train()
    refs["run"] = list(jt.meter.meters["train/losses/lm_loss"].deque)
    return refs


@pytest.mark.parametrize("name", list(MODELS))
def test_lm_loss_and_gradients_over_ranks_match_jax(ranks, references, name):
    got = ranks.result()[0][name]
    kind, _, mesh = MODELS[name]
    loss, acc, grads = references[kind]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    if kind == "m2":
        np.testing.assert_allclose(got["acc"], acc, rtol=LOSS_RTOL)
    assert_grads_close(got["grads"], grads)
    r1 = ranks.result()[1][name]
    assert r1["loss"] == got["loss"]  # the global loss on every rank
    if mesh == SEQ2:  # each rank held half of the padded stream
        L = PINK_BATCH["input_ids"].shape[1] + 4 if kind == "pink" else M2_BATCH[
            "input_ids"].shape[1]
        assert got["hidden_len"] == r1["hidden_len"] == (L + 1) // 2 and L % 2


def test_long_video_ulysses_steps_equal_one_process(ranks, references):
    scalars, masters = references["univl"]
    for r in ranks.result():
        got = r["univl"]
        for t, j in zip(got["scalars"], scalars):
            assert set(t) == set(j)
            for k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
        for n, ref in masters.items():
            np.testing.assert_allclose(got["masters"][n].numpy(), ref.numpy(),
                                       atol=MASTER_ATOL, rtol=0, err_msg=n)


def test_run_trains_pink_over_seq_ranks_like_jax(ranks, references):
    jax_run = references["run"]
    got = ranks.result()[0]["run"]
    assert len(got["train/losses/lm_loss"]) == len(jax_run) == RUN_STEPS
    np.testing.assert_allclose(got["train/losses/lm_loss"], jax_run, atol=RUN_ATOL, rtol=0)
    assert ranks.result()[1]["run"] == got
