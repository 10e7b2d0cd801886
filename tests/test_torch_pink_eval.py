"""``antmmf_torch/scripts/pink_eval.py`` against ``antmmf_tpu/scripts/pink_eval.py``.

* every scorer (``normalize_answer``, ``vqa_score``, ``box_iou``,
  ``grounding_score``, ``pointing_score``, ``mc_score``, ``binary_score``),
  ``score_rows`` for every task and ``build_benchmark_prompt`` for every
  benchmark on fixed rows equal JAX's;
* ``main`` on a 4-row jsonl of seeded OpenCV images at
  ``pink_tiny.local.yml`` (the vocabulary widened to the tokenizer's):
  JAX's ``main`` with its own init, the port's with those weights from a
  ``params.npz`` (``--model_dir``): the same predictions and summary,
  greedy and with ``--num_beams 2``.
"""

import contextlib
import functools
import io
import json
import os

import jax
import numpy as np
import pytest

from antmmf_torch.scripts import pink_eval as t_eval
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.models.base_model import ModelShell as JModelShell
from antmmf_tpu.models.pink import PinkModel as JPink
from antmmf_tpu.scripts import pink_eval as j_eval
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

ROWS = [
    {"image": "a.png", "question": "How many dogs are there?", "answer": "two",
     "answers": ["2", "two", "2", "3", "2", "two", "2", "2", "2", "two"],
     "bbox": [10, 20, 60, 90], "width": 120, "height": 100, "options": ["cat", "dog", "two"],
     "caption": "the dog is left of the cat", "expr": "the brown dog", "point": [30, 40]},
    {"image": "b.png", "question": "Is it raining?", "answer": "yes", "bbox": [0, 0, 50, 50],
     "width": 64, "height": 48, "options": ["yes", "no"]},
    {"image": "c.png", "question": "Which box?", "answer": "B",
     "options": [[1, 2, 30, 40], [5, 6, 50, 44]], "width": 80, "height": 60,
     "bbox": [5, 6, 50, 44]},
]
PREDS = ["2 dogs.", "Yes, it is", "B) the second [0.063,0.100,0.625,0.733]"]
TEXTS = ["Two!", "the  Dog's, ball", "It isnt 3.5 or 1,000 (none)", "  a  \tcat\n"]
PINK_CFG = "projects/pink/configs/pink_tiny.local.yml"
TASKS = ("vqa", "gqa", "okvqa", "grounding", "pointing", "mc", "binary", "caption")


def test_scorers_match_jax():
    for text in TEXTS:
        assert t_eval.normalize_answer(text) == j_eval.normalize_answer(text)
        for answers in (["two"], ["2", "two", "2"], ROWS[0]["answers"]):
            assert t_eval.vqa_score(text, answers) == j_eval.vqa_score(text, answers)
    a, b = [10, 20, 60, 90], [30, 10, 80, 70]
    assert t_eval.box_iou(a, b) == j_eval.box_iou(a, b)
    for pred in PREDS + ["[0.1,0.2,0.6,0.9] and [0,0,1,1]", "no box"]:
        for row in ROWS:
            args = (pred, row["bbox"], row["width"], row["height"])
            assert t_eval.grounding_score(*args) == j_eval.grounding_score(*args)
            assert t_eval.pointing_score(*args) == j_eval.pointing_score(*args)
            opts = [str(o) for o in row["options"]]
            assert t_eval.mc_score(pred, row["answer"], opts) == \
                j_eval.mc_score(pred, row["answer"], opts)
            for ans in (row["answer"], True, False):
                assert t_eval.binary_score(pred, ans) == j_eval.binary_score(pred, ans)


@pytest.mark.parametrize("task", TASKS)
def test_score_rows_match_jax(task):
    rows = [dict(r, options=[str(o) for o in r["options"]]) for r in ROWS]
    assert t_eval.score_rows(rows, PREDS, task) == j_eval.score_rows(rows, PREDS, task)


@pytest.mark.parametrize("benchmark", sorted(set(TASKS) | set(j_eval.BENCHMARK_ALIASES)))
def test_benchmark_prompts_match_jax(benchmark):
    assert t_eval.BENCHMARK_ALIASES == j_eval.BENCHMARK_ALIASES
    for idx, row in enumerate(ROWS):
        if benchmark.startswith("pointing") and idx == 2:
            row = {k: v for k, v in row.items() if k != "point"}
        for template in ("vicuna_v1", "llama2"):
            assert t_eval.build_benchmark_prompt(benchmark, row, idx, template) == \
                j_eval.build_benchmark_prompt(benchmark, row, idx, template)


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """Four seeded images and their jsonl; a config with the tokenizer's
    vocabulary; JAX ``main``'s outputs and its init as a params.npz."""
    import cv2

    d = tmp_path_factory.mktemp("pink_eval")
    rng = np.random.default_rng(40)
    rows = []
    for i in range(4):
        cv2.imwrite(str(d / f"{i}.png"), rng.integers(0, 256, (40 + 4 * i, 48, 3), np.uint8))
        rows.append({"image": f"{i}.png", "question": f"what is object {i}?",
                     "answers": ["dog", "a dog", "cat"][: 1 + i % 3]})
    (d / "rows.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (d / "cfg.yml").write_text(f"includes:\n  - {os.path.abspath(PINK_CFG)}\nmodel_attributes:\n"
                               "  pink:\n    vocab_override: 30522\n")
    out = {}
    seen = []
    real_generate, real_init = JPink.generate, JModelShell.init

    def generate(self, variables, *a, **kw):
        seen.append(variables)
        return real_generate(self, variables, *a, **kw)

    def init_once(self, rng, example):  # both runs draw PRNGKey(0)'s init: compile it once
        if not seen:
            seen.append(jax.jit(functools.partial(real_init, self))(rng, example))
        return seen[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPink, "generate", generate)
        mp.setattr(JModelShell, "init", init_once)
        for name, extra in (("greedy", []), ("beams", ["--num_beams", "2"])):
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                j_eval.main(common_argv(d, name + "_jax") + extra)
            out[name] = (read_run(d, name + "_jax"), json.loads(printed.getvalue()))
    assert all(v is seen[0] for v in seen)
    np.savez(d / "params.npz", **flatten_flax(jax.device_get(seen[0]["params"])))
    return d, out


def common_argv(d, name):
    return ["--config", str(d / "cfg.yml"), "--annotations", str(d / "rows.jsonl"),
            "--image_dir", str(d), "--task", "vqa", "--batch_size", "4", "--max_prompt_len",
            "24", "--max_new_tokens", "6", "--image_size", "32",
            "--out", str(d / f"{name}.jsonl")]


def read_run(d, name):
    lines = (d / f"{name}.jsonl").read_text().splitlines()
    return [json.loads(line)["prediction"] for line in lines]


@pytest.mark.parametrize("name,extra", [("greedy", []), ("beams", ["--num_beams", "2"])])
def test_main_matches_jax(eval_dir, capsys, name, extra):
    d, out = eval_dir
    capsys.readouterr()
    summary = t_eval.main(common_argv(d, name) + extra + ["--model_dir", str(d), "--device",
                                                           "cpu"])
    predictions, jax_summary = out[name]
    assert read_run(d, name) == predictions and all(predictions)
    assert json.loads(capsys.readouterr().out) == summary == jax_summary
