"""The Pink instruction-tuning data pipeline in the port against the JAX
package, bit for bit.

* ``interleave_index``: round robin with both stopping strategies, the
  seeded weighted draw with both, several seeds and weights; the refusals.
* ``build_conversations`` in all six formats (``vqa`` with and without the
  marks, ``caption``, ``grounding``, ``region_caption``, ``pointing`` with
  a point and with a box, ``conversations``), the templates picked by a
  seeded generator.
* The conversation processor on every template: the prompt, ``input_ids``,
  ``input_mask`` and ``labels`` of one- and two-round conversations, with
  and without an image, with ``<im_patch>`` placeholders, cut at
  ``max_length``; ``build_prompt`` and ``construct_target`` alone;
  ``mpt`` refused.
* ``serialize_box``/``parse_boxes``, ``pink_box`` and ``pink_prompt`` with
  its seeded template draws.
* The first train and val batch of ``pink_instruct.local.yml`` through
  each package's task loader (every field, dtype and value at atol 0), and
  the black frame of a row without an image or with a file that does not
  read.
"""

import json
import os

import numpy as np
import pytest

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.task_loader import TaskLoader as TTaskLoader
from antmmf_torch.datasets import pink_instruct_dataset as t_ds
from antmmf_torch.datasets.processors import pink_conversation as t_conv
from antmmf_torch.datasets.processors import pink_processors as t_pp
from antmmf_torch.trainers import build as _t_registrations  # noqa: F401
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.task_loader import TaskLoader as JTaskLoader
from antmmf_tpu.datasets import pink_instruct_dataset as j_ds
from antmmf_tpu.datasets.processors import pink_conversation as j_conv
from antmmf_tpu.datasets.processors import pink_processors as j_pp
from antmmf_tpu.trainers import build as _j_registrations  # noqa: F401
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "pink", "configs", "pink_instruct.local.yml")
VOCAB = os.path.join(REPO, "tests", "data", "vocabs", "bert-base-uncased_30522_vocab.txt")


@pytest.mark.parametrize("lengths,probs,seed,strategy", [
    ([2, 3], None, 0, "first_exhausted"),
    ([2, 3], None, 0, "all_exhausted"),
    ([4, 1, 3], None, 0, "all_exhausted"),
    ([3, 5], [0.5, 0.5], 7, "all_exhausted"),
    ([3, 5], [0.5, 0.5], 8, "all_exhausted"),
    ([5, 2, 2], [2.0, 1.0, 1.0], 42, "all_exhausted"),
    ([2, 50], [0.9, 0.1], 0, "first_exhausted"),
    ([100, 100], [0.9, 0.1], 1, "first_exhausted"),
    ([6, 3, 4], [0.2, 0.5, 0.3], 9, "first_exhausted"),
])
def test_interleave_index_is_bit_for_bit(lengths, probs, seed, strategy):
    want = j_ds.interleave_index(lengths, probs, seed, strategy)
    got = t_ds.interleave_index(lengths, probs, seed, strategy)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [([0, 2], None, 0, "all_exhausted"),
                                  ([2, 2], [1.0, 0.0], 0, "first_exhausted"),
                                  ([2, 2], [-1.0, 2.0], 0, "all_exhausted"),
                                  ([2, 2], None, 0, "longest")])
def test_interleave_index_refusals_match(args):
    for mod in (j_ds, t_ds):
        with pytest.raises(ValueError):
            mod.interleave_index(*args)


ROWS = [
    ("vqa", {"question": "what color is the ball?", "answer": "red", "image": "a.jpg"}, True),
    ("vqa", {"question": "how many dogs?", "answers": ["two", "2"]}, False),
    ("caption", {"caption": "a dog on the grass", "image": "b.jpg"}, True),
    ("grounding", {"expr": "the red ball", "bbox": [4, 6, 20, 24], "width": 56, "height": 40},
     True),
    ("grounding", {"caption": "a small dog", "bbox": [10, 8, 30, 36], "width": 56,
                   "height": 48}, False),
    ("region_caption", {"caption": "a dog", "bbox": [0, 0, 28, 40], "width": 56, "height": 40},
     True),
    ("pointing", {"question": "what is here?", "point": [28, 20], "width": 56, "height": 40,
                  "answer": "a hat"}, True),
    ("pointing", {"question": "and here?", "bbox": [2, 4, 30, 22], "width": 56, "height": 40,
                  "answer": "a cup"}, True),
    ("conversations", {"conversations": [{"from": "human", "value": "hi"},
                                         {"from": "gpt", "value": "hello"},
                                         {"from": "human", "value": "and?"},
                                         {"from": "gpt", "value": "bye"}],
                       "image": "c.jpg"}, True),
]


@pytest.mark.parametrize("fmt,row,marks", ROWS)
def test_build_conversations_is_bit_for_bit(fmt, row, marks):
    out = []
    for mod in (j_ds, t_ds):
        rng = np.random.default_rng(11)
        out.append(mod.build_conversations(
            fmt, row, pick=lambda pool, rng=rng: pool[int(rng.integers(0, len(pool)))],
            add_marks=marks, expand2square=marks))
    assert out[1] == out[0]


def test_build_conversations_unknown_format_raises():
    for mod in (j_ds, t_ds):
        with pytest.raises(KeyError):
            mod.build_conversations("ocr", {}, pick=lambda pool: pool[0])


CONVS = [
    [{"from": "human", "value": "What is in the image?"},
     {"from": "gpt", "value": "A dog playing with a ball."}],
    [{"from": "human", "value": "What is in the image?"},
     {"from": "gpt", "value": "A dog playing with a ball."},
     {"from": "human", "value": "Where is the ball <loc>[0.1,0.2,0.4,0.5]</loc>?"},
     {"from": "gpt", "value": "On the grass near the dog."}],
]


@pytest.mark.parametrize("template", ["llamav1", "llamav2", "vicuna_v1_1"])
@pytest.mark.parametrize("convs", [0, 1])
@pytest.mark.parametrize("has_image,patches,max_length", [(True, 0, 96), (True, 3, 96),
                                                          (False, 0, 96), (True, 3, 20)])
def test_conversation_processor_is_bit_for_bit(template, convs, has_image, patches, max_length):
    cfg = {"template": template, "num_patch_tokens": patches, "max_length": max_length,
           "text": {"vocab_file": VOCAB}}
    item = {"conversations": CONVS[convs], "has_image": has_image}
    want = j_conv.PinkConversationProcessor(cfg)(item)
    got = t_conv.PinkConversationProcessor(cfg)(item)
    assert got["prompt"] == want["prompt"]
    for key in ("input_ids", "input_mask", "labels"):
        assert got[key].dtype == want[key].dtype and got[key].shape == (max_length,)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    sup = got["labels"] >= 0
    assert got["labels"][0] == t_conv.IGNORE_INDEX  # BOS never supervises
    assert (got["input_mask"][sup] == 1).all()
    if max_length > 20:  # at 20 the cut may fall before the first answer
        assert sup.any()
        assert (got["input_ids"] == 1).sum() == patches  # im_patch_id


@pytest.mark.parametrize("template", ["llamav1", "llamav2", "vicuna_v1_1"])
def test_prompt_and_masking_are_bit_for_bit(template):
    proc = t_conv.PinkConversationProcessor({"template": template,
                                             "text": {"vocab_file": VOCAB}})
    for convs in CONVS:
        for has_image in (True, False):
            want = j_conv.build_prompt(j_conv.CONV_TEMPLATES[template], convs, has_image, 4)
            got = t_conv.build_prompt(t_conv.CONV_TEMPLATES[template], convs, has_image, 4)
            assert got == want
            assert t_conv.construct_target(got, t_conv.CONV_TEMPLATES[template],
                                           proc.tokenize) == \
                j_conv.construct_target(want, j_conv.CONV_TEMPLATES[template], proc.tokenize)


def test_mpt_template_is_refused_by_both():
    for mod in (j_conv, t_conv):
        with pytest.raises(ValueError):
            mod.PinkConversationProcessor({"template": "mpt", "text": {"vocab_file": VOCAB}})
        with pytest.raises(KeyError):
            mod.PinkConversationProcessor({"template": "chatml", "text": {"vocab_file": VOCAB}})
    mpt = [t_conv.CONV_TEMPLATES["mpt"], j_conv.CONV_TEMPLATES["mpt"]]
    assert t_conv.build_prompt(mpt[0], CONVS[1], True, 2) == \
        j_conv.build_prompt(mpt[1], CONVS[1], True, 2)


@pytest.mark.parametrize("box,w,h,square", [([4, 6, 20, 24], 56, 40, True),
                                            ([4, 6, 20, 24], 56, 40, False),
                                            ([0, 10, 30, 47], 40, 48, True)])
def test_boxes_serialise_and_parse_as_jax(box, w, h, square):
    for tags in (True, False):
        text = t_pp.serialize_box(box, w, h, square, tags)
        assert text == j_pp.serialize_box(box, w, h, square, tags)
    both = text + " and " + t_pp.serialize_box([1, 2, 3, 4], w, h, square)
    got, want = t_pp.parse_boxes(both, w, h, square), j_pp.parse_boxes(both, w, h, square)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert t_pp.expand2square_offset(w, h) == j_pp.expand2square_offset(w, h)


def test_box_and_prompt_processors_match_jax():
    box = {"box": [4, 6, 20, 24], "width": 56, "height": 40}
    assert t_pp.PinkBoxProcessor({})(box) == j_pp.PinkBoxProcessor({})(box)
    t_prompt = t_pp.PinkPromptProcessor({"seed": 3})
    j_prompt = j_pp.PinkPromptProcessor({"seed": 3})
    for i, task in enumerate(["visual_grounding", "region_caption"] * 4):
        item = dict(box, task=task, expr=f"object {i}", phrase=f"a thing {i}")
        assert t_prompt(item) == j_prompt(item)
    for mod in (t_pp, j_pp):
        with pytest.raises(KeyError):
            mod.PinkPromptProcessor({})(dict(box, task="ocr"))


def _first(loader_cls, config, dataset_type):
    loader = loader_cls(config)
    loader.load_task([dataset_type])
    loader.make_dataloaders()
    loader.seed_sampler(dataset_type, 0)
    return next(iter(loader.get_loaders(dataset_type)[0]))


@pytest.mark.parametrize("dataset_type", ["train", "val"])
def test_first_pink_batch_matches_jax(dataset_type):
    opts = ["training_parameters.num_workers", "0", "training_parameters.seed", "5"]
    j = _first(JTaskLoader, j_build_config(CFG, opts=opts), dataset_type).arrays()
    t = _first(TTaskLoader, t_build_config(CFG, opts=opts), dataset_type).arrays()
    assert sorted(t) == sorted(j) == ["id", "image_data", "input_ids", "input_mask", "labels"]
    for key, ref in j.items():
        assert t[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(t[key], ref, err_msg=key)
    assert t["image_data"].shape == (4, 1, 32, 32, 3) and t["labels"].shape == (4, 96)
    assert (t["labels"] >= 0).any(1).all() and np.abs(t["image_data"]).sum() > 0


def test_rows_without_a_readable_image_give_black_frames(tmp_path):
    rows = [{"question": "what?", "answer": "red"},
            {"question": "where?", "answer": "here", "image": "missing.jpg"}]
    (tmp_path / "vqa.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    cfg = {"data_root_dir": str(tmp_path), "image": {"size": 16, "resize": 18},
           "sources": [{"annotations": "vqa.jsonl", "format": "vqa"}],
           "conversation": {"max_length": 48, "text": {"vocab_file": VOCAB}}}
    t = t_ds.PinkInstructDataset("pink_instruct", "train", cfg)
    j = j_ds.PinkInstructDataset("pink_instruct", "train", cfg)
    assert len(t) == len(j) == 2
    for i in range(2):
        got, want = t[i], j[i]
        assert got["image_data"].shape == (1, 16, 16, 3) and not got["image_data"].any()
        for key in ("input_ids", "input_mask", "labels", "image_data", "id"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
