"""The ROI data pipeline in the port against the JAX package, bit for bit.

* ``RegionProcessor`` at the same seed, over the same items in turn (one
  generator a processor, so the draws chain from item to item): masking
  off; masking on at the config's 0.15; masking on at 0.9 over
  overlapping boxes, so that the zeroing of neighbours with IoU > 0.4
  shows; fewer regions than ``max_features`` and an item without
  ``cls_prob``. ``_pairwise_iou`` on the same boxes.
* ``OCRProcessor``: lines of several wordpieces, a line cut inside at
  ``max_length``, boxes outside the image (bucketised into [0, 1000]), an
  empty OCR list, no line text at all.
* The first train and val batch of ``roi_pretrain.local.yml`` through
  each package's task loader (``roi_dataset``): every field, its dtype and
  its values at atol 0, with MLM masking, region masking and ITM swaps in
  training and none of them in validation.
"""

import os

import numpy as np
import pytest

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.common.task_loader import TaskLoader as TTaskLoader
from antmmf_torch.datasets.processors import region_processors as t_rp
from antmmf_torch.trainers import build as _t_registrations  # noqa: F401
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.common.task_loader import TaskLoader as JTaskLoader
from antmmf_tpu.datasets.processors import region_processors as j_rp
from antmmf_tpu.trainers import build as _j_registrations  # noqa: F401
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROI_LOCAL = os.path.join(REPO, "projects", "base_vtp", "configs", "roi_pretrain.local.yml")


def _items(seed, n_items=6, M=8, overlap=False, cls=True):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_items):
        m = M - (i % 3) * 3  # 8, 5, 2 regions
        corner = rng.uniform(0, 200, (m, 2))
        if overlap:  # all boxes near one another: IoUs well above 0.4
            corner = 100 + rng.uniform(0, 6, (m, 2))
        boxes = np.concatenate([corner, corner + rng.uniform(40, 90, (m, 2))], -1)
        item = {"features": rng.standard_normal((m, 16)).astype(np.float32),
                "bbox": boxes.astype(np.float32), "image_height": 330.0,
                "image_width": 300.0}
        if cls:
            item["cls_prob"] = rng.dirichlet(np.ones(4), m).astype(np.float32)
        items.append(item)
    return items


SETTINGS = {  # (processor config, item kwargs, mask_regions)
    "masking_off": ({"max_features": 6, "feature_dim": 16, "region_kl_fc_dim": 4}, {}, False),
    "masking_on": ({"max_features": 6, "feature_dim": 16, "region_kl_fc_dim": 4}, {}, True),
    "overlap_zeroing": ({"max_features": 6, "feature_dim": 16, "region_kl_fc_dim": 4,
                         "mask_region_prob": 0.9}, {"overlap": True}, True),
    "fewer_regions_no_cls": ({"max_features": 10, "feature_dim": 16, "region_kl_fc_dim": 4},
                             {"M": 6, "cls": False}, True),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_region_processor_is_bit_for_bit(name):
    cfg, kw, mask_regions = SETTINGS[name]
    j_proc = j_rp.RegionProcessor({**cfg, "seed": 7})
    t_proc = t_rp.RegionProcessor({**cfg, "seed": 7})
    predicted = zeroed = 0
    for item in _items(len(name), **kw):
        j, t = j_proc(item, mask_regions=mask_regions), t_proc(item, mask_regions=mask_regions)
        assert sorted(t) == sorted(j)
        for key, ref in j.items():
            assert t[key].dtype == ref.dtype and t[key].shape == ref.shape, key
            np.testing.assert_array_equal(t[key], ref, err_msg=key)
        predicted += int(t["region_to_predict"].sum())
        zeroed += int(((t["region_feature"] == 0).all(-1) & (t["region_mask"] > 0)).sum())
    assert (predicted > 0) == mask_regions
    if name == "overlap_zeroing":  # neighbours zeroed beyond the supervised regions
        assert zeroed > predicted * 0.9 * 0.5
    assert t_proc.rng.random() == j_proc.rng.random()  # the same draws were consumed


def test_pairwise_iou_matches_jax():
    boxes = _items(3)[0]["bbox"]
    np.testing.assert_array_equal(t_rp._pairwise_iou(boxes), j_rp._pairwise_iou(boxes))


OCR_ITEMS = [
    {"ocr_text": ["TOTAL DUE", "$50.00", "thank you for shopping"],
     "ocr_box": [[10, 10, 120, 30], [130, 10, 200, 30], [-5, 300, 350, 400]],
     "image_height": 330, "image_width": 300},
    {"ocr_text": ["invoice number 4471 issued on the first of march"] * 3,
     "ocr_box": [[5, 5, 295, 25]] * 3, "image_height": 330, "image_width": 300},
    {"ocr_text": [], "ocr_box": [], "image_height": 330, "image_width": 300},
    {"image_height": 0, "image_width": 0},
]


@pytest.mark.parametrize("max_length", [16, 24])
def test_ocr_processor_is_bit_for_bit(max_length):
    j_proc = j_rp.OCRProcessor({"max_length": max_length})
    t_proc = t_rp.OCRProcessor({"max_length": max_length})
    for item in OCR_ITEMS:
        j, t = j_proc(item), t_proc(item)
        assert sorted(t) == sorted(j) == ["ocr_bboxes", "ocr_input_ids", "ocr_input_mask"]
        for key, ref in j.items():
            assert t[key].dtype == ref.dtype and t[key].shape == ref.shape, key
            np.testing.assert_array_equal(t[key], ref, err_msg=key)
    sep = t_proc.tokenizer.convert_tokens_to_ids([";"])[0]
    cut = t_proc(OCR_ITEMS[1])
    assert cut["ocr_input_mask"].all() and cut["ocr_input_ids"][-1] != sep  # cut inside a line
    assert not t_proc(OCR_ITEMS[2])["ocr_input_mask"].any()
    assert t_proc(OCR_ITEMS[0])["ocr_bboxes"][:, 0].min() == 0  # x0 < 0 bucketised to 0


def _first(loader_cls, config, dataset_type):
    loader = loader_cls(config)
    loader.load_task([dataset_type])
    loader.make_dataloaders()
    loader.seed_sampler(dataset_type, 0)
    return next(iter(loader.get_loaders(dataset_type)[0]))


@pytest.mark.parametrize("dataset_type", ["train", "val"])
def test_first_roi_batch_matches_jax(dataset_type):
    opts = ["training_parameters.num_workers", "0"]
    j = _first(JTaskLoader, j_build_config(ROI_LOCAL, opts=opts), dataset_type).arrays()
    t = _first(TTaskLoader, t_build_config(ROI_LOCAL, opts=opts), dataset_type).arrays()
    assert sorted(t) == sorted(j) == sorted([
        "caption_input_ids", "caption_input_mask", "caption_lm_label_ids",
        "caption_raw_input_ids", "caption_segment_ids", "id", "itm_labels", "ocr_bboxes",
        "ocr_input_ids", "ocr_input_mask", "region_boxes", "region_cls_dis", "region_feature",
        "region_mask", "region_to_predict"])
    for key, ref in j.items():
        assert t[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(t[key], ref, err_msg=key)
    assert t["region_boxes"].shape == (4, 5, 5) and t["ocr_bboxes"].shape == (4, 24, 4)
    training = dataset_type == "train"
    assert ((t["caption_lm_label_ids"] >= 0).any()) == training
    assert ((t["itm_labels"] == 0).any()) == training  # a swapped caption and OCR
    assert (t["region_to_predict"].any()) == training
