"""Corpus-level evaluators: host-side collect/summarize over a whole eval set.

Port of ``antmmf_tpu/modules/metrics/evaluators.py``'s retrieval and caption
evaluators:
``GlobalRetrievalRecallEvaluator`` gathers the text and video embeddings of
every eval batch and computes text→video and video→text recalls with
multi-ground-truth min-rank; with ``image_vid`` in the batch, videos are
deduplicated by id (which also drops the rows that ``pad_last`` repeated;
repeated captions stay, as in the JAX package). Over ranks it gathers
every rank's rows with the dataset indices they were loaded from
(``DataLoader``'s ``sample_index``) before it scores, keeps one row an
index (the wrap-around padding of the sampler and of the last batch
repeats some) in the dataset's order, and so scores what one process
scores on the eval set. ``recall_metrics`` turns
0-based ranks into R@1/5/10 (percent), median and mean rank.
``CaptioningEvaluator`` (``captioning``) scores generated captions with
corpus BLEU-4 and ROUGE-L. The other evaluators raise until they are
ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from antmmf_torch.modules.metrics.extended import bleu4, rouge_l
from antmmf_torch.parallel import collectives as coll


class BaseEvaluator:
    def reset(self) -> None:
        raise NotImplementedError

    def collect(self, batch: Mapping, output: Mapping) -> None:
        raise NotImplementedError

    def summarize(self) -> Dict[str, float]:
        raise NotImplementedError


def _ranks_with_multi_gt(
    sim: np.ndarray, gt_lists: Sequence[Sequence[int]]
) -> np.ndarray:
    """Row i's rank = min rank over its ground-truth column set (0-based)."""
    order = np.argsort(-sim, axis=1)
    ranks = np.empty(sim.shape[0], dtype=np.int64)
    for i, gts in enumerate(gt_lists):
        gts = set(int(g) for g in gts)
        pos = np.nonzero(np.isin(order[i], list(gts)))[0]
        ranks[i] = int(pos.min()) if len(pos) else sim.shape[1] - 1
    return ranks


def recall_metrics(ranks: np.ndarray, prefix: str) -> Dict[str, float]:
    n = max(1, len(ranks))
    return {
        f"{prefix}r@1": float((ranks < 1).sum() / n * 100.0),
        f"{prefix}r@5": float((ranks < 5).sum() / n * 100.0),
        f"{prefix}r@10": float((ranks < 10).sum() / n * 100.0),
        f"{prefix}median_rank": float(np.median(ranks) + 1),
        f"{prefix}mean_rank": float(ranks.mean() + 1),
    }


class GlobalRetrievalRecallEvaluator(BaseEvaluator):
    """Accumulates text/video embeddings (or sim-matrix chunks) across eval
    batches, then computes t2v and v2t recalls with multi-gt min-rank."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        self.params = dict(params or {})
        self.reset()

    def reset(self) -> None:
        self._text: List[np.ndarray] = []
        self._video: List[np.ndarray] = []
        self._t2v_gt: List[Sequence[int]] = []
        self._v2t_gt: List[Sequence[int]] = []
        self._vids: List[np.ndarray] = []
        self._index: List[np.ndarray] = []
        self._explicit_gt = False

    def collect(self, batch: Mapping, output: Mapping) -> None:
        t = output.get("text_embed")
        v = output.get("visual_embed")
        if t is None or v is None:
            return
        self._text.append(np.asarray(t, dtype=np.float32))
        self._video.append(np.asarray(v, dtype=np.float32))
        index = getattr(batch, "sample_index", None)
        if index is not None:
            self._index.append(np.asarray(index, dtype=np.int64))
        meta = getattr(batch, "metadata", {}) if not isinstance(batch, dict) else {}
        if isinstance(batch, Mapping) and "image_vid" in batch:
            # unique-video id per row → dedupe + grouped gt in summarize
            self._vids.append(np.asarray(batch["image_vid"]).reshape(-1))
            return
        t2v = (batch.get("caption_vid_list") if isinstance(batch, Mapping) else None) \
            or meta.get("caption_vid_list")
        v2t = (batch.get("image_tid_list") if isinstance(batch, Mapping) else None) \
            or meta.get("image_tid_list")
        n_t_prev = sum(x.shape[0] for x in self._text[:-1])
        n_v_prev = sum(x.shape[0] for x in self._video[:-1])
        self._explicit_gt |= t2v is not None or v2t is not None
        if t2v is not None:
            self._t2v_gt.extend(t2v)
        else:  # identity pairing: text i ↔ video i
            self._t2v_gt.extend([[n_v_prev + i] for i in range(self._video[-1].shape[0])])
        if v2t is not None:
            self._v2t_gt.extend(v2t)
        else:
            self._v2t_gt.extend([[n_t_prev + i] for i in range(self._text[-1].shape[0])])

    def _gather_ranks(self) -> None:
        """Every rank's rows, one a dataset index, in the dataset's order."""
        if self._explicit_gt:
            raise NotImplementedError("over ranks the retrieval evaluator pairs rows by "
                                      "image_vid; explicit caption_vid_list pairs are not "
                                      "gathered yet")
        if len(self._index) != len(self._text):
            raise ValueError("over ranks each eval batch must carry its sample_index")
        cat = (lambda xs: np.concatenate(xs) if xs else None)
        parts = coll.all_gather_object((cat(self._text), cat(self._video), cat(self._vids),
                                        cat(self._index)))
        parts = [p for p in parts if p[0] is not None]
        index = np.concatenate([p[3] for p in parts])
        _, first = np.unique(index, return_index=True)
        self._text = [np.concatenate([p[0] for p in parts])[first]]
        self._video = [np.concatenate([p[1] for p in parts])[first]]
        self._vids = [np.concatenate([p[2] for p in parts])[first]] if self._vids else []
        n = len(first)
        self._t2v_gt = [[i] for i in range(n)]
        self._v2t_gt = [[i] for i in range(n)]

    def summarize(self) -> Dict[str, float]:
        if coll.get_world_size() > 1:
            self._gather_ranks()
        if not self._text:
            return {}
        t = np.concatenate(self._text)
        v = np.concatenate(self._video)
        if self._vids:
            # dedupe videos by id; build grouped multi-gt both directions
            vids = np.concatenate(self._vids)
            uniq_ids, first_idx = np.unique(vids, return_index=True)
            v = v[first_idx]
            col_of = {int(u): c for c, u in enumerate(uniq_ids)}
            self._t2v_gt = [[col_of[int(x)]] for x in vids]
            self._v2t_gt = [
                np.nonzero(vids == u)[0].tolist() for u in uniq_ids
            ]
        sim = t @ v.T
        out = recall_metrics(_ranks_with_multi_gt(sim, self._t2v_gt), "t2v-")
        out.update(recall_metrics(_ranks_with_multi_gt(sim.T, self._v2t_gt), "v2t-"))
        out["mean_recall"] = float(
            np.mean([out["t2v-r@1"], out["t2v-r@5"], out["t2v-r@10"],
                     out["v2t-r@1"], out["v2t-r@5"], out["v2t-r@10"]])
        )
        return out


class CaptioningEvaluator(BaseEvaluator):
    """Corpus BLEU-4 and mean ROUGE-L of generated against reference token
    ids: ``output["generated_ids"]`` against the batch's
    ``caption_raw_input_ids`` (else ``targets``), each stripped of the
    ``pad_ids`` (default 0, 101, 102). A batch without both is skipped (the
    trainer's forward generates nothing, as in the JAX package)."""

    def __init__(self, params: Optional[Mapping[str, Any]] = None):
        self.params = dict(params or {})
        self.pad_ids = set(self.params.get("pad_ids", [0, 101, 102]))
        self.reset()

    def reset(self) -> None:
        self._cands: List[List[int]] = []
        self._refs: List[List[int]] = []

    def _strip(self, seq) -> List[int]:
        return [int(t) for t in np.asarray(seq).reshape(-1) if int(t) not in self.pad_ids]

    def collect(self, batch: Mapping, output: Mapping) -> None:
        gen = output.get("generated_ids")
        ref = batch.get("caption_raw_input_ids", batch.get("targets"))
        if gen is None or ref is None:
            return
        for g, r in zip(np.asarray(gen), np.asarray(ref)):
            self._cands.append(self._strip(g))
            self._refs.append(self._strip(r))

    def summarize(self) -> Dict[str, float]:
        if not self._cands:
            return {}
        return {"bleu4": bleu4(self._cands, self._refs),
                "rouge_l": float(np.mean([rouge_l(c, r)
                                          for c, r in zip(self._cands, self._refs)]))}


EVALUATORS = {"global_retrieval_recall": GlobalRetrievalRecallEvaluator,
              "captioning": CaptioningEvaluator}
NOT_PORTED = ("classification", "vqa_accuracy", "grounding", "detection", "bbox_ap")


def build_evaluator(config: Optional[Mapping[str, Any]]) -> Optional[BaseEvaluator]:
    if not config:
        return None
    if isinstance(config, str):
        config = {"type": config}
    if config["type"] in NOT_PORTED:
        raise NotImplementedError(f"evaluator {config['type']!r} is not ported yet; "
                                  f"global_retrieval_recall is")
    cls = EVALUATORS.get(config["type"])
    if cls is None:
        raise KeyError(f"Unknown evaluator {config['type']!r}; known: {sorted(EVALUATORS)}")
    return cls(config.get("params", {}))
