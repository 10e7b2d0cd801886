"""RetrievalTrainer: corpus retrieval evaluation in stages.

Port of ``antmmf_tpu/trainers/retrieval_trainer.py``. ``evaluate_set``
encodes every text and video once (``encode_step``: the model's ``encode``
where it has one, the towers alone, else its forward without gradients),
then scores the corpus on the host:

* L1: text embeddings against the video embeddings, videos deduplicated by
  ``image_vid`` (several captions a video, min-rank over a video's
  captions), R@1/5/10, median and mean rank both ways and ``mean_recall``;
* L3 (models with WTI outputs, DMAE): the full WTI grid, chunked by texts
  on the host (``_wti_grid``), both ways and ``l3_simi_t2v-mean_recall``;
* stage 2 (``training_parameters.stage2_topk`` > 0 on a model with a
  cross-encoder): each text cross-encoded against its top-K L1 candidates
  (``np.argsort`` on the host, so ties break as in the JAX package), in
  chunks of ``stage2_chunk`` pairs on the device with an all-ones visual
  mask; non-candidates keep −1e30; L2 recalls both ways. The JAX package
  pads the tail chunk to a static shape; the port runs it as it is, with
  the same scores.

The sequence outputs that stage 2 reads stay on the device; the embeddings
and WTI components come to the host in fp32. The eval loss is not
computed here (the JAX trainer's ``evaluate_set`` has none either). Its
corpus scoring is not gathered over ranks yet: over several ranks it
raises (``base_trainer``'s ``global_retrieval_recall`` evaluator is).
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.loader import prefetch_to_device
from antmmf_torch.modules.metrics.evaluators import _ranks_with_multi_gt, recall_metrics
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.trainers.base_trainer import BaseTrainer

WTI_KEYS = ("wti_text_tokens", "wti_text_weights", "wti_video_tokens", "wti_video_weights",
            "wti_text_mask", "wti_video_mask")


@registry.register_trainer("retrieval_trainer")
class RetrievalTrainer(BaseTrainer):
    def compile_steps(self) -> None:
        if coll.get_world_size() > 1:
            raise NotImplementedError("retrieval_trainer over ranks: its corpus scoring is "
                                      "not gathered yet")
        super().compile_steps()
        module = self.shell.module
        encode = getattr(module, "encode", None)

        def encode_step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            with torch.inference_mode():
                out = encode(batch) if encode is not None else module(batch, deterministic=True)
            keep = ("text_embed", "visual_embed", "text_seq", "visual_tokens") + WTI_KEYS
            return {k: out[k] for k in keep if k in out}

        self._encode_step = encode_step
        self._rescore_step = None
        if getattr(getattr(module, "base", None), "with_cross_encoder", False):
            def rescore_step(state, tseq, tmask, vseq, vmask) -> torch.Tensor:
                with torch.inference_mode():
                    return module.base.cross_pair_scores(tseq, tmask, vseq, vmask)

            self._rescore_step = rescore_step

    # ------------------------------------------------------------------- eval
    def evaluate_set(self, dataset_type: str = "val") -> Dict[str, float]:
        loaders = self.task_loader.get_loaders(dataset_type)
        if not loaders:
            return {}
        texts: List[np.ndarray] = []
        videos: List[np.ndarray] = []
        vids: List[np.ndarray] = []
        text_seqs: List[torch.Tensor] = []
        text_masks: List[torch.Tensor] = []
        vis_tokens: List[torch.Tensor] = []
        wti: Dict[str, List[np.ndarray]] = {}
        batches = (b for b in itertools.chain(*loaders) if b.get_batch_size() > 0)
        for batch, arrays in prefetch_to_device(batches, lambda b: (b, self._to_device(b))):
            out = self._encode_step(self.state, arrays)
            texts.append(out["text_embed"].float().cpu().numpy())
            videos.append(out["visual_embed"].float().cpu().numpy())
            if "image_vid" in batch:
                vids.append(np.asarray(batch["image_vid"]).reshape(-1))
            if self._rescore_step is not None and "text_seq" in out:
                text_seqs.append(out["text_seq"])
                text_masks.append(arrays["caption_input_mask"])
                vis_tokens.append(out["visual_tokens"])
            for key in WTI_KEYS:
                if key in out:
                    wti.setdefault(key, []).append(out[key].float().cpu().numpy())
        if not texts:
            return {}
        t, v = np.concatenate(texts), np.concatenate(videos)
        if vids:
            all_vids = np.concatenate(vids)
            uniq, first_idx = np.unique(all_vids, return_index=True)
            v = v[first_idx]
            col_of = {int(u): c for c, u in enumerate(uniq)}
            t2v_gt = [[col_of[int(x)]] for x in all_vids]
            v2t_gt = [np.nonzero(all_vids == u)[0].tolist() for u in uniq]
            video_rows = first_idx
        else:
            n = min(len(t), len(v))
            t2v_gt = [[i] for i in range(n)]
            v2t_gt = [[i] for i in range(n)]
            video_rows = np.arange(len(v))
        sim = t @ v.T
        metrics = recall_metrics(_ranks_with_multi_gt(sim, t2v_gt), "l1_simi_t2v-")
        metrics.update(recall_metrics(_ranks_with_multi_gt(sim.T, v2t_gt), "l1_simi_v2t-"))
        metrics["mean_recall"] = float(np.mean([
            metrics[f"l1_simi_{d}-r@{k}"] for d in ("t2v", "v2t") for k in (1, 5, 10)]))

        topk = int(self.tp.get("stage2_topk", 0) or 0)
        if topk and self._rescore_step is not None and text_seqs:
            rows = torch.as_tensor(video_rows, device=vis_tokens[0].device)
            l2 = self._stage2_rescore(torch.cat(text_seqs), torch.cat(text_masks),
                                      torch.cat(vis_tokens)[rows], sim, topk)
            metrics.update(recall_metrics(_ranks_with_multi_gt(l2, t2v_gt), "l2_simi_t2v-"))
            metrics.update(recall_metrics(_ranks_with_multi_gt(l2.T, v2t_gt), "l2_simi_v2t-"))

        if wti:  # DMAE's L3 over the corpus (the monitored metric's family)
            l3 = self._wti_grid({k: np.concatenate(x) for k, x in wti.items()}, video_rows)
            metrics.update(recall_metrics(_ranks_with_multi_gt(l3, t2v_gt), "l3_simi_t2v-"))
            metrics.update(recall_metrics(_ranks_with_multi_gt(l3.T, v2t_gt), "l3_simi_v2t-"))
            metrics["l3_simi_t2v-mean_recall"] = float(np.mean([
                metrics[f"l3_simi_t2v-r@{k}"] for k in (1, 5, 10)]))
        return metrics

    @staticmethod
    def _wti_grid(w: Dict[str, np.ndarray], video_rows: np.ndarray,
                  chunk: int = 256) -> np.ndarray:
        """The corpus WTI grid [N, M] on the host, ``chunk`` texts at a time,
        masked as ``models.dmae.wti_similarity`` masks (zeroed, then the max)."""
        tt, tw, tm = w["wti_text_tokens"], w["wti_text_weights"], w["wti_text_mask"]
        vt, vw, vm = (w[k][video_rows] for k in ("wti_video_tokens", "wti_video_weights",
                                                  "wti_video_mask"))
        rows = []
        for s in range(0, tt.shape[0], chunk):
            sl = slice(s, s + chunk)
            c = np.einsum("tld,vmd->tvlm", tt[sl], vt)
            c = c * tm[sl][:, None, :, None] * vm[None, :, None, :]
            s_t2v = np.einsum("tvl,tl->tv", c.max(-1), tw[sl])
            s_v2t = np.einsum("tvm,vm->tv", c.max(-2), vw)
            rows.append(0.5 * (s_t2v + s_v2t))
        return np.concatenate(rows, axis=0)

    def _stage2_rescore(self, text_seq: torch.Tensor, text_mask: torch.Tensor,
                        vis_tokens: torch.Tensor, l1_sim: np.ndarray, topk: int) -> np.ndarray:
        """Each text's cross-encoder scores against its top-K L1 candidates,
        ``stage2_chunk`` pairs a call; −1e30 elsewhere, so re-ranking stays
        within the retrieved set. ``text_seq`` [N, Lt, C], ``text_mask``
        [N, Lt] and ``vis_tokens`` [M, F, Lv, C] lie on the device."""
        N, M = l1_sim.shape
        topk = min(topk, M)
        chunk = int(self.tp.get("stage2_chunk", 32))
        vis_seq = vis_tokens.reshape(M, -1, vis_tokens.shape[-1])
        vis_mask = torch.ones(vis_seq.shape[:2], dtype=torch.long, device=vis_seq.device)
        cand = np.argsort(-l1_sim, axis=1)[:, :topk]
        pair_t, pair_v = np.repeat(np.arange(N), topk), cand.reshape(-1)
        scores = np.full((N, M), -1e30, np.float32)
        dev = text_seq.device
        for start in range(0, len(pair_t), chunk):
            ti, vi = pair_t[start:start + chunk], pair_v[start:start + chunk]
            t_idx, v_idx = torch.as_tensor(ti, device=dev), torch.as_tensor(vi, device=dev)
            s = self._rescore_step(self.state, text_seq[t_idx], text_mask[t_idx],
                                   vis_seq[v_idx], vis_mask[v_idx])
            scores[ti, vi] = s.float().cpu().numpy()
        return scores
