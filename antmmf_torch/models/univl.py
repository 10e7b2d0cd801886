"""UniVL video-text retrieval: two towers plus the optional cross-encoder.

Port of ``antmmf_tpu/models/univl.py``: ``l2_normalize``, the
``UnivlVideoBase`` towers (frames fold into the batch for the ViT, then
frame → clip mean pooling) with the cross-encoder (text and visual streams
projected to one width, typed, concatenated and run through a post-LN
encoder with the pair's key-padding bias) and ``UnivlForVideoTextRetrieval``:
the clip-logsumexp similarity with the clamped fp32 ``logit_scale``, the
symmetric cross-entropy L1 loss, and with the cross-encoder the L2 loss,
either over in-step mined hard negatives (training, ``hard_mining_k`` > 1)
or over the full B×B pair grid. Outputs ``l1_simi``, ``sim``, ``text_embed``,
``visual_embed``, ``logits`` and ``losses`` (plus the L2 outputs).
``loss_type`` ``mil_nce`` (identity positives) and ``neg_nce`` (symmetric)
replace the L1 loss; ``with_queue`` replaces it with MoCo InfoNCE against
text and video queues held in buffers (``moco.MocoQueue``). ``dropout``
reaches the ViT, BERT and the cross-encoder as in JAX; a training forward
(``deterministic=False``) draws its masks from the ``generator`` it is
given (``layers.draws``). ``sequence_parallel`` (``ring`` or ``ulysses``)
reaches the ViT's attention and the cross-encoder's (their pair stream),
as in JAX; it engages under a registered mesh with a ``seq`` axis above 1.
``univl_auto`` dispatches on ``training_stage`` to the family's models.

Over ranks (``parallel.collectives``) the retrieval model computes the
global batch's losses, as the JAX model does under SPMD: the text and clip
embeddings are gathered with gradients (``gather_with_grad``, rank-major,
which is the global batch's order), so ``sim`` is the global [B, B]
matrix and the L1 loss the global one on every rank; each rank mines the
hard negatives of its own text rows among the global batch's columns and
cross-encodes them against the gathered visual sequences (the L2 loss of
its rows, whose mean over ranks is the global mean), or scores its rows of
the full grid, which is gathered for the symmetric loss; MoCo enqueues the
global batch's keys in order, so every rank's queue stays the same. The
trainer averages the gradients over ranks, which with the gathers'
reduce-scatter backward gives the global batch's gradient.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.modules.encoders.text_encoder import PRESETS as BERT_PRESETS, BertEncoder
from antmmf_torch.modules.layers import draws, make_attention_mask
from antmmf_torch.modules import moco
from antmmf_torch.modules.losses.contrastive import NEG_INF, mil_nce, neg_nce, symmetric_cross_en
from antmmf_torch.modules.transformers.base import TransformerEncoder
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer
from antmmf_torch.parallel import collectives as coll


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """x / (‖x‖ + eps) with an fp32 norm (the result promotes to fp32)."""
    return x / (torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True) + eps)


def clip_similarity(text_embed: torch.Tensor, clip_embed: torch.Tensor,
                    logit_scale: torch.Tensor) -> torch.Tensor:
    """[Bt, D] × [Bv, n_clips, D] → fp32 [Bt, Bv]: logsumexp over clips of
    the scaled cosines (the scale exp(logit_scale) clamped to [1, 100]),
    less log(n_clips)."""
    scale = torch.exp(torch.clamp(logit_scale, 0.0, math.log(100.0)))
    sims = torch.einsum("td,vcd->tvc", text_embed.float(), clip_embed.float())
    return torch.logsumexp(sims * scale, dim=-1) - math.log(float(sims.shape[-1]))


class UnivlVideoBase(nn.Module):
    """The two towers, their projections into the shared space and, with
    ``with_cross_encoder``, the L2 cross-encoder."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, with_cross_encoder: bool = False,
                 cross_layers: int = 2, dtype=torch.bfloat16, device=None,
                 cross_sim_head: bool = True, with_text: bool = True,
                 with_visual: bool = True, dropout: float = 0.0,
                 sequence_parallel: str = "none"):
        super().__init__()
        self.n_clips = n_clips
        vit_kw = VIT_PRESETS[vit_preset]
        # a model that never calls a tower (captioning the text tower, ROI
        # pretraining without its grid stream the ViT) has no parameters
        # for it in the JAX tree
        if with_visual:
            self.img_encoder = VisionTransformer(image_size=image_size,
                                                 token_merge_r=token_merge_r,
                                                 dtype=dtype, device=device, dropout=dropout,
                                                 sequence_parallel=sequence_parallel, **vit_kw)
        bert_kw = BERT_PRESETS[bert_preset]
        kw = dict(dtype=dtype, device=device)
        text_hidden, self.visual_hidden = bert_kw["hidden_size"], vit_kw["embed_dim"]
        self.vocab_size = bert_kw["vocab_size"]
        if with_text:
            self.text_encoder = BertEncoder(dtype=dtype, device=device, dropout=dropout,
                                            **bert_kw)
        if with_visual:
            self.img_fc = nn.Linear(self.visual_hidden, embed_dim, bias=False, **kw)
        if with_text:
            self.text_fc = nn.Linear(text_hidden, embed_dim, bias=False, **kw)
        self.with_cross_encoder = with_cross_encoder
        if with_cross_encoder:
            width = max(text_hidden, self.visual_hidden)
            self.cross_text_proj = nn.Linear(text_hidden, width, **kw)
            self.cross_visual_proj = nn.Linear(self.visual_hidden, width, **kw)
            self.cross_type_embed = nn.Embedding(2, width, **kw)
            self.cross_encoder = TransformerEncoder(
                width, cross_layers, max(1, width // 64), norm_style="post",
                final_norm=False, dtype=dtype, device=device, dropout=dropout,
                sequence_parallel=sequence_parallel)
            self.cross_pooler = nn.Linear(width, width, **kw)
            if cross_sim_head:
                # the trained L2 match score, computed in fp32 (flax creates
                # it only in a model that scores pairs)
                self.cross_sim_head = nn.Linear(width, 1, dtype=torch.float32, device=device)

    def forward_img_encoder(self, image_data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image_data float[B, F, H, W, 3] → clip_embed [B, n_clips, D], the
        per-frame pooled features and the visual tokens [B, F, N, C]."""
        B, F = image_data.shape[:2]
        if F % self.n_clips:
            raise ValueError(f"{F} frames do not split into {self.n_clips} clips")
        enc = self.img_encoder(image_data.reshape((B * F,) + image_data.shape[2:]))
        pooled = enc["pooled"].reshape(B, F, -1)
        clip_feat = pooled.reshape(B, self.n_clips, F // self.n_clips, -1).mean(dim=2)
        seq = enc["sequence"]
        return {"clip_embed": l2_normalize(self.img_fc(clip_feat)), "frame_pooled": pooled,
                "visual_tokens": seq.reshape(B, F, seq.shape[1], -1)}

    def forward_text_encoder(self, input_ids: torch.Tensor, input_mask: torch.Tensor,
                             segment_ids: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        enc = self.text_encoder(input_ids, input_mask, segment_ids)
        return {"text_embed": l2_normalize(self.text_fc(enc["pooled_output"])),
                "sequence_output": enc["sequence_output"],
                "pooled_output": enc["pooled_output"]}

    def forward_cross_encoder(self, text_seq: torch.Tensor, text_mask: torch.Tensor,
                              visual_seq: torch.Tensor, visual_mask: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
        """Type-embedded text [P, Lt, Ct] and visual [P, Lv, Cv] streams,
        concatenated, through the shared encoder under their key bias."""
        t = self.cross_text_proj(text_seq) + self.cross_type_embed(
            torch.zeros(text_seq.shape[:2], dtype=torch.long, device=text_seq.device))
        v = self.cross_visual_proj(visual_seq) + self.cross_type_embed(
            torch.ones(visual_seq.shape[:2], dtype=torch.long, device=visual_seq.device))
        mask = torch.cat([text_mask, visual_mask.to(text_mask.dtype)], dim=1)
        seq = self.cross_encoder(torch.cat([t, v], dim=1), make_attention_mask(mask))
        pooled = torch.tanh(self.cross_pooler(seq[:, 0]))
        return {"cross_sequence": seq, "cross_pooled": pooled, "cross_mask": mask}

    def cross_pair_scores(self, text_seq: torch.Tensor, text_mask: torch.Tensor,
                          visual_seq: torch.Tensor, visual_mask: torch.Tensor) -> torch.Tensor:
        """The trained L2 match score of each (text, video) pair → f32[P]."""
        cross = self.forward_cross_encoder(text_seq, text_mask, visual_seq, visual_mask)
        return self.cross_sim_head(cross["cross_pooled"].float())[..., 0]


def config_keys(cls) -> set:
    """The keyword arguments a model class takes: those of its ``__init__``
    and, while an ``__init__`` passes ``**kw`` on, of its bases' (the JAX
    ``from_config`` takes the dataclass fields, inherited ones included)."""
    names = set()
    for klass in cls.__mro__:
        init = vars(klass).get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters.values()
        names |= {p.name for p in params if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
        if not any(p.kind is p.VAR_KEYWORD for p in params):
            break
    return names - {"self", "device"}


# ``training_stage`` → model (``antmmf_tpu/models/univl.py:209-238``)
STAGES = {"pretraining": "univl_pretrain", "pretrain": "univl_pretrain",
          "retrieval": "univl_retrieval", "classification": "univl_classification",
          "mcqa": "univl_mcqa", "caption": "univl_caption", "generation": "univl_caption",
          "roi": "univl_roi"}


def univl_dispatch(config: Mapping[str, Any], device=None) -> nn.Module:
    """The reference's ``Univl`` model dispatches on its task config:
    ``training_stage`` (default ``retrieval``) picks the family, built from
    the rest of the config. An unknown stage is a ``KeyError``, as in JAX."""
    config = dict(config or {})
    stage = config.pop("training_stage", "retrieval")
    name = STAGES.get(stage)
    if name is None:
        raise KeyError(f"Unknown univl training_stage {stage!r}")
    return registry.get_model_class(name).from_config(config, device=device)


@registry.register_model("univl_auto")
class UnivlDispatch:
    """Config-dispatched UniVL entry point (see ``univl_dispatch``)."""

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> nn.Module:
        return univl_dispatch(config, device)


@registry.register_model("univl_retrieval")
@registry.register_model("univl")
class UnivlForVideoTextRetrieval(nn.Module):
    """Two-tower (L1) retrieval with the optional L2 cross-encoder.

    ``from_config`` takes the JAX model's ``model_attributes``; keys that
    change neither the forward nor the loss here (remat, use_pallas,
    scan_layers, ...) are ignored, as the JAX ``from_config`` ignores unknown
    keys. ``forward(batch, deterministic)`` follows the JAX ``__call__``:
    with ``deterministic=False`` and ``hard_mining_k`` > 1 the L2 loss runs
    over mined pairs, otherwise over the full pair grid.

    With ``with_queue`` the keys (``_moco_key_text``/``_moco_key_video`` of
    the batch, which the trainer fills from its momentum towers, else the
    online embeddings) are enqueued only by ``flush_queues``, which the
    train step calls after the backward: the loss's backward reads the
    queues, so they must not change before it. A forward with
    ``deterministic=False`` leaves its keys pending for that call.
    ``global_batch_over_ranks``: its losses gather what the global batch
    needs, so the trainer may run it over ranks."""

    global_batch_over_ranks = True

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, init_logit_scale: float = 2.6592,
                 dtype_str: str = "bfloat16", with_cross_encoder: bool = False,
                 cross_layers: int = 2, hard_mining_k: int = 0, loss_type: str = "cross_en",
                 neg_nce_margin: float = 0.0, neg_nce_weight: float = 1.0,
                 with_queue: bool = False, queue_size: int = 4096, with_momentum: bool = False,
                 momentum: float = 0.999, dropout: float = 0.0,
                 training_head_only: bool = False, sequence_parallel: str = "none",
                 encoder_lr_decay: float = 1.0, device=None):
        super().__init__()
        if loss_type not in ("cross_en", "mil_nce", "neg_nce"):
            raise ValueError(f"loss_type {loss_type!r}: cross_en, mil_nce or neg_nce")
        self.dtype = getattr(torch, dtype_str)
        self.hard_mining_k = hard_mining_k
        self.loss_type = loss_type
        self.neg_nce_margin, self.neg_nce_weight = neg_nce_margin, neg_nce_weight
        self.with_queue, self.with_momentum, self.momentum = with_queue, with_momentum, momentum
        self.encoder_lr_decay = encoder_lr_decay
        self.training_head_only = training_head_only
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   token_merge_r, with_cross_encoder, cross_layers,
                                   self.dtype, device, dropout=dropout,
                                   sequence_parallel=sequence_parallel)
        self.logit_scale = nn.Parameter(
            torch.tensor(init_logit_scale, dtype=torch.float32, device=device))
        if with_queue:
            # random rows (filled from the first step) with momentum towers,
            # as the JAX model draws them with PRNGKey 1 and 2
            self.text_queue = moco.MocoQueue(queue_size, embed_dim, with_momentum, 1, device)
            self.video_queue = moco.MocoQueue(queue_size, embed_dim, with_momentum, 2, device)
        self._pending_keys = None

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "UnivlForVideoTextRetrieval":
        names = config_keys(cls)
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def optimizer_lr_multipliers(self, tp: Mapping[str, Any]):
        """The pretrained towers train at ``encoder_lr_decay`` × lr (the model
        field, else ``training_parameters.encoder_lr_decay``; default 1.0,
        no rule), as the JAX model's hook gives ``BaseTrainer.load_optimizer``."""
        decay = float(self.encoder_lr_decay if self.encoder_lr_decay != 1.0
                      else tp.get("encoder_lr_decay", 1.0) or 1.0)
        return [] if decay == 1.0 else [[r"base/(img_encoder|text_encoder)/", decay]]

    @staticmethod
    def moco_keys(base: UnivlVideoBase, batch: Mapping[str, torch.Tensor]):
        """The MoCo keys of ``base`` (the trainer's momentum towers):
        (``text_embed``, ``clip_embed`` averaged over clips)."""
        text = base.forward_text_encoder(batch["caption_input_ids"],
                                         batch["caption_input_mask"],
                                         batch.get("caption_segment_ids"))
        return text["text_embed"], base.forward_img_encoder(batch["image_data"])[
            "clip_embed"].mean(dim=1)

    def encode(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The towers alone, for corpus evaluation: ``text_embed``,
        ``visual_embed`` and, with the cross-encoder, ``text_seq`` and
        ``visual_tokens``, as the forward gives them."""
        text = self.base.forward_text_encoder(batch["caption_input_ids"],
                                              batch["caption_input_mask"],
                                              batch.get("caption_segment_ids"))
        video = self.base.forward_img_encoder(batch["image_data"])
        out = {"text_embed": text["text_embed"], "visual_embed": video["clip_embed"].mean(dim=1)}
        if self.base.with_cross_encoder:
            out.update(text_seq=text["sequence_output"], visual_tokens=video["visual_tokens"])
        return out

    def forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        with draws(generator, active=not deterministic):
            return self._forward(batch, deterministic)

    def _forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool) -> Dict[str, Any]:
        text = self.base.forward_text_encoder(batch["caption_input_ids"],
                                              batch["caption_input_mask"],
                                              batch.get("caption_segment_ids"))
        video = self.base.forward_img_encoder(batch["image_data"])
        text_embed, clip_embed = text["text_embed"], video["clip_embed"]
        if self.training_head_only:
            text_embed, clip_embed = text_embed.detach(), clip_embed.detach()
        # over ranks: the global batch's rows, rank-major (identity in one process)
        sim = clip_similarity(coll.gather_with_grad(text_embed),
                              coll.gather_with_grad(clip_embed), self.logit_scale)
        output: Dict[str, Any] = {"l1_simi": sim, "sim": sim, "text_embed": text_embed,
                                  "visual_embed": clip_embed.mean(dim=1), "logits": sim}
        if self.with_queue:
            level1 = self._moco_loss(batch, text_embed, clip_embed, deterministic)
        elif self.loss_type == "mil_nce":
            eye = torch.eye(sim.shape[0], sim.shape[1], device=sim.device)
            level1 = 0.5 * (mil_nce(sim, eye) + mil_nce(sim.T, eye.T))
        elif self.loss_type == "neg_nce":
            level1 = 0.5 * (neg_nce(sim, self.neg_nce_margin, self.neg_nce_weight)
                            + neg_nce(sim.T, self.neg_nce_margin, self.neg_nce_weight))
        else:
            level1 = symmetric_cross_en(sim)
        losses = {"level1_similarity_loss": level1}
        if self.base.with_cross_encoder:
            self._level2(batch, text, video, sim, deterministic, output, losses)
        output["losses"] = losses
        return output

    def _moco_loss(self, batch, text_embed, clip_embed, deterministic) -> torch.Tensor:
        """MoCo InfoNCE both ways (``univl.py:415-443`` of the JAX package):
        each query against its positive key (column 0) and the other
        modality's queue, unfilled slots masked; the video key and query are
        the clip mean, not re-normalised."""
        scale = torch.exp(torch.clamp(self.logit_scale, 0.0, math.log(100.0)))
        v_mean = clip_embed.mean(dim=1)
        key_text, key_video = batch.get("_moco_key_text"), batch.get("_moco_key_video")
        key_text = (text_embed if key_text is None else key_text).detach().float()
        key_video = (v_mean if key_video is None else key_video).detach().float()

        def infonce(q, k_pos, queue: moco.MocoQueue):
            negs, valid = moco.queue_negatives(queue.state())
            q = q.float()
            pos = (q * k_pos).sum(-1, keepdim=True) * scale
            neg = torch.where(valid[None, :], (q @ negs.T) * scale, NEG_INF)
            return -torch.log_softmax(torch.cat([pos, neg], dim=1), dim=-1)[:, 0].mean()

        loss = 0.5 * (infonce(text_embed, key_video, self.video_queue)
                      + infonce(v_mean, key_text, self.text_queue))
        if not deterministic:
            # the global batch's keys, in its order, on every rank
            self._pending_keys = (coll.all_gather(key_text), coll.all_gather(key_video))
        return loss

    def flush_queues(self) -> None:
        """Enqueue the keys of the last training forward (after its backward)."""
        if self._pending_keys is not None:
            key_text, key_video = self._pending_keys
            moco.enqueue(self.text_queue.state(), key_text)
            moco.enqueue(self.video_queue.state(), key_video)
            self._pending_keys = None

    def _level2(self, batch, text, video, sim, deterministic, output, losses) -> None:
        """The L2 loss (``univl.py:458-505`` of the JAX package)."""
        text_seq, text_mask = text["sequence_output"], batch["caption_input_mask"]
        B = text_seq.shape[0]
        vis_tokens = video["visual_tokens"]  # [B, F, Lv, C]
        F, Lv = vis_tokens.shape[1], vis_tokens.shape[2]
        vis_seq = vis_tokens.reshape(B, F * Lv, -1)
        video_mask = batch.get("video_mask")
        if video_mask is None:
            video_mask = torch.ones(B, F, dtype=torch.long, device=vis_seq.device)
        vis_mask = video_mask.repeat_interleave(Lv, dim=1)
        # over ranks: this rank's text rows against the global batch's videos
        vis_all = coll.gather_with_grad(vis_seq)
        vis_mask_all = coll.all_gather(vis_mask)
        G = vis_all.shape[0]
        row0 = coll.batch_index() * B
        rows = torch.arange(B, device=sim.device) + row0
        k = min(self.hard_mining_k, G) if self.hard_mining_k > 0 else 0
        if not deterministic and k > 1:
            # each text row meets its positive and its k-1 hardest L1
            # negatives (stop-gradient sims, the positive excluded)
            eye = torch.nn.functional.one_hot(rows, G).float()
            masked = sim[row0:row0 + B].detach() + eye * torch.finfo(torch.float32).min
            hard_idx = torch.topk(masked, k - 1, dim=-1).indices
            cols = torch.cat([rows[:, None], hard_idx], dim=1)
            flat = cols.reshape(-1)
            scores = self.base.cross_pair_scores(
                text_seq.repeat_interleave(k, dim=0), text_mask.repeat_interleave(k, dim=0),
                vis_all[flat], vis_mask_all[flat]).reshape(B, k)
            # the positive sits in column 0 of each mined row
            losses["level2_similarity_loss"] = -torch.log_softmax(scores, dim=-1)[:, 0].mean()
            output["l2_pair_scores"] = scores
            output["l2_pair_cols"] = cols
        else:
            # the full grid, pair (i, j) at i·G + j; this rank's rows, gathered
            l2 = self.base.cross_pair_scores(
                text_seq.repeat_interleave(G, dim=0), text_mask.repeat_interleave(G, dim=0),
                vis_all.repeat(B, 1, 1), vis_mask_all.repeat(B, 1)).reshape(B, G)
            l2 = coll.gather_with_grad(l2)
            output["l2_simi"] = l2
            losses["level2_similarity_loss"] = symmetric_cross_en(l2)
        output["text_seq"] = text_seq
        output["visual_tokens"] = vis_tokens
