"""M2-omni: an omni-modal LLM, image, video, audio and text in, text out.

Port of ``antmmf_tpu/models/m2_omni.py``. A visual tower (``visual_tower:
qwen2``, Qwen2-ViT through ``vision_proj_{i}`` and an L2 normalisation; or
``vit``, the CLIP-style ViT without its class token through
``vision_proj``), an audio tower (``audio_tower: conv``, ``AudioEncoder``
through ``audio_proj``; or ``sanm``, the SANM encoder, frames compressed by
``audio_compress``, ``audio_proj_{i}`` and an L2 normalisation; the
``_{i}`` projections are ``mlp_depths`` Linears with exact GELU between)
and a decoder LM with 3D mRoPE (``rope_3d``). Two layouts:

* spliced (``image_token_id``/``audio_token_id``/``video_token_id`` set):
  the modal tokens replace the placeholder ids in place, the k-th
  placeholder of a row taking the k-th modal token (clipped to the last:
  a run longer than the tower's output repeats its last token, as in the
  JAX package), and ``get_rope_index`` gives every slot its (t, h, w)
  position: text advances one, a placeholder run takes its grid positions
  from the run's base, and the slot after it resumes at the base + the
  run's largest coordinate + 1. In a row with a video, image runs keep text
  positions unless ``mixed_vision_grid_positions`` (the reference's quirk,
  kept by default);
* prefix: [vision][audio][text] segments, the text at positions after them.

``get_rope_index`` is the JAX package's closed form in int64 (a segmented
running max from run ids times a bound above the coordinates), where JAX's
int32 form overflows past 32,767 runs. Modal tokens are cast to the
embedding dtype at the splice; logits are fp32. ``forward`` gives the
logits, the hidden states and, with ``labels``, ``lm_loss``/``lm_acc`` (over
the vocabulary in chunks, ``_lm_loss_chunked``, when the [B, L, V] logits
would pass 2²⁸ entries). ``prefill`` writes the KV cache and returns the
next RoPE position (the largest valid position + 1), which is not the next
cache slot; ``generate`` decodes token t at RoPE position ``next_p + t``
into slot ``lens_full + t``: greedily, by beam search (a beam's RoPE
position is ``nf + (slot - sf)``, its row's next position and first free
slot repeated over the beams), by nucleus sampling (drawn at the RoPE
position) or by prompt-lookup speculation (chunks at ``next_p + off`` and
``lens_full + off``, the cache ``max_new + gamma + 1`` slots past the
prompt), as ``models/pink.py``'s ``generate`` does. ``decode_chunk`` and
``extend_cache`` append a text turn or prompt chunk at ``rope0 + k`` on
all three axes from cache slot ``slot0`` (the serving engine's sessions,
prefixes and chunked admission). The cache is the port's list of
per-layer tensors, int8 under ``kv_int8`` (``modules/llm.py``).

``recipe_opts`` lays the LoRA finetune of the JAX package's bench leg over
``m2_omni_7b.yml`` for one card: adapters on the decoder's seven
projections and on Qwen2-ViT's blocks; only they, ``vision_proj`` and
``audio_proj`` train (``frozen_params``).

The conv tower's ``proj`` reads fbank frames of ``AUDIO_FEATURES`` (80
mels × LFR 7 = 560, the audio processor's), which flax infers from the
first batch and the port builds with. ``max_vision_tokens`` is accepted
and unused, as in JAX.
Beams, sampling, speculative decoding, ``sequence_parallel`` and the
predictor's ``decode_quant`` (``DECODE_QUANT`` is empty) raise
until they are ported.
"""

from __future__ import annotations

import functools
import inspect
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from antmmf_torch.common.registry import registry
from antmmf_torch.models.pink import LM_PRESETS
from antmmf_torch.modules.encoders.sanm_audio import build_sanm_encoder, compress_audio_tokens
from antmmf_torch.modules.llm import DecoderLM
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.modules.transformers.base import TransformerEncoder
from antmmf_torch.modules.vision.qwen2_vit import build_qwen2_vit
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer
from antmmf_torch.utils.speculative import speculative_greedy
from antmmf_torch.utils.text_utils import beam_search_cached, nucleus_sampling_cached


AUDIO_FEATURES = 80 * 7  # the fbank width: 80 mels stacked 7 frames deep
# the parameters the LoRA finetune trains (``bench_llm_train.py``'s m2omni
# leg: its ``is_trainable``): every flax path without one of these freezes
LORA_TRAINABLE = ("lora", "vision_proj", "audio_proj")


def recipe_opts(**model: Any) -> List[str]:
    """The opts that lay the LoRA finetune over ``m2_omni_7b.yml`` (pass
    them to ``build_config`` with that file): LoRA of rank 8 on all
    seven decoder projections and on every Qwen2-ViT block, a
    ``frozen_params`` that leaves only ``LORA_TRAINABLE`` to train, one
    device; the yml's remat, scan_layers, AdamW (lr 2e-5, a bf16 first
    moment) and accumulation over 2 micro-batches stay. ``model``'s keys of
    ``model_attributes.m2_omni`` go on top (presets, dtype)."""
    m = "model_attributes.m2_omni"
    frozen = [f"^(?!.*({'|'.join(LORA_TRAINABLE)}))"]
    opts = [f"{m}.llm_lora_rank", "8", f"{m}.llm_lora_targets", "all",
            f"{m}.vit_lora_rank", "8", "optimizer_attributes.frozen_params", json.dumps(frozen),
            "training_parameters.mesh.data", "1", "training_parameters.mesh.fsdp", "1"]
    for key, value in model.items():
        opts += [f"{m}.{key}", str(value)]
    return opts


def audio_token_count(audio_tower: str, audio_compress: int, max_frames: int) -> int:
    """The audio tokens a tower gives for ``max_frames`` fbank frames: the
    conv tower halves them twice (rounding up), SANM compresses them."""
    if audio_tower == "sanm":
        return max_frames // audio_compress
    return _halved_twice(max_frames)


def _halved_twice(n: int) -> int:
    """The length after two stride-2 convolutions with SAME padding."""
    half = -(-n // 2)
    return -(-half // 2)


def _same_pad(n: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """flax's ``SAME`` padding of one dimension: (lo, hi) with the odd one
    at the end, so a 3×3 stride-2 convolution pads an even size (0, 1)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class AudioEncoder(nn.Module):
    """fbank [B, T, F] → [B, ⌈⌈T/2⌉/2⌉, hidden]: two 3×3 stride-2
    convolutions with ReLU (``subsample0`` to hidden/2 channels,
    ``subsample1`` to hidden, flax's SAME padding), the (frequency, channel)
    features flattened through ``proj``, then a pre-LN transformer of
    ``num_layers`` layers (tanh GELU, final LayerNorm) whose attention runs
    the small-attention kernel."""

    def __init__(self, hidden: int = 256, num_layers: int = 4, num_heads: int = 4,
                 feature_dim: int = AUDIO_FEATURES, dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.subsample0 = nn.Conv2d(1, hidden // 2, 3, stride=2, **kw)
        self.subsample1 = nn.Conv2d(hidden // 2, hidden, 3, stride=2, **kw)
        self.proj = nn.Linear(_halved_twice(feature_dim) * hidden, hidden, **kw)
        self.encoder = TransformerEncoder(hidden, num_layers, num_heads, **kw)

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        x = fbank.to(self.dtype)[:, None]  # [B, 1, T, F]
        for conv in (self.subsample0, self.subsample1):
            (t0, t1), (f0, f1) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = torch.relu(conv(F.pad(x, (f0, f1, t0, t1))))
        B, C, T, Fq = x.shape
        return self.encoder(self.proj(x.permute(0, 2, 3, 1).reshape(B, T, Fq * C)))


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) over the last dim in fp32, cast back."""
    xf = x.float()
    return (xf / torch.linalg.vector_norm(xf, dim=-1, keepdim=True).clamp(min=1e-12)).to(x.dtype)


def _gather_tokens(tokens: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tokens [B, Lm, C] at indices k int[B, L] → [B, L, C]."""
    return torch.gather(tokens, 1, k[..., None].expand(-1, -1, tokens.shape[-1]))


@registry.register_model("m2_omni")
class M2Omni(nn.Module):
    DECODE_QUANT = ("int4", "int8")  # the predictor's decode_quant modes this model serves

    def __init__(self, lm_preset: str = "omni_1b", visual_tower: str = "vit",
                 vit_preset: str = "vit_base_patch32", qwen2_preset: str = "qwen2_vit",
                 image_size: int = 224, audio_tower: str = "conv",
                 sanm_preset: str = "bailing2_audio", audio_compress: int = 3,
                 mlp_depths: int = 1, audio_hidden: int = 256, max_vision_tokens: int = 256,
                 image_token_id: Optional[int] = None, audio_token_id: Optional[int] = None,
                 video_token_id: Optional[int] = None,
                 mixed_vision_grid_positions: bool = False, llm_lora_rank: int = 0,
                 llm_lora_targets: str = "qv", vit_lora_rank: int = 0, remat: bool = False,
                 scan_layers: bool = False, sequence_parallel: str = "none",
                 rope_3d: bool = True, dtype_str: str = "bfloat16", kv_int8: bool = False,
                 device=None):
        super().__init__()
        if sequence_parallel != "none":
            raise NotImplementedError(f"m2_omni sequence_parallel={sequence_parallel!r} is not "
                                      f"ported yet; only 'none' is")
        self.kv_int8 = bool(kv_int8)
        if llm_lora_targets not in ("qv", "all"):
            raise ValueError(f"llm_lora_targets must be 'qv' or 'all', got {llm_lora_targets!r}")
        self.dtype = getattr(torch, dtype_str)
        p = LM_PRESETS[lm_preset]
        self.hidden, self.vocab_size = p["hidden"], p["vocab_size"]
        self.visual_tower, self.audio_tower = visual_tower, audio_tower
        self.audio_compress = audio_compress
        self.image_token_id, self.audio_token_id = image_token_id, audio_token_id
        self.video_token_id = video_token_id
        self.mixed_vision_grid_positions = mixed_vision_grid_positions
        kw = dict(dtype=self.dtype, device=device)
        all_tgt = llm_lora_targets == "all"
        self.token_embed = nn.Embedding(self.vocab_size, self.hidden, **kw)
        self.decoder = DecoderLM(
            self.hidden, p["num_layers"], p["num_heads"], p["num_kv_heads"],
            lora_rank=llm_lora_rank,
            lora_targets=("q", "k", "v", "o") if all_tgt else ("q", "v"), lora_mlp=all_tgt,
            remat=remat, scan_layers=scan_layers, rope_3d=rope_3d, **kw)
        if visual_tower == "qwen2":
            self.vision_tower = build_qwen2_vit(qwen2_preset, image_size=image_size,
                                                lora_rank=vit_lora_rank, remat=remat, **kw)
            width = self.vision_tower.merger_fc2.out_features
            self.vision_proj_names = self._mlp("vision_proj", width, mlp_depths, kw)
        elif visual_tower == "vit":
            self.vision_tower = VisionTransformer(image_size=image_size, remat=remat,
                                                  **VIT_PRESETS[vit_preset], **kw)
            self.vision_proj = nn.Linear(VIT_PRESETS[vit_preset]["embed_dim"], self.hidden,
                                         **kw)
        else:
            raise ValueError(f"visual_tower must be 'vit' or 'qwen2', got {visual_tower!r}")
        if audio_tower == "sanm":
            self.audio_encoder = build_sanm_encoder(sanm_preset, **kw)
            width = self.audio_encoder.output_size * audio_compress
            self.audio_proj_names = self._mlp("audio_proj", width, mlp_depths, kw)
        elif audio_tower == "conv":
            self.audio_encoder = AudioEncoder(audio_hidden, **kw)
            self.audio_proj = nn.Linear(audio_hidden, self.hidden, **kw)
        else:
            raise ValueError(f"audio_tower must be 'conv' or 'sanm', got {audio_tower!r}")
        self.lm_head = QuantDense(self.hidden, self.vocab_size, **kw)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "M2Omni":
        """From the JAX model's ``model_attributes``; keys the constructor does
        not take are ignored, as the JAX ``from_config`` ignores them."""
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def _mlp(self, prefix: str, width: int, depth: int, kw) -> list:
        """``prefix_{i}`` Linears: width → hidden, then hidden → hidden."""
        names = []
        for i in range(depth):
            self.add_module(f"{prefix}_{i}", nn.Linear(width if i == 0 else self.hidden,
                                                       self.hidden, **kw))
            names.append(f"{prefix}_{i}")
        return names

    def _run_mlp(self, names, x: torch.Tensor) -> torch.Tensor:
        for i, name in enumerate(names):
            if i:
                x = F.gelu(x)
            x = getattr(self, name)(x)
        return x

    @property
    def spliced(self) -> bool:
        return (self.image_token_id is not None or self.audio_token_id is not None
                or self.video_token_id is not None)

    # ------------------------------------------------------------- the towers
    def _audio_tokens(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """fbank ``audio`` [B, T, F] (the SANM tower also reads ``audio_mask``)
        → LM-space audio tokens [B, Ta, hidden]."""
        feats = batch["audio"]
        if self.audio_tower == "sanm":
            enc = self.audio_encoder(feats, batch.get("audio_mask"))
            x = compress_audio_tokens(enc, self.audio_compress)
            return _l2_normalize(self._run_mlp(self.audio_proj_names, x))
        return self.audio_proj(self.audio_encoder(feats))

    def _vision_tokens(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, F, H, W, 3] → (tokens [B, L, hidden], (t, h, w) grid
        positions int[B, L, 3])."""
        B, Fr = images.shape[:2]
        dev = images.device
        if self.visual_tower == "qwen2":
            out = self.vision_tower(images)
            tokens = _l2_normalize(self._run_mlp(self.vision_proj_names, out["sequence"]))
            t, gh, gw = out["grid_thw"]
        else:
            flat = images.reshape((B * Fr,) + tuple(images.shape[2:]))
            seq = self.vision_tower(flat)["sequence"][:, 1:]  # the class token dropped
            N = seq.shape[1]
            t, gh = Fr, int(N ** 0.5)
            gw = gh
            tokens = self.vision_proj(seq).reshape(B, Fr * N, self.hidden)
        t_pos = torch.arange(t, device=dev).repeat_interleave(gh * gw)
        h_pos = torch.arange(gh, device=dev).repeat_interleave(gw).repeat(t)
        w_pos = torch.arange(gw, device=dev).repeat(gh * t)
        pos = torch.stack([t_pos, h_pos, w_pos], dim=-1)
        return tokens, pos[None].expand(B, -1, -1)

    def _encode_visual_streams(self, data) -> Tuple[torch.Tensor, torch.Tensor]:
        """One visual stream [B, F, H, W, 3] (or [B, H, W, 3]) or a list of
        them, each encoded alone and concatenated in order; each stream's
        grid positions start at (0, 0, 0)."""
        streams = data if isinstance(data, (tuple, list)) else (data,)
        toks, poss = [], []
        for img in streams:
            t, p = self._vision_tokens(img[:, None] if img.dim() == 4 else img)
            toks.append(t)
            poss.append(p)
        return torch.cat(toks, 1), torch.cat(poss, 1)

    # -------------------------------------------------- the splice and RoPE
    @staticmethod
    def _splice_embeds(text_embeds: torch.Tensor, input_ids: torch.Tensor, token_id: int,
                       modal_tokens: torch.Tensor) -> torch.Tensor:
        """The k-th placeholder slot of each row takes ``modal_tokens[:, k]``,
        k clipped to the last modal token."""
        mask = input_ids == token_id
        k = (mask.long().cumsum(1) - 1).clamp(0, modal_tokens.shape[1] - 1)
        return torch.where(mask[..., None], _gather_tokens(modal_tokens, k), text_embeds)

    @staticmethod
    def _modal_rel_positions(mask: torch.Tensor, modal_pos: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(each placeholder slot's ``modal_pos`` minus the one at its run's
        start int[B, L, 3], 0 off the runs; run starts bool[B, L])."""
        B = mask.shape[0]
        k = (mask.long().cumsum(1) - 1).clamp(0, modal_pos.shape[1] - 1)
        prev = torch.cat([mask.new_zeros(B, 1), mask[:, :-1]], 1)
        run_start = mask & ~prev
        k_start = torch.cummax(torch.where(run_start, k, -1), 1).values.clamp(min=0)
        rel = _gather_tokens(modal_pos, k) - _gather_tokens(modal_pos, k_start)
        return torch.where(mask[..., None], rel, 0), run_start

    @staticmethod
    def get_rope_index(modal_mask: torch.Tensor, run_start: torch.Tensor, rel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``get_rope_index`` in closed form, int64: (positions
        int[B, L, 3], the base after the last slot int[B]). A slot's base
        advances 1 at text slots and the run's largest relative coordinate
        + 1 at a run's last slot; that largest coordinate is a running max
        reset at each run start, built as cummax(value + run id · K) − run
        id · K with K above every coordinate, so earlier runs never win."""
        B, L = modal_mask.shape
        is_m = modal_mask
        rel = rel.long()
        value = torch.where(is_m, rel.max(-1).values, -1)
        rid = run_start.long().cumsum(1)
        none = is_m.new_zeros(B, 1)
        nxt_start = torch.cat([run_start[:, 1:], none], 1)
        nxt_mask = torch.cat([is_m[:, 1:], none], 1)
        run_end = is_m & (nxt_start | ~nxt_mask)
        K = value.max() + 2
        run_max = torch.cummax(value + rid * K, 1).values - rid * K
        inc = torch.where(is_m, 0, 1) + torch.where(run_end, run_max + 1, 0)
        after = inc.cumsum(1)
        base_excl = after - inc
        idx = torch.arange(L, device=is_m.device)[None].expand(B, L)
        start_idx = torch.cummax(torch.where(run_start, idx, -1), 1).values.clamp(min=0)
        run_base = torch.gather(base_excl, 1, start_idx)
        pos = torch.where(is_m[..., None], run_base[..., None] + rel, base_excl[..., None])
        return pos, after[:, -1]

    def _assemble_spliced(self, batch: Mapping[str, Any], input_ids: torch.Tensor):
        """(embeds [B, L, C], positions int[B, L, 3], next base int[B]) of the
        spliced layout."""
        B, L = input_ids.shape
        embeds = self.token_embed(input_ids)
        modal_mask = torch.zeros(B, L, dtype=torch.bool, device=input_ids.device)
        run_start = torch.zeros_like(modal_mask)
        rel = torch.zeros(B, L, 3, dtype=torch.long, device=input_ids.device)

        def add(token_id, tokens, pos):
            nonlocal embeds, modal_mask, run_start, rel
            embeds = self._splice_embeds(embeds, input_ids, token_id, tokens.to(embeds.dtype))
            if pos is None:
                return
            m = input_ids == token_id
            r, rs = self._modal_rel_positions(m, pos)
            modal_mask, run_start, rel = modal_mask | m, run_start | rs, rel + r

        has_video = self.video_token_id is not None and batch.get("video_data") is not None
        if self.image_token_id is not None and batch.get("image_data") is not None:
            vtok, vpos = self._encode_visual_streams(batch["image_data"])
            # the reference's quirk: in a row with a video, image runs keep
            # sequential text positions
            add(self.image_token_id, vtok,
                vpos if not has_video or self.mixed_vision_grid_positions else None)
        if has_video:
            add(self.video_token_id, *self._encode_visual_streams(batch["video_data"]))
        if self.audio_token_id is not None and batch.get("audio") is not None:
            atok = self._audio_tokens(batch)
            apos = torch.arange(atok.shape[1], device=atok.device)[None, :, None]
            add(self.audio_token_id, atok, apos.expand(B, -1, 3))
        positions, next_base = self.get_rope_index(modal_mask, run_start, rel)
        return embeds, positions, next_base

    def _assemble_prefix(self, batch: Mapping[str, Any], input_ids: torch.Tensor,
                         text_mask: torch.Tensor):
        """(embeds, positions int[B, L, 3], mask [B, L]) of [vision][audio][text]."""
        B, Lt = input_ids.shape
        dev = input_ids.device
        segments, seg_pos, seg_masks = [], [], []
        offset = torch.zeros(B, dtype=torch.long, device=dev)
        img = batch.get("image_data")
        if img is not None:
            vtok, vpos = self._vision_tokens(img[:, None] if img.dim() == 4 else img)
            segments.append(vtok)
            seg_pos.append(vpos)
            seg_masks.append(torch.ones(vtok.shape[:2], dtype=torch.long, device=dev))
            offset = offset + vpos[..., 0].max(-1).values + 1
        if batch.get("audio") is not None:
            atok = self._audio_tokens(batch)
            La = atok.shape[1]
            seg_pos.append((offset[:, None] + torch.arange(La, device=dev)[None])[..., None]
                           .expand(-1, -1, 3))
            segments.append(atok)
            seg_masks.append(torch.ones(B, La, dtype=torch.long, device=dev))
            offset = offset + La
        segments.append(self.token_embed(input_ids))
        seg_pos.append((offset[:, None] + torch.arange(Lt, device=dev)[None])[..., None]
                       .expand(-1, -1, 3))
        seg_masks.append(text_mask.long())
        return torch.cat(segments, 1), torch.cat(seg_pos, 1), torch.cat(seg_masks, 1)

    # ---------------------------------------------------------------- forward
    @staticmethod
    def _lm_loss(logits: torch.Tensor, labels: Optional[torch.Tensor]) -> Dict[str, Any]:
        """Next-token loss: position t predicts ``labels[:, t + 1]``, labels
        below 0 ignored; and the share of argmax hits."""
        if labels is None:
            return {}
        shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
        valid = shift_labels >= 0
        safe = torch.where(valid, shift_labels, 0).long()
        nll = -torch.gather(torch.log_softmax(shift_logits, -1), -1, safe[..., None])[..., 0]
        denom = valid.sum().clamp(min=1)
        hits = valid & (shift_logits.argmax(-1) == safe)
        return {"losses": {"lm_loss": torch.where(valid, nll, 0.0).sum() / denom},
                "metrics": {"lm_acc": hits.sum() / denom}}

    def _lm_loss_chunked(self, hidden: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 2048) -> Dict[str, Any]:
        """``_lm_loss(lm_head(hidden), labels)`` with the logits made
        ``chunk`` positions at a time: the sums of each slice's masked
        negative log-likelihood, hits and count, then one division. Each
        slice runs under ``torch.utils.checkpoint``, so its fp32 [B, chunk,
        V] logits and log-softmax are recomputed in the backward and never
        saved: forward and backward hold O(B·chunk·V), as JAX's
        ``jax.checkpoint`` of each slice does."""
        h, y = hidden[:, :-1], labels[:, 1:]
        run = self._slice_stats
        if torch.is_grad_enabled():
            run = functools.partial(checkpoint, self._slice_stats, use_reentrant=False)
        nll = hits = count = 0
        for s in range(0, h.shape[1], chunk):
            stats = run(h[:, s:s + chunk], y[:, s:s + chunk])
            nll, hits, count = nll + stats[0], hits + stats[1], count + stats[2]
        denom = torch.as_tensor(count).clamp(min=1)
        return {"losses": {"lm_loss": nll / denom}, "metrics": {"lm_acc": hits / denom}}

    def _slice_stats(self, h: torch.Tensor, y: torch.Tensor):
        """(masked nll sum, hits, count) of one slice of positions."""
        logits = self.lm_head(h).float()
        valid = y >= 0
        safe = torch.where(valid, y, 0).long()
        lp = torch.gather(torch.log_softmax(logits, -1), -1, safe[..., None])[..., 0]
        hits = (valid & (logits.argmax(-1) == safe)).sum()
        return torch.where(valid, -lp, 0.0).sum(), hits, valid.sum()

    def forward(self, batch: Mapping[str, torch.Tensor],
                deterministic: bool = True) -> Dict[str, Any]:
        """``logits`` fp32 (over the text positions in the prefix layout),
        ``hidden``, and with ``labels`` the loss and accuracy."""
        input_ids = batch["input_ids"]
        text_mask = batch.get("input_mask")
        text_mask = torch.ones_like(input_ids) if text_mask is None else text_mask
        labels = batch.get("labels")
        if self.spliced:
            embeds, positions, _ = self._assemble_spliced(batch, input_ids)
            hidden = self.decoder(embeds, positions, text_mask.long())
            if labels is not None and (hidden.shape[1] - 1) * self.vocab_size > 2 ** 28:
                return {"hidden": hidden, **self._lm_loss_chunked(hidden, labels)}
        else:
            embeds, positions, mask = self._assemble_prefix(batch, input_ids, text_mask)
            hidden = self.decoder(embeds, positions, mask)[:, -input_ids.shape[1]:]
        logits = self.lm_head(hidden).float()
        return {"logits": logits, "hidden": hidden, **self._lm_loss(logits, labels)}

    # ------------------------------------------------------ cached decoding
    def prefill(self, batch: Mapping[str, torch.Tensor], extra_slots: int):
        """The prompt through the decoder, writing a cache of L + ``extra_slots``
        slots. Returns (last-token logits fp32 [B, V], cache, lens_full int[B]
        = the first free slot, next_p int[B] = the next RoPE position)."""
        input_ids = batch["input_ids"]
        text_mask = batch.get("input_mask")
        text_mask = torch.ones_like(input_ids) if text_mask is None else text_mask
        if self.spliced:
            embeds, positions, _ = self._assemble_spliced(batch, input_ids)
            full_mask = text_mask.long()
        else:
            embeds, positions, full_mask = self._assemble_prefix(batch, input_ids, text_mask)
        B, L, _ = embeds.shape
        cache = self.decoder.make_cache(B, L + extra_slots, device=embeds.device,
                                        quantized=self.kv_int8)
        hidden, cache = self.decoder(embeds, positions, full_mask, cache=cache)
        lens_full = full_mask.sum(-1)
        last = hidden[torch.arange(B, device=hidden.device), (lens_full - 1).clamp(0, L - 1)]
        valid = full_mask > 0
        next_p = torch.where(valid, positions.max(-1).values, -1).max(1).values + 1
        return self.lm_head(last).float(), cache, lens_full, next_p

    def decode_step(self, token: torch.Tensor, rope_pos: torch.Tensor, slot: torch.Tensor,
                    cache):
        """One text token per row at RoPE position (p, p, p), p = ``rope_pos``
        int[B], written at cache slot ``slot`` int[B]. Returns (logits fp32
        [B, V], cache)."""
        pos3 = rope_pos[:, None, None].expand(-1, 1, 3)
        hidden, cache = self.decoder(self.token_embed(token[:, None]), pos3, cache=cache,
                                     decode_pos=slot)
        return self.lm_head(hidden[:, 0]).float(), cache

    def decode_chunk(self, tokens: torch.Tensor, rope0: torch.Tensor, slot0: torch.Tensor,
                     cache):
        """K text tokens per row at cache slots ``slot0..slot0+K-1`` and RoPE
        positions ``rope0..rope0+K-1`` on all three axes. Returns (logits
        fp32 [B, K, V], cache)."""
        pos = rope0[:, None] + torch.arange(tokens.shape[1], device=tokens.device)[None]
        hidden, cache = self.decoder(self.token_embed(tokens), pos[..., None].expand(-1, -1, 3),
                                     cache=cache, decode_pos=slot0)
        return self.lm_head(hidden).float(), cache

    def extend_cache(self, tokens: torch.Tensor, mask: torch.Tensor, rope0: torch.Tensor,
                     slot0: torch.Tensor, cache):
        """Append a right-padded text turn ``tokens`` [B, Lt] (valid per
        ``mask``) from cache slot ``slot0`` at RoPE continuation ``rope0``.
        Returns (the last valid token's logits fp32 [B, V], cache, ``rope0``
        + turn lengths, ``slot0`` + turn lengths)."""
        logits, cache = self.decode_chunk(tokens, rope0, slot0, cache)
        tlen = mask.sum(-1)
        last = logits[torch.arange(tokens.shape[0], device=logits.device),
                      (tlen - 1).clamp(min=0)]
        return last, cache, rope0 + tlen, slot0 + tlen

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, torch.Tensor], eos_id: int = 2,
                 max_length: Optional[int] = None, num_beams: int = 1, speculative: int = 0,
                 spec_ngram: int = 2, do_sample: bool = False, top_p: float = 0.9,
                 temperature: float = 1.0, seed: int = 0,
                 stats: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """KV-cache decoding: greedy, beams, sampling or speculation (module
        docstring). Returns (tokens int[B, Lp+max_new], the generation
        written after each row's text prompt; prompt lengths int[B]). A row
        that has emitted ``eos_id`` keeps emitting it; the last token needs
        no trailing decode step. ``stats``, a dict, receives the best beams'
        ``scores``, or speculation's ``n_generated`` and ``n_steps``."""
        max_new = int(max_length or 16)
        stats = {} if stats is None else stats
        ids = batch["input_ids"].long()
        mask = batch.get("input_mask")
        mask = torch.ones_like(ids) if mask is None else mask.long()
        B, Lp = ids.shape
        lens_text = mask.sum(-1)
        tokens = torch.cat([ids * mask, ids.new_zeros(B, max_new)], dim=1)
        gen_cols = lens_text[:, None] + torch.arange(max_new, device=ids.device)[None]
        gamma = int(speculative) if num_beams == 1 and not do_sample else 0
        fwd = {k: v for k, v in batch.items() if k not in ("input_ids", "input_mask")}
        fwd.update(input_ids=tokens[:, :Lp], input_mask=mask)
        logits, cache, lens_full, next_p = self.prefill(
            fwd, max_new + (gamma + 1 if gamma else 0))
        if num_beams > 1:
            nf = next_p.repeat_interleave(num_beams)
            sf = lens_full.repeat_interleave(num_beams)

            def beam_step(tok, slot, cache):
                return self.decode_step(tok, nf + (slot - sf), slot, cache)

            best, stats["scores"] = beam_search_cached(
                beam_step, logits, cache, lens_full, eos_id, max_new=max_new,
                num_beams=num_beams)
            return tokens.scatter_(1, gen_cols, best), lens_text
        if gamma:
            def chunk_fn(chunk, start_off, cache):
                return self.decode_chunk(chunk, next_p + start_off, lens_full + start_off, cache)

            buf = torch.cat([tokens, tokens.new_zeros(B, gamma + 1)], dim=1)
            out, stats["n_generated"], stats["n_steps"] = speculative_greedy(
                chunk_fn, logits, cache, buf, lens_text, eos_id, max_new, gamma=gamma,
                ngram=spec_ngram)
            return out[:, :Lp + max_new], lens_text
        if do_sample:
            def sample_step(tok, slot, cache):
                return self.decode_step(tok, next_p + (slot - lens_full), slot, cache)

            gen = nucleus_sampling_cached(sample_step, logits, cache, lens_full, seed, eos_id,
                                          max_new=max_new, top_p=top_p,
                                          temperature=temperature, draw_pos=next_p)
            return tokens.scatter_(1, gen_cols, gen), lens_text
        done = torch.zeros(B, dtype=torch.bool, device=ids.device)
        for t in range(max_new):
            nxt = torch.where(done, eos_id, logits.argmax(dim=-1))
            tokens.scatter_(1, (lens_text + t)[:, None], nxt[:, None])
            done = done | (nxt == eos_id)
            if t < max_new - 1:
                logits, cache = self.decode_step(nxt, next_p + t, lens_full + t, cache)
        return tokens, lens_text
