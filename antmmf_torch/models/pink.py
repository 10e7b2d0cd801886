"""Pink: a vision prefix in front of a decoder LM, trained on answer tokens
and served with a KV cache.

Port of ``antmmf_tpu/models/pink.py``: a visual tower, the CLIP-style ViT
read at ``clip_select_layer`` (fewer layers, no final norm) or, with
``visual_tower: eva``, EVA-CLIP-g (``eva_preset``; its class token dropped
as the ViT's is) → ``vision_proj`` → ``[vision tokens; text tokens]`` →
``DecoderLM`` (1D RoPE) → ``output_adapter`` → ``lm_head`` (a
``QuantDense``, so int4 records serve it too). ``adapter_style: lora`` puts
LoRA on the decoder's q and v, a LoRA ``vision_proj`` and an
``output_adapter``; ``adapter_style: pink`` is the reference scheme: serial
adapters in every decoder layer (``adapter_dim``, ``adapter_mlp``,
``adapter_non_linear``), no decoder LoRA, a plain ``vision_proj`` and no
output adapter. ``remat`` recomputes the layers of both towers in the
backward; ``scan_layers`` is the stacked weight layout of the decoder
(``utils/weights.py``). ``forward`` returns fp32 logits over the text
positions and, given ``labels``, the LM loss ``losses["lm_loss"]``: the
logits at text position t predict the label at t + 1, labels below 0 are
ignored, the negative log-softmax is summed over the rest and divided by
their count (at least 1). With ``lora_freeze_base`` the adapted projections are frozen at the
weight (``requires_grad_(False)``), so their inputs still get gradients.
``prefill``, ``decode_step``, ``decode_chunk`` and ``extend_cache`` (a
new turn or prompt chunk appended from per-row slots, the serving engine's
sessions, prefixes and chunked admission) are the cached pieces; with
``kv_int8`` every cache is the int8 one (``modules/llm.py``).
``generate`` decodes with the KV cache (one prefill, then single-token
steps; the last token needs no trailing step): greedy, beam search
(``num_beams`` > 1, ``utils/text_utils.beam_search_cached``: the cache,
the int8 one's scales included, reordered by row gathers), nucleus
sampling (``do_sample`` with ``top_p``, ``temperature`` and an integer
``seed``; the draw is hashed from the seed and each token's position) or
prompt-lookup speculation (``speculative`` = gamma draft tokens verified a
step through ``decode_chunk``, ``utils/speculative.py``: greedy's tokens
exactly; zeroed under beams or sampling, as in JAX). With
``use_cache=False`` it re-encodes the whole prefix per token, greedily: the
anchor the cached path is held to. ``prefill_chunked`` runs the prompt
``chunk_tokens`` at a time through decode-style calls: the same logits as
``prefill`` (its last chunk is cut short where JAX pads it, so no write
reaches past the prompt).

``sequence_parallel`` (``ring`` or ``ulysses``) shards the decoder's stream
[vision; text] over a registered mesh's ``seq`` axis (``modules/llm.py``);
the labels are shifted on the whole stream, then sharded as it is. Over
ranks the LM loss is the global token mean (``modules.llm.token_mean``),
and ``logits`` are over this rank's positions (its slice of the whole
stream under ``sequence_parallel``).

``LM_PRESETS`` is the port's copy of ``antmmf_tpu/models/m2_omni.py``'s
table.
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.common.build import overlay_opts
from antmmf_torch.common.registry import registry
from antmmf_torch.modules.llm import DecoderLM, token_mean
from antmmf_torch.modules.lora import LoRADense
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.modules.vision.eva_vit import EVA_PRESETS, EvaVisionTransformer
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.utils.speculative import speculative_greedy
from antmmf_torch.utils.text_utils import beam_search_cached, nucleus_sampling_cached

LM_PRESETS = {
    "omni_tiny_test": dict(hidden=64, num_layers=2, num_heads=2, num_kv_heads=1,
                           vocab_size=1000),
    "omni_1b": dict(hidden=2048, num_layers=22, num_heads=16, num_kv_heads=4,
                    vocab_size=151936),
    "omni_7b": dict(hidden=4096, num_layers=32, num_heads=32, num_kv_heads=8,
                    vocab_size=151936),
}


PINK_7B = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "projects", "pink", "configs", "pink_7b.yml")


def recipe_opts(recipe: str = PINK_7B, **model: Any) -> List[str]:
    """The opts that lay a Pink recipe (``pink_7b.yml``) over an instruction
    tuning config (``pink_instruct.local.yml``): the recipe's
    ``model_attributes.pink`` and ``optimizer_attributes``, then ``model``'s
    keys of ``model_attributes.pink`` (presets, image size, dtype) on top."""
    opts = overlay_opts(recipe, ("model_attributes.pink", "optimizer_attributes"))
    for key, value in model.items():
        opts += [f"model_attributes.pink.{key}", str(value)]
    return opts


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token loss over fp32 ``logits`` [B, Lt, V]: position t predicts
    ``labels[:, t + 1]``; labels below 0 are ignored; the summed negative
    log-softmax over the valid positions divided by max(valid, 1)."""
    shift_labels = labels[:, 1:]
    valid = shift_labels >= 0
    nll = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                          torch.where(valid, shift_labels, -100).reshape(-1).long(),
                          ignore_index=-100, reduction="sum")
    return nll / valid.sum().clamp(min=1)


@registry.register_model("pink")
class PinkModel(nn.Module):
    DECODE_QUANT = ("int4", "int8")  # the predictor's decode_quant modes this model serves
    global_batch_over_ranks = True  # the LM loss is the global token mean over ranks

    def __init__(self, lm_preset: str = "omni_1b", visual_tower: str = "vit",
                 vit_preset: str = "vit_base_patch32", eva_preset: str = "eva_vit_g",
                 image_size: int = 224, lora_rank: int = 8, lora_decoder: bool = True,
                 lora_freeze_base: bool = True, adapter_style: str = "lora",
                 adapter_dim: int = 8, adapter_mlp: bool = False,
                 adapter_non_linear: bool = False, clip_select_layer: int = -2,
                 dtype_str: str = "bfloat16", remat: bool = False, scan_layers: bool = False,
                 sequence_parallel: str = "none", kv_int8: bool = False,
                 vocab_override: int = 0, device=None):
        super().__init__()
        self.kv_int8 = bool(kv_int8)
        if adapter_style not in ("lora", "pink"):
            raise ValueError(f"adapter_style must be 'lora' or 'pink', got {adapter_style!r}")
        if visual_tower not in ("vit", "eva"):
            raise ValueError(f"visual_tower must be 'vit' or 'eva', got {visual_tower!r}")
        pink_style = adapter_style == "pink"
        self.dtype = getattr(torch, dtype_str)
        p = LM_PRESETS[lm_preset]
        self.hidden = p["hidden"]
        self.vocab_size = int(vocab_override) or p["vocab_size"]
        kw = dict(dtype=self.dtype, device=device)
        self.token_embed = nn.Embedding(self.vocab_size, self.hidden, **kw)
        self.decoder = DecoderLM(
            self.hidden, p["num_layers"], p["num_heads"], p["num_kv_heads"],
            lora_rank=0 if pink_style else (lora_rank if lora_decoder else 0),
            lora_freeze_base=lora_freeze_base, adapter_dim=adapter_dim if pink_style else 0,
            adapter_mlp=adapter_mlp, adapter_non_linear=adapter_non_linear, remat=remat,
            scan_layers=scan_layers, sequence_parallel=sequence_parallel, **kw)
        if visual_tower == "eva":
            eva_kw = EVA_PRESETS[eva_preset]
            self.num_patches = (image_size // eva_kw["patch_size"]) ** 2
            self.vision_tower = EvaVisionTransformer(image_size=image_size, remat=remat,
                                                     **eva_kw, **kw)
            width = eva_kw["embed_dim"]
        else:
            vit_kw = dict(VIT_PRESETS[vit_preset])
            if not -vit_kw["num_layers"] <= clip_select_layer <= -1:
                raise ValueError(f"clip_select_layer {clip_select_layer} out of range for a "
                                 f"{vit_kw['num_layers']}-layer tower")
            # hidden_states[select] is the output of select + num_layers + 1
            # encoder layers, with no final norm
            vit_kw["num_layers"] += clip_select_layer + 1
            self.num_patches = (image_size // vit_kw["patch_size"]) ** 2
            self.vision_tower = VisionTransformer(image_size=image_size, final_norm=False,
                                                  remat=remat, **vit_kw, **kw)
            width = vit_kw["embed_dim"]
        if pink_style or lora_rank <= 0:  # the reference mm_projector, or no adapters
            self.vision_proj = nn.Linear(width, self.hidden, **kw)
            self.output_adapter = None
        else:
            self.vision_proj = LoRADense(width, self.hidden, rank=lora_rank, freeze_base=False,
                                         **kw)
            self.output_adapter = LoRADense(self.hidden, self.hidden, rank=lora_rank,
                                            freeze_base=True, **kw)
        self.lm_head = QuantDense(self.hidden, self.vocab_size, **kw)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "PinkModel":
        """From the JAX model's ``model_attributes``; keys the constructor does
        not take are ignored, as the JAX ``from_config`` ignores unknown
        keys."""
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    # ---------------------------------------------------------------- forward
    def _assemble(self, batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """[vision tokens][text tokens] → (embeds [B, Lv+Lt, C], mask
        [B, Lv+Lt], Lv)."""
        input_ids = batch["input_ids"]
        mask = batch.get("input_mask")
        mask = torch.ones_like(input_ids) if mask is None else mask
        segments, masks = [], []
        img = batch.get("image_data")
        if img is not None:
            if img.dim() == 5:
                img = img[:, 0]
            seq = self.vision_tower(img)
            if isinstance(seq, dict):  # the CLIP-style tower returns a dict
                seq = seq["sequence"]
            vtok = self.vision_proj(seq[:, 1:])
            segments.append(vtok)
            masks.append(torch.ones(vtok.shape[:2], dtype=mask.dtype, device=mask.device))
        segments.append(self.token_embed(input_ids))
        masks.append(mask)
        embeds = torch.cat(segments, dim=1)
        return embeds, torch.cat(masks, dim=1), embeds.shape[1] - input_ids.shape[1]

    def num_vision_tokens(self, batch: Mapping[str, Any]) -> int:
        return 0 if batch.get("image_data") is None else self.num_patches

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.output_adapter is not None:
            hidden = hidden + self.output_adapter(hidden)
        return self.lm_head(hidden).float()

    @staticmethod
    def _positions(B: int, L: int, device) -> torch.Tensor:
        return torch.arange(L, device=device)[None].expand(B, L)

    def forward(self, batch: Mapping[str, torch.Tensor],
                deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """``logits`` fp32 [B, Lt, V] over the text positions, and with
        ``labels`` int[B, Lt] the LM loss. Pink draws nothing in training,
        so ``deterministic`` (the shell's training switch) changes nothing."""
        B, Lt = batch["input_ids"].shape
        embeds, full_mask, Lv = self._assemble(batch)
        positions = self._positions(B, embeds.shape[1], embeds.device)
        hidden = self.decoder(embeds, positions, full_mask)
        labels = batch.get("labels")
        group = self.decoder.seq_group()
        if group is None:
            hidden = hidden[:, -Lt:]
        out = {"logits": self._head(hidden)}
        if labels is None:
            return out
        if group is None and not coll.is_distributed():
            out["losses"] = {"lm_loss": lm_loss(out["logits"], labels)}
            return out
        # over ranks: text position t predicts labels[:, t + 1], shifted on
        # the whole stream before the decoder's sharding
        y = labels.new_full((B, Lt), -100)
        y[:, :-1] = labels[:, 1:]
        if group is not None:
            y = self.decoder.shard_stream(torch.cat([y.new_full((B, Lv), -100), y], 1), group,
                                          -100)
        logits = out["logits"]
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
                              ignore_index=-100, reduction="sum")
        valid = y >= 0
        hits = (valid & (logits.argmax(-1) == y)).sum()
        out["losses"] = {"lm_loss": token_mean(nll, hits, valid.sum())[0]}
        return out

    # ------------------------------------------------------- cached decoding
    def prefill(self, batch: Mapping[str, torch.Tensor], cache, lens: torch.Tensor):
        """Run the padded prompt, writing the KV cache. Returns (logits fp32
        [B, V] at each row's last prompt token, cache)."""
        embeds, full_mask, Lv = self._assemble(batch)
        B, L, _ = embeds.shape
        hidden, cache = self.decoder(embeds, self._positions(B, L, embeds.device), full_mask,
                                     cache=cache)
        idx = (Lv + lens - 1).clamp(0, L - 1)
        last = hidden[torch.arange(B, device=hidden.device), idx]
        return self._head(last), cache

    def prefill_chunked(self, batch: Mapping[str, torch.Tensor], cache, lens: torch.Tensor,
                        chunk_tokens: int = 128):
        """``prefill`` ``chunk_tokens`` positions of [vision; text] at a time,
        each chunk a decode-style call at its own slots; the hidden state at
        each row's last prompt token is kept as its chunk passes. Returns
        (logits fp32 [B, V], cache)."""
        embeds, _, Lv = self._assemble(batch)
        B, L, C = embeds.shape
        W = min(int(chunk_tokens), L)
        rows = torch.arange(B, device=embeds.device)
        last_idx = Lv + lens - 1
        last_h = embeds.new_zeros(B, C)
        for s in range(0, L, W):
            chunk = embeds[:, s:s + W]
            pos0 = torch.full((B,), s, dtype=torch.long, device=embeds.device)
            pos = pos0[:, None] + torch.arange(chunk.shape[1], device=embeds.device)[None]
            hidden, cache = self.decoder(chunk, pos, cache=cache, decode_pos=pos0)
            hit = (last_idx >= s) & (last_idx < s + chunk.shape[1])
            picked = hidden[rows, (last_idx - s).clamp(0, chunk.shape[1] - 1)]
            last_h = torch.where(hit[:, None], picked, last_h)
        return self._head(last_h), cache

    def decode_step(self, token: torch.Tensor, pos: torch.Tensor, cache):
        """One token per row at absolute slot and RoPE position ``pos``
        int[B]. Returns (logits fp32 [B, V], cache)."""
        hidden, cache = self.decoder(self.token_embed(token[:, None]), pos[:, None],
                                     cache=cache, decode_pos=pos)
        return self._head(hidden[:, 0]), cache

    def decode_chunk(self, tokens: torch.Tensor, pos0: torch.Tensor, cache):
        """K tokens per row at contiguous slots ``pos0..pos0+K-1``. Returns
        (logits fp32 [B, K, V], cache)."""
        pos = pos0[:, None] + torch.arange(tokens.shape[1], device=tokens.device)[None]
        hidden, cache = self.decoder(self.token_embed(tokens), pos, cache=cache,
                                     decode_pos=pos0)
        return self._head(hidden), cache

    def extend_cache(self, tokens: torch.Tensor, mask: torch.Tensor, start: torch.Tensor, cache):
        """Append right-padded ``tokens`` [B, Lt] (valid per ``mask``) from
        per-row slot ``start`` int[B]; pad writes past a row's turn sit beyond
        the validity horizon until later steps overwrite them. Returns (the
        last valid token's logits fp32 [B, V], cache, ``start`` + turn
        lengths)."""
        logits, cache = self.decode_chunk(tokens, start, cache)
        tlen = mask.sum(-1)
        last = logits[torch.arange(tokens.shape[0], device=logits.device),
                      (tlen - 1).clamp(min=0)]
        return last, cache, start + tlen

    def make_cache(self, batch: int, max_len: int, device=None):
        """The decoder's cache, int8 under ``kv_int8``."""
        return self.decoder.make_cache(batch, max_len, device=device, quantized=self.kv_int8)

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, torch.Tensor], eos_id: int = 102,
                 max_length: Optional[int] = None, num_beams: int = 1, use_cache: bool = True,
                 speculative: int = 0, spec_ngram: int = 2, do_sample: bool = False,
                 top_p: float = 0.9, temperature: float = 1.0, seed: int = 0,
                 stats: Optional[Dict[str, Any]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy, beam, sampled or speculative decoding (module docstring).
        Returns (tokens int[B, Lp+max_new] with the generation written after
        each row's prompt, prompt lengths int[B]). A row that has emitted
        ``eos_id`` keeps emitting it. ``stats``, a dict, receives the best
        beams' ``scores``, or speculation's ``n_generated`` and ``n_steps``."""
        max_new = int(max_length or 16)
        stats = {} if stats is None else stats
        ids = batch["input_ids"].long()
        mask = batch.get("input_mask")
        mask = torch.ones_like(ids) if mask is None else mask.long()
        img = batch.get("image_data")
        B, Lp = ids.shape
        total = Lp + max_new
        tokens = torch.cat([ids * mask, ids.new_zeros(B, max_new)], dim=1)
        lens = mask.sum(dim=-1)
        gen_cols = lens[:, None] + torch.arange(max_new, device=ids.device)[None]

        def fwd_batch(cur_ids, cur_mask):
            fwd = {"input_ids": cur_ids, "input_mask": cur_mask}
            if img is not None:
                fwd["image_data"] = img
            return fwd

        def emit(t, logits, done):
            nxt = torch.where(done, eos_id, logits.argmax(dim=-1))
            tokens.scatter_(1, (lens + t)[:, None], nxt[:, None])
            return nxt, done | (nxt == eos_id)

        done = torch.zeros(B, dtype=torch.bool, device=ids.device)
        if not use_cache:
            steps = torch.arange(total, device=ids.device)[None]
            for t in range(max_new):
                cur = (steps < (lens + t)[:, None]).long()
                logits = self.forward(fwd_batch(tokens, cur))["logits"]
                pos = (lens + t - 1).clamp(0, total - 1)
                _, done = emit(t, logits[torch.arange(B, device=ids.device), pos], done)
            return tokens, lens

        gamma = int(speculative) if num_beams == 1 and not do_sample else 0
        Lv = self.num_vision_tokens(batch)
        cache = self.make_cache(B, Lv + total + (gamma + 1 if gamma else 0), device=ids.device)
        logits, cache = self.prefill(fwd_batch(tokens[:, :Lp], mask), cache, lens)
        if num_beams > 1:
            best, stats["scores"] = beam_search_cached(
                self.decode_step, logits, cache, Lv + lens, eos_id, max_new=max_new,
                num_beams=num_beams)
            return tokens.scatter_(1, gen_cols, best), lens
        if gamma:
            def chunk_fn(chunk, start_off, cache):
                return self.decode_chunk(chunk, Lv + lens + start_off, cache)

            buf = torch.cat([tokens, tokens.new_zeros(B, gamma + 1)], dim=1)
            out, stats["n_generated"], stats["n_steps"] = speculative_greedy(
                chunk_fn, logits, cache, buf, lens, eos_id, max_new, gamma=gamma, ngram=spec_ngram)
            return out[:, :total], lens
        if do_sample:
            gen = nucleus_sampling_cached(self.decode_step, logits, cache, Lv + lens, seed,
                                          eos_id, max_new=max_new, top_p=top_p,
                                          temperature=temperature)
            return tokens.scatter_(1, gen_cols, gen), lens
        for t in range(max_new):
            nxt, done = emit(t, logits, done)
            if t < max_new - 1:  # the final token needs no trailing decode step
                logits, cache = self.decode_step(nxt, Lv + lens + t, cache)
        return tokens, lens
