"""UniVL video captioning: visual memory → causal language decoder.

Port of ``antmmf_tpu/models/univl_caption.py``. The ViT's tokens of every
frame, folded to [B, F·Lv, C] with the video mask repeated over each
frame's tokens, are the memory of a ``LanguageDecoder`` at the ViT's width
(the text tower is not built: the JAX model never calls it, so its tree has
no parameters for it).

Training is teacher forcing: the tokens are ``generation_input_ids``, else
``caption_raw_input_ids``, else ``caption_input_ids``; with a mask
(``generation_input_mask``, else ``caption_input_mask``) the model returns
``caption_cross_entropy`` (token t+1 from the prefix up to t, padded
positions out of the mean) and ``caption_token_acc``.

``generate`` is beam search (BOS 101, EOS 102, BOS prepended to the
result). By default it decodes against caches: ``prime`` projects each
layer's cross-attention memory k/v once, those and the memory mask are
repeated over the beams and kept out of the cache that is reordered with
the beams, and each step runs one token a beam against per-layer
self-attention caches. ``use_cache=False`` re-encodes the whole prefix
every step, the regression anchor. Dropout raises until it is ported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.models.univl import UnivlVideoBase, config_keys
from antmmf_torch.modules.decoders import LanguageDecoder
from antmmf_torch.modules.layers import draws
from antmmf_torch.utils.text_utils import beam_search, beam_search_cached


@registry.register_model("univl_caption")
class UnivlForVideoCaptioning(nn.Module):
    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 decoder_layers: int = 3, decoder_heads: int = 8, max_caption_len: int = 40,
                 dropout: float = 0.0, dtype_str: str = "bfloat16", device=None):
        super().__init__()
        self.dtype = getattr(torch, dtype_str)
        self.decoder_heads, self.max_caption_len = decoder_heads, max_caption_len
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   dtype=self.dtype, device=device, with_text=False,
                                   dropout=dropout)
        self.decoder = LanguageDecoder(self.base.vocab_size, self.base.visual_hidden,
                                       decoder_layers, decoder_heads, max_caption_len,
                                       dropout, dtype=self.dtype, device=device)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "UnivlForVideoCaptioning":
        names = config_keys(cls)
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def _memory(self, batch: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(memory [B, F·Lv, C], memory mask [B, F·Lv])."""
        vt = self.base.forward_img_encoder(batch["image_data"])["visual_tokens"]
        B, F, Lv, C = vt.shape
        video_mask = batch.get("video_mask")
        if video_mask is None:
            video_mask = torch.ones(B, F, dtype=torch.long, device=vt.device)
        return vt.reshape(B, F * Lv, C), video_mask.repeat_interleave(Lv, dim=1)

    @staticmethod
    def _first(batch: Mapping[str, Any], *keys: str):
        return next((batch[k] for k in keys if k in batch), None)

    def forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The teacher-forced loss; a training forward (``deterministic``
        False) draws its dropout masks from ``generator``."""
        with draws(generator, active=not deterministic):
            memory, memory_mask = self._memory(batch)
            tokens = self._first(batch, "generation_input_ids", "caption_raw_input_ids",
                                 "caption_input_ids")
            logits = self.decoder(tokens, memory, memory_mask)  # fp32 [B, L, V]
        out: Dict[str, Any] = {"logits": logits}
        mask = self._first(batch, "generation_input_mask", "caption_input_mask")
        if mask is not None:
            shift_logits, valid = logits[:, :-1], mask[:, 1:] > 0
            safe = torch.where(valid, tokens[:, 1:], 0)
            nll = -torch.log_softmax(shift_logits, dim=-1).gather(-1, safe[..., None])[..., 0]
            denom = valid.sum().clamp(min=1)
            out["losses"] = {"caption_cross_entropy": torch.where(valid, nll, 0.0).sum() / denom}
            hits = valid & (shift_logits.argmax(dim=-1) == safe)
            out["metrics"] = {"caption_token_acc": hits.sum() / denom}
        return out

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, torch.Tensor], bos_id: int = 101, eos_id: int = 102,
                 num_beams: int = 4, max_length: Optional[int] = None,
                 use_cache: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search captions: (tokens int[B, max_length] with BOS first,
        the best beam's length-normalised log-probability f32[B])."""
        max_length = int(max_length or self.max_caption_len)
        memory, memory_mask = self._memory(batch)
        B, K = memory.shape[0], num_beams
        bos = torch.full((B,), bos_id, dtype=torch.long, device=memory.device)
        if not use_cache:
            def logits_fn(tokens):  # [B·K, max_length]: the prefix, then EOS
                reps = tokens.shape[0] // B
                full = self.decoder(tokens, memory.repeat_interleave(reps, dim=0),
                                    memory_mask.repeat_interleave(reps, dim=0))
                filled = ((tokens != eos_id).sum(dim=-1) - 1).clamp(min=0)
                return full[torch.arange(tokens.shape[0], device=tokens.device), filled]

            return beam_search(logits_fn, bos, eos_id, max_length, num_beams)
        mem_kvs = self.decoder.prime(memory)
        C = memory.shape[-1]
        H = self.decoder_heads
        caches = [{n: torch.zeros(B, H, max_length, C // H, dtype=memory.dtype,
                                  device=memory.device) for n in ("k", "v")}
                  for _ in mem_kvs]
        logits0, caches = self.decoder.decode_step(
            bos, torch.zeros(B, dtype=torch.long, device=memory.device), caches, mem_kvs,
            memory_mask)
        # the memory k/v and its mask are the same for every beam and never
        # change: repeated once, outside the cache that follows the beams
        kvs = [(k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
               for k, v in mem_kvs]
        mask = memory_mask.repeat_interleave(K, dim=0)
        best, scores = beam_search_cached(
            lambda tok, pos, cache: self.decoder.decode_step(tok, pos, cache, kvs, mask),
            logits0, caches, torch.ones(B, dtype=torch.long, device=memory.device), eos_id,
            max_new=max_length - 1, num_beams=num_beams)
        return torch.cat([bos[:, None], best], dim=1), scores
