"""Pink: a vision prefix in front of a decoder LM, served with a KV cache.

Port of ``antmmf_tpu/models/pink.py`` on its decode-serving path: ViT tower
read at ``clip_select_layer`` (fewer layers, no final norm) → ``vision_proj``
→ ``[vision tokens; text tokens]`` → ``DecoderLM`` (1D RoPE, q/v LoRA) →
``output_adapter`` → ``lm_head`` (a ``QuantDense``, so int4 records serve it
too). ``forward`` returns logits over the text positions; ``prefill``,
``decode_step`` and ``decode_chunk`` are the cached pieces; ``generate`` is
greedy decoding as a Python loop over explicit tensors, with the KV cache
(one prefill, then one single-token step per new token; the last token needs
no trailing step) or, with ``use_cache=False``, by re-encoding the whole
prefix per token, the anchor the cached path is held to.

``LM_PRESETS`` is the port's copy of ``antmmf_tpu/models/m2_omni.py``'s
table. Beam search, sampling, speculative decoding, the int8 KV cache, the
EVA tower, ``adapter_style: pink``, layer scan, sequence parallelism,
chunked prefill, ``extend_cache`` and the LM loss raise until they are
ported.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.modules.llm import DecoderLM
from antmmf_torch.modules.lora import LoRADense
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer

LM_PRESETS = {
    "omni_tiny_test": dict(hidden=64, num_layers=2, num_heads=2, num_kv_heads=1,
                           vocab_size=1000),
    "omni_1b": dict(hidden=2048, num_layers=22, num_heads=16, num_kv_heads=4,
                    vocab_size=151936),
    "omni_7b": dict(hidden=4096, num_layers=32, num_heads=32, num_kv_heads=8,
                    vocab_size=151936),
}


@registry.register_model("pink")
class PinkModel(nn.Module):
    def __init__(self, lm_preset: str = "omni_1b", visual_tower: str = "vit",
                 vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 lora_rank: int = 8, lora_decoder: bool = True, lora_freeze_base: bool = True,
                 adapter_style: str = "lora", clip_select_layer: int = -2,
                 dtype_str: str = "bfloat16", scan_layers: bool = False,
                 sequence_parallel: str = "none", kv_int8: bool = False,
                 vocab_override: int = 0, device=None):
        super().__init__()
        for name, value, only in (("visual_tower", visual_tower, "vit"),
                                  ("adapter_style", adapter_style, "lora"),
                                  ("scan_layers", scan_layers, False),
                                  ("sequence_parallel", sequence_parallel, "none"),
                                  ("kv_int8", kv_int8, False)):
            if value != only:
                raise NotImplementedError(f"{name}={value!r} is not ported yet; only "
                                          f"{only!r} is")
        self.dtype = getattr(torch, dtype_str)
        p = LM_PRESETS[lm_preset]
        self.hidden = p["hidden"]
        self.vocab_size = int(vocab_override) or p["vocab_size"]
        kw = dict(dtype=self.dtype, device=device)
        self.token_embed = nn.Embedding(self.vocab_size, self.hidden, **kw)
        self.decoder = DecoderLM(
            self.hidden, p["num_layers"], p["num_heads"], p["num_kv_heads"],
            lora_rank=lora_rank if lora_decoder else 0, lora_freeze_base=lora_freeze_base, **kw)
        vit_kw = dict(VIT_PRESETS[vit_preset])
        if not -vit_kw["num_layers"] <= clip_select_layer <= -1:
            raise ValueError(f"clip_select_layer {clip_select_layer} out of range for a "
                             f"{vit_kw['num_layers']}-layer tower")
        # hidden_states[select] is the output of select + num_layers + 1
        # encoder layers, with no final norm
        vit_kw["num_layers"] += clip_select_layer + 1
        self.num_patches = (image_size // vit_kw["patch_size"]) ** 2
        self.vision_tower = VisionTransformer(image_size=image_size, final_norm=False,
                                              **vit_kw, **kw)
        if lora_rank <= 0:  # no adapters at all: a plain projection
            self.vision_proj = nn.Linear(vit_kw["embed_dim"], self.hidden, **kw)
            self.output_adapter = None
        else:
            self.vision_proj = LoRADense(vit_kw["embed_dim"], self.hidden, rank=lora_rank,
                                         freeze_base=False, **kw)
            self.output_adapter = LoRADense(self.hidden, self.hidden, rank=lora_rank,
                                            freeze_base=True, **kw)
        self.lm_head = QuantDense(self.hidden, self.vocab_size, **kw)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "PinkModel":
        """From the JAX model's ``model_attributes``; keys that change nothing
        here (remat, the EVA preset, the serial adapters' sizes) are ignored,
        as the JAX ``from_config`` ignores unknown keys."""
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
            vtok = self.vision_proj(self.vision_tower(img)["sequence"][:, 1:])
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
        """``logits`` fp32 [B, Lt, V] over the text positions."""
        if batch.get("labels") is not None:
            raise NotImplementedError("the LM loss is not ported yet")
        B, Lt = batch["input_ids"].shape
        embeds, full_mask, _ = self._assemble(batch)
        positions = self._positions(B, embeds.shape[1], embeds.device)
        hidden = self.decoder(embeds, positions, full_mask)
        return {"logits": self._head(hidden[:, -Lt:])}

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

    @torch.inference_mode()
    def generate(self, batch: Mapping[str, torch.Tensor], eos_id: int = 102,
                 max_length: Optional[int] = None, num_beams: int = 1, use_cache: bool = True,
                 speculative: int = 0, do_sample: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decoding. Returns (tokens int[B, Lp+max_new] with the
        generation written after each row's prompt, prompt lengths int[B]).
        A row that has emitted ``eos_id`` keeps emitting it."""
        if num_beams != 1 or speculative or do_sample:
            raise NotImplementedError("beam search, speculative decoding and sampling are "
                                      "not ported yet; only greedy decoding is")
        max_new = int(max_length or 16)
        ids = batch["input_ids"].long()
        mask = batch.get("input_mask")
        mask = torch.ones_like(ids) if mask is None else mask.long()
        img = batch.get("image_data")
        B, Lp = ids.shape
        total = Lp + max_new
        tokens = torch.cat([ids * mask, ids.new_zeros(B, max_new)], dim=1)
        lens = mask.sum(dim=-1)

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

        Lv = self.num_vision_tokens(batch)
        cache = self.decoder.make_cache(B, Lv + total, device=ids.device)
        logits, cache = self.prefill(fwd_batch(tokens[:, :Lp], mask), cache, lens)
        for t in range(max_new):
            nxt, done = emit(t, logits, done)
            if t < max_new - 1:  # the final token needs no trailing decode step
                logits, cache = self.decode_step(nxt, Lv + lens + t, cache)
        return tokens, lens
