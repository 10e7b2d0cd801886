"""Continuous-batching serving engine for the KV-cache LLMs (Pink, M2-omni).

Port of ``antmmf_tpu/predictors/serving_engine.py``. A fixed pool of
``slots`` cache rows decodes in lock-step while requests are admitted and
retired between decode windows:

* a single-request prefill writes a fresh [1, ...] cache (the model's
  ``prefill``: its towers and the causal flash forward), and ``_admit``
  copies that row and its first-token logits into slot s of the pooled
  [S, ...] cache in place (the row is copied, so a stored prefix row never
  aliases the pool);
* ``step`` advances every slot one decode window of ``step_tokens`` (H)
  tokens: H ``decode_step`` calls over the pool (S rows through every
  projection, so int4 records run the GEMV kernel at S rows) with the
  greedy or sampled token chosen on the device, and one host read of the
  window's [S, H] tokens at its end. Inactive rows decode token 0 at
  ``min(slot, T - 1)`` and do not advance, as JAX's do;
* the host owns the bookkeeping: the queue, retirement on EOS, budget or a
  stop sequence, cancellation and deadlines, sessions and prefixes.

Sessions (``continue_session``), prefixes (``register_prefix``) and chunked
admission (``prefill_chunk``) append tokens through the model's
``extend_cache`` on one row: its cache is a view of that row of the pool,
so the other rows are never written. A chunk's slots must lie inside the
cache: a write past T raises (``_extend``), where XLA's would clamp.

Per-request nucleus sampling filters the logits exactly as JAX's
``_step_sample`` does (``nucleus_filter``; temperature 0 takes the greedy
argmax in the same window). The draw is the port's own: a Gumbel-max over
uniforms hashed from (the request's seed, the token's RoPE position, the
vocabulary index) on the device (``position_uniforms``), not JAX's
threefry stream; the helpers live in ``utils/text_utils.py``, which
``generate``'s sampling shares; a sampled token is a pure function of the request and
its own progress, never of the requests that share the pool.

The adapters bind a model to the engine: the weights live in the module
(int4 records already in its ``QuantDense`` buffers), and the engine runs
on the module's device. The ``scan_layers`` row axis of JAX's engine has no
counterpart: the port's cache is always a per-layer list.

Unlike the reference, a queued request dropped for its deadline, or
cancelled, leaves no ``_deadline`` or ``_session_req`` entry behind.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from antmmf_torch.utils.text_utils import (  # noqa: F401  (the engine's sampling surface)
    nucleus_filter,
    position_uniforms,
    sample_tokens,
)



def _module_device(module) -> torch.device:
    return module.token_embed.weight.device


class PinkAdapter:
    """Binds ``PinkModel``: cache slots and RoPE positions coincide (1D
    positions over [vision; text]). The cache holds ``Lv + max_prompt +
    max_new + extra_slots`` slots (``extra_slots``: room for later session
    turns)."""

    def __init__(self, module, max_prompt_len: int, max_new_tokens: int, has_image: bool,
                 extra_slots: int = 0):
        self.module = module
        self.device = _module_device(module)
        self.Lv = module.num_patches if has_image else 0
        self.T = self.Lv + max_prompt_len + max_new_tokens + extra_slots
        self.max_prompt = max_prompt_len

    def make_cache(self, batch: int):
        return self.module.make_cache(batch, self.T, device=self.device)

    def prefill1(self, tokens, mask, extras, reserve: int = 0):
        """[1, Lp] prompt → (logits [1, V], cache1, slot0 [1], rope0 [1]).
        ``reserve`` is unused: the cache always holds the whole budget. The
        vision offset is this request's (0 for a text-only request)."""
        batch = {"input_ids": tokens, "input_mask": mask, **extras}
        lens = mask.sum(-1)
        logits, cache = self.module.prefill(batch, self.make_cache(1), lens)
        start = self.module.num_vision_tokens(batch) + lens
        return logits, cache, start, start

    def decode(self, token, rope, slot, cache):
        return self.module.decode_step(token, slot, cache)

    def extend(self, tokens, mask, rope, slot, cache):
        """Append a turn or prompt chunk: (last-valid logits, cache,
        new_rope, new_slot)."""
        logits, cache, new_start = self.module.extend_cache(tokens, mask, slot, cache)
        return logits, cache, new_start, new_start


class M2OmniAdapter:
    """Binds ``M2Omni``: RoPE positions follow the 3D ``get_rope_index``
    continuation and differ from cache slots, so the two streams are carried
    apart. M2-omni sizes its cache from the spliced prompt, so the pool's T
    is the first prefill's, and every request must pad to one length
    (``has_image`` is taken for the adapters' one signature and unused)."""

    def __init__(self, module, max_prompt_len: int, max_new_tokens: int, has_image: bool,
                 extra_slots: int = 0):
        self.module = module
        self.device = _module_device(module)
        self.max_new = max_new_tokens
        self.max_prompt = max_prompt_len
        self.extra_slots = extra_slots
        self.T: Optional[int] = None  # from the first prefill

    def prefill1(self, tokens, mask, extras, reserve: int = 0):
        """``reserve`` widens the cache beyond prompt + decode: chunked
        admission prefills chunk 0 and appends the rest of the prompt."""
        batch = {"input_ids": tokens, "input_mask": mask, **extras}
        logits, cache, lens_full, next_p = self.module.prefill(
            batch, self.max_new + self.extra_slots + reserve)
        T = cache[0]["k"].shape[-2]
        if self.T is not None and T != self.T:
            raise ValueError(
                f"M2Omni prefill produced cache length {T} != pooled {self.T}"
                " — M2Omni sizes the cache from the SPLICED prompt length,"
                " so every request in one engine must pad input_ids to one"
                " fixed length (vision embeddings replace placeholder slots"
                " in place; a different prompt width means a different row"
                " shape that cannot join the slot pool)")
        self.T = T
        return logits, cache, lens_full, next_p

    def decode(self, token, rope, slot, cache):
        return self.module.decode_step(token, rope, slot, cache)

    def extend(self, tokens, mask, rope, slot, cache):
        return self.module.extend_cache(tokens, mask, rope, slot, cache)


class ContinuousBatchingEngine:
    """Slot-pooled decoding with admission at window boundaries.

    ``run(requests)`` feeds every request through the pool and returns the
    outputs and timings (``stats``); ``submit``/``step`` are the online loop.
    A request is ``{"input_ids": [Lp], "input_mask"?, "image_data"?,
    "video_data"?, "audio"?, "audio_mask"?, "max_new"?, "session"?,
    "do_sample"?, "temperature"?, "top_p"?, "seed"?, "stop"?: [[ids]],
    "deadline_s"?, "prefix"?}``.
    """

    def __init__(self, adapter, slots: int = 8, max_new_tokens: int = 32, eos_id: int = 102,
                 step_tokens: int = 8, suffix_pad: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, chunks_per_step: int = 1):
        self.ad = adapter
        self.device = adapter.device
        self.S = slots
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.chunk = int(prefill_chunk) if prefill_chunk else None
        if self.chunk:  # whole-prompt admission is the limit case
            self.chunk = min(self.chunk, int(getattr(adapter, "max_prompt", self.chunk)))
        self.chunks_per_step = max(1, int(chunks_per_step))
        self._slot_pending: List[Optional[Dict[str, Any]]] = [None] * slots
        self.suffix_pad = suffix_pad
        self.H = max(1, int(step_tokens))
        self._queue: List[Tuple[Any, Mapping[str, Any]]] = []
        self._slot_req: List[Optional[Any]] = [None] * slots
        self._slot_toks: List[List[int]] = [[] for _ in range(slots)]
        self._slot_budget: List[int] = [max_new_tokens] * slots
        self._slot_stop: List[List[List[int]]] = [[] for _ in range(slots)]
        self._slot_temp = np.zeros((slots,), np.float32)  # 0 = greedy
        self._slot_topp = np.ones((slots,), np.float32)
        self._cancelled: set = set()
        self.request_timeout_s: Optional[float] = None
        self._deadline: Dict[Any, float] = {}
        self._evicted: set = set()
        self._timeline: List[Tuple[int, int]] = []  # (active slots, queue depth) a step
        self._t_submit: Dict[Any, float] = {}
        self._t_first: Dict[Any, float] = {}
        self._done: Dict[Any, List[int]] = {}
        self._latency: Dict[Any, float] = {}
        self._state: Optional[Dict[str, Any]] = None  # built at the first admission
        self._session_req: set = set()
        self._slot_held: List[Optional[Any]] = [None] * slots
        # (rope, slot) where each row's current generation started
        self._slot_start: List[Tuple[Any, Any]] = [(0, 0)] * slots
        self._sessions: Dict[Any, Tuple[int, int, int]] = {}
        # prefix_id -> (cache1, logits0, rope0, slot0, rope_end, slot_end)
        self._prefixes: Dict[Any, Tuple[Any, Any, Any, Any, int, int]] = {}

    # -- pool state --------------------------------------------------------
    def _ensure_state(self, cache1, logits0) -> None:
        if self._state is not None:
            return
        S, dev = self.S, self.device
        self._state = {
            "cache": [{k: torch.zeros((S,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
                       for k, t in layer.items()} for layer in cache1],
            "last_logits": torch.zeros(S, logits0.shape[-1], dtype=logits0.dtype, device=dev),
            "rope": torch.zeros(S, dtype=torch.long, device=dev),
            "spos": torch.zeros(S, dtype=torch.long, device=dev),
            "seeds": torch.zeros(S, dtype=torch.long, device=dev),
        }

    @property
    def T(self) -> int:
        return self._state["cache"][0]["k"].shape[-2]

    def _admit(self, s: int, cache1, logits0, rope0, slot0) -> None:
        """Copy a [1]-row cache and its first-token logits into slot s."""
        st = self._state
        for big, one in zip(st["cache"], cache1):
            for k, t in one.items():
                big[k][s].copy_(t[0])
        st["last_logits"][s] = logits0[0]
        st["rope"][s] = rope0.reshape(-1)[0]
        st["spos"][s] = slot0.reshape(-1)[0]

    def _extend(self, s: int, tokens: np.ndarray, mask: np.ndarray, rope_at: int,
                slot_at: int) -> None:
        """Append ``tokens`` to row s's cache from slot ``slot_at`` (RoPE
        ``rope_at``) through the model's ``extend_cache`` on a view of that
        row; the other rows are never written."""
        if slot_at + len(tokens) > self.T:
            raise ValueError(f"an extend of {len(tokens)} tokens from slot {slot_at} writes "
                             f"past the cache's {self.T} slots")
        st, dev = self._state, self.device
        cache1 = [{k: t[s:s + 1] for k, t in layer.items()} for layer in st["cache"]]
        lg, _, new_rope, new_slot = self.ad.extend(
            torch.as_tensor(tokens, dtype=torch.long, device=dev)[None],
            torch.as_tensor(mask, dtype=torch.long, device=dev)[None],
            torch.tensor([rope_at], device=dev), torch.tensor([slot_at], device=dev), cache1)
        st["last_logits"][s] = lg[0]
        st["rope"][s] = new_rope[0]
        st["spos"][s] = new_slot[0]

    def _window(self, active_py: List[bool], sampling: bool) -> np.ndarray:
        """H decode steps over the whole pool with no host read inside;
        returns the window's tokens [S, H] (one device-to-host copy)."""
        st, dev, T = self._state, self.device, self.T
        active = torch.tensor(active_py, device=dev)
        if sampling:
            temps = torch.as_tensor(self._slot_temp, device=dev)
            top_ps = torch.as_tensor(self._slot_topp, device=dev)
        logits, cache, rope, spos = st["last_logits"], st["cache"], st["rope"], st["spos"]
        toks = torch.zeros(self.S, self.H, dtype=torch.long, device=dev)
        for i in range(self.H):
            if sampling:
                nxt = sample_tokens(logits, temps, top_ps, st["seeds"], rope)
            else:
                nxt = logits.argmax(dim=-1)
            nxt = torch.where(active, nxt, 0)
            toks[:, i] = nxt
            logits, cache = self.ad.decode(nxt, rope, spos.clamp(max=T - 1), cache)
            rope = torch.where(active, rope + 1, rope)
            spos = torch.where(active, (spos + 1).clamp(max=T - 1), spos)
        st["last_logits"], st["rope"], st["spos"] = logits, rope, spos
        return toks.cpu().numpy()

    # -- public API --------------------------------------------------------
    def reset(self) -> None:
        """Clear request bookkeeping; the pooled state is kept."""
        self._queue.clear()
        self._slot_req = [None] * self.S
        self._slot_toks = [[] for _ in range(self.S)]
        self._slot_stop = [[] for _ in range(self.S)]
        self._slot_temp[:] = 0.0
        self._slot_topp[:] = 1.0
        self._slot_pending = [None] * self.S
        self._cancelled = set()
        self._evicted = set()
        self._deadline.clear()
        self._timeline = []
        self._t_submit.clear()
        self._t_first.clear()
        self._done = {}
        self._latency = {}
        self._session_req = set()
        self._slot_held = [None] * self.S
        self._sessions = {}

    def _extras_of(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        """A request's modality arrays batched as the [1]-row prefill's
        extras: image_data [H, W, 3] (a 4-dim array is taken as batched) or
        a tuple of them (a multi-image request), video_data [F, H, W, 3],
        audio [T, F], audio_mask [T]."""
        dev = self.device

        def batched(x, ndim, dtype=torch.float32):
            t = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
            return t[None] if t.dim() == ndim else t

        extras: Dict[str, Any] = {}
        img = data.get("image_data")
        if img is not None:
            extras["image_data"] = (tuple(batched(x, 3) for x in img)
                                    if isinstance(img, (tuple, list)) else batched(img, 3))
        if data.get("video_data") is not None:
            extras["video_data"] = batched(data["video_data"], 4)
        if data.get("audio") is not None:
            extras["audio"] = batched(data["audio"], 2)
            if data.get("audio_mask") is not None:
                extras["audio_mask"] = batched(data["audio_mask"], 1, torch.long)
        return extras

    def _prompt(self, data: Mapping[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = np.asarray(data["input_ids"], np.int64)
        mask = np.asarray(data.get("input_mask", np.ones(ids.shape[0], np.int64)), np.int64)
        return (torch.as_tensor(ids, device=self.device)[None],
                torch.as_tensor(mask, device=self.device)[None])

    @torch.inference_mode()
    def register_prefix(self, prefix_id, data: Mapping[str, Any]) -> None:
        """Prefill a shared prompt prefix once (data: ``input_ids``,
        ``input_mask``?, ``image_data``?); ``submit(rid, {"prefix": id,
        "input_ids": suffix})`` copies its row into the request's slot and
        appends only the suffix."""
        logits0, cache1, slot0, rope0 = self.ad.prefill1(*self._prompt(data),
                                                        self._extras_of(data))
        self._ensure_state(cache1, logits0)
        self._prefixes[prefix_id] = (cache1, logits0, rope0, slot0, int(rope0.reshape(-1)[0]),
                                     int(slot0.reshape(-1)[0]))

    def drop_prefix(self, prefix_id) -> None:
        self._prefixes.pop(prefix_id, None)

    def submit(self, request_id, data: Mapping[str, Any]) -> None:
        """Queue a request (the keys in the class docstring). Budgets retire
        each slot on its own; ``session`` keeps the cache row for
        ``continue_session``; ``do_sample`` samples this request alone;
        ``stop`` sequences retire it and are left out of its output."""
        if data.get("session"):
            self._session_req.add(request_id)
        self._t_submit[request_id] = time.perf_counter()
        ddl = data.get("deadline_s", self.request_timeout_s)
        if ddl is not None:
            self._deadline[request_id] = self._t_submit[request_id] + float(ddl)
        self._queue.append((request_id, data))

    def _drop_queued(self, rid, now: float) -> None:
        """A queued request that never runs: an empty output, and no
        deadline or session entry left behind."""
        self._done[rid] = []
        self._latency[rid] = now - self._t_submit[rid]
        self._deadline.pop(rid, None)
        self._session_req.discard(rid)

    def cancel(self, request_id) -> bool:
        """Cancel a queued or running request. A queued one never runs; a
        running one frees its slot at the next window boundary with its
        partial tokens. False if the id is unknown or already finished."""
        for i, (rid, _) in enumerate(self._queue):
            if rid == request_id:
                self._queue.pop(i)
                self._cancelled.add(request_id)
                self._drop_queued(request_id, time.perf_counter())
                return True
        if request_id in self._slot_req or any(
                p is not None and p["rid"] == request_id for p in self._slot_pending):
            self._cancelled.add(request_id)  # retired in the next step()
            return True
        return False

    def _set_controls(self, s: int, rid, data: Mapping[str, Any]) -> None:
        """The slot's budget, stop sequences and sampling controls."""
        self._slot_req[s] = rid
        self._slot_toks[s] = []
        self._slot_budget[s] = min(int(data.get("max_new", self.max_new)), self.max_new)
        self._slot_stop[s] = [list(map(int, seq)) for seq in data.get("stop", []) if len(seq)]
        if data.get("do_sample"):
            self._slot_temp[s] = max(float(data.get("temperature", 1.0)), 1e-6)
            self._slot_topp[s] = float(data.get("top_p", 0.9))
            self._state["seeds"][s] = int(data.get("seed", 0))
        else:
            self._slot_temp[s] = 0.0
            self._slot_topp[s] = 1.0

    def _admit_waiting(self) -> None:
        for s in range(self.S):
            if self._slot_req[s] is not None or not self._queue \
                    or self._slot_held[s] is not None or self._slot_pending[s] is not None:
                continue
            rid, data = self._queue.pop(0)
            if rid in self._cancelled:
                continue
            if data.get("prefix") is not None:
                self._admit_with_prefix(s, rid, data)
            elif self.chunk is not None:
                self._admit_chunked(s, rid, data)
            else:
                self._admit_full(s, rid, data)

    def _admit_full(self, s: int, rid, data: Mapping[str, Any]) -> None:
        logits0, cache1, slot0, rope0 = self.ad.prefill1(*self._prompt(data),
                                                        self._extras_of(data))
        self._ensure_state(cache1, logits0)
        self._admit(s, cache1, logits0, rope0, slot0)
        self._set_controls(s, rid, data)
        # kept on the device; read on the host only when a session retires
        self._slot_start[s] = (rope0, slot0)

    def _admit_chunked(self, s: int, rid, data: Mapping[str, Any]) -> None:
        """Prefill the towers and the first ``prefill_chunk`` (W) prompt
        tokens, padded to W, into slot s; the rest of the prompt waits as
        W-token chunks that ``_advance_pending`` appends between windows."""
        W = self.chunk
        ids = np.asarray(data["input_ids"], np.int64)
        msk = np.asarray(data.get("input_mask", np.ones(ids.shape[0], np.int64)), np.int64)
        n_valid = int(msk.sum())
        ids, msk = ids[:n_valid], msk[:n_valid]
        # extend cannot splice modal tokens: placeholders past chunk 0 admit whole
        splice_ids = [t for t in (getattr(self.ad.module, "image_token_id", None),
                                  getattr(self.ad.module, "video_token_id", None),
                                  getattr(self.ad.module, "audio_token_id", None))
                      if t is not None]
        if splice_ids and np.isin(ids[W:], splice_ids).any():
            self._admit_full(s, rid, data)
            return
        c0, c0m = ids[:W], msk[:W]
        if c0.shape[0] < W:
            pad = W - c0.shape[0]
            c0 = np.concatenate([c0, np.zeros(pad, np.int64)])
            c0m = np.concatenate([c0m, np.zeros(pad, np.int64)])
        reserve = max(0, getattr(self.ad, "max_prompt", W) - W)
        dev = self.device
        logits0, cache1, slot0, rope0 = self.ad.prefill1(
            torch.as_tensor(c0, device=dev)[None], torch.as_tensor(c0m, device=dev)[None],
            self._extras_of(data), reserve)
        self._ensure_state(cache1, logits0)
        self._admit(s, cache1, logits0, rope0, slot0)
        self._set_controls(s, rid, data)
        self._slot_start[s] = (rope0, slot0)
        if n_valid > W:
            # every chunk is W wide; the last starts at n_valid - W and
            # overlaps the one before (its slots are rewritten with the same
            # keys and values), so no chunk writes past the prompt
            starts = list(range(W, n_valid - W + 1, W))
            if not starts or starts[-1] + W < n_valid:
                starts.append(n_valid - W)
            self._slot_pending[s] = {
                "rid": rid, "chunks": [(ids[a:a + W], a) for a in starts],
                "rope0": int(rope0.reshape(-1)[0]), "slot0": int(slot0.reshape(-1)[0]),
                "W0": W}
            self._slot_req[s] = None  # decodes once its prompt is in

    def _advance_pending(self) -> None:
        """Append up to ``chunks_per_step`` pending chunks, by slot order; a
        slot whose last chunk lands decodes from that extend's logits."""
        quota = self.chunks_per_step
        for s in range(self.S):
            if quota <= 0:
                break
            pend = self._slot_pending[s]
            if pend is None:
                continue
            if pend["rid"] in self._cancelled:
                self._finish_cancelled(s, pend["rid"])
                self._slot_pending[s] = None
                continue
            W = self.chunk
            last_end = None
            while pend["chunks"] and quota > 0:
                tokens, tstart = pend["chunks"].pop(0)
                off = tstart - pend["W0"]
                self._extend(s, tokens, np.ones(W, np.int64), pend["rope0"] + off,
                             pend["slot0"] + off)
                last_end = tstart + W
                quota -= 1
            if not pend["chunks"]:
                off = last_end - pend["W0"]
                self._slot_req[s] = pend["rid"]
                self._slot_start[s] = (pend["rope0"] + off, pend["slot0"] + off)
                self._slot_pending[s] = None

    def _finish_cancelled(self, s: int, rid) -> None:
        self._done[rid] = list(self._slot_toks[s])
        self._latency[rid] = time.perf_counter() - self._t_submit[rid]
        self._slot_req[s] = None
        self._slot_toks[s] = []
        self._deadline.pop(rid, None)
        self._session_req.discard(rid)

    def _evict_overdue(self) -> None:
        """Running requests past their deadline free their slot with their
        partial tokens (marked evicted); queued ones never run; pending
        chunked prefills are abandoned."""
        if not self._deadline:
            return
        now = time.perf_counter()
        for s in range(self.S):
            rid = self._slot_req[s]
            if rid is not None and now > self._deadline.get(rid, np.inf):
                self._evicted.add(rid)
                self._finish_cancelled(s, rid)
            pend = self._slot_pending[s]
            if pend is not None and now > self._deadline.get(pend["rid"], np.inf):
                self._evicted.add(pend["rid"])
                self._finish_cancelled(s, pend["rid"])
                self._slot_pending[s] = None
        keep = []
        for rid, data in self._queue:
            if now > self._deadline.get(rid, np.inf):
                self._evicted.add(rid)
                self._drop_queued(rid, now)
            else:
                keep.append((rid, data))
        self._queue = keep

    def _admit_with_prefix(self, s: int, rid, data: Mapping[str, Any]) -> None:
        """Copy a registered prefix row into slot s (no prefill) and append
        the suffix, right-padded to ``suffix_pad`` when that is set."""
        cache1, logits0, rope0, slot0, r0, s0 = self._prefixes[data["prefix"]]
        self._admit(s, cache1, logits0, rope0, slot0)
        suffix = data.get("input_ids")
        tlen = 0
        if suffix is not None and len(suffix) > 0:
            suffix = np.asarray(suffix, np.int64)
            msk = np.asarray(data.get("input_mask", np.ones(suffix.shape[0], np.int64)),
                             np.int64)
            pad = self.suffix_pad
            if pad is not None and suffix.shape[0] < pad:
                ext = pad - suffix.shape[0]
                suffix = np.concatenate([suffix, np.zeros(ext, np.int64)])
                msk = np.concatenate([msk, np.zeros(ext, np.int64)])
            self._extend(s, suffix, msk, r0, s0)
            tlen = int(msk.sum())
        self._set_controls(s, rid, data)
        self._slot_start[s] = (r0 + tlen, s0 + tlen)

    @staticmethod
    def _stop_hit(toks: List[int], stops: List[List[int]]) -> int:
        """The length of the stop sequence ``toks`` ends with, else 0."""
        for seq in stops:
            n = len(seq)
            if n and len(toks) >= n and toks[-n:] == seq:
                return n
        return 0

    @torch.inference_mode()
    def step(self) -> List[Any]:
        """Retire cancelled slots, evict overdue requests, append pending
        chunks, admit from the queue, decode one window over the pool, and
        retire finished requests. Returns the ids retired in this window."""
        for s in range(self.S):
            rid = self._slot_req[s]
            if rid is not None and rid in self._cancelled:
                self._finish_cancelled(s, rid)
        self._evict_overdue()
        self._advance_pending()
        self._admit_waiting()
        self._timeline.append((sum(r is not None for r in self._slot_req), len(self._queue)))
        active_py = [r is not None for r in self._slot_req]
        if self._state is None or not any(active_py):
            return []
        toks_host = self._window(active_py, bool((self._slot_temp[active_py] > 0).any()))
        retired = []
        now = time.perf_counter()
        for s in range(self.S):
            rid = self._slot_req[s]
            if rid is None:
                continue
            if not self._slot_toks[s]:
                self._t_first[rid] = now  # the first token landed in this window
            for h in range(self.H):
                tok = int(toks_host[s, h])
                self._slot_toks[s].append(tok)
                cut = self._stop_hit(self._slot_toks[s], self._slot_stop[s])
                if cut:
                    del self._slot_toks[s][-cut:]
                if tok == self.eos_id or cut or len(self._slot_toks[s]) >= self._slot_budget[s]:
                    self._done[rid] = list(self._slot_toks[s])
                    self._latency[rid] = now - self._t_submit[rid]
                    self._deadline.pop(rid, None)
                    self._slot_req[s] = None
                    if rid in self._session_req:
                        # hold the row; the EOS token stays in the conversation
                        kept = len(self._done[rid]) + cut
                        r0, s0 = (int(torch.as_tensor(x).reshape(-1)[0])
                                  for x in self._slot_start[s])
                        self._slot_held[s] = rid
                        self._sessions[rid] = (s, r0 + kept, s0 + kept)
                    retired.append(rid)
                    break  # the window's tokens after the end are dropped
        return retired

    # -- multi-turn sessions ----------------------------------------------
    @torch.inference_mode()
    def continue_session(self, session_id, new_request_id, data: Mapping[str, Any]) -> None:
        """Append the next turn (data: ``input_ids`` [Lt], ``input_mask``?,
        ``max_new``?) to a held session's row and resume decoding under
        ``new_request_id``; the history is never prefilled again."""
        if session_id not in self._sessions:
            raise KeyError(f"no held session {session_id!r}")
        s, rope_c, slot_c = self._sessions.pop(session_id)
        self._session_req.discard(session_id)
        tokens = np.asarray(data["input_ids"], np.int64)
        mask = np.asarray(data.get("input_mask", np.ones(tokens.shape[0], np.int64)), np.int64)
        self._extend(s, tokens, mask, rope_c, slot_c)
        tlen = int(mask.sum())
        self._slot_held[s] = None
        self._set_controls(s, new_request_id, data)
        self._slot_start[s] = (rope_c + tlen, slot_c + tlen)
        if data.get("session") or new_request_id in self._session_req:
            self._session_req.add(new_request_id)
        self._t_submit.setdefault(new_request_id, time.perf_counter())

    def close_session(self, session_id) -> None:
        """Free a held session's slot back to the pool."""
        if session_id in self._sessions:
            s, _, _ = self._sessions.pop(session_id)
            self._slot_held[s] = None
        self._session_req.discard(session_id)

    def run(self, requests: List[Tuple[Any, Mapping[str, Any]]]) -> Dict[str, Any]:
        """Drive a whole workload; returns ``stats`` over it."""
        for rid, data in requests:
            self.submit(rid, data)
        t0 = time.perf_counter()
        while self._queue or any(r is not None for r in self._slot_req) \
                or any(p is not None for p in self._slot_pending):
            self.step()
        return self.stats(time.perf_counter() - t0)

    def stats(self, wall: float) -> Dict[str, Any]:
        """Outputs and timings of everything retired since the last reset:
        latency, TTFT (submit to the window of the first token), TPOT (the
        mean time between later tokens), slot use and queue depth a step."""
        total_tokens = sum(len(v) for v in self._done.values())
        lat = sorted(self._latency.values())
        ttft = sorted(self._t_first[r] - self._t_submit[r] for r in self._done
                      if r in self._t_first)
        tpot = sorted((self._latency[r] - (self._t_first[r] - self._t_submit[r]))
                      / max(len(self._done[r]) - 1, 1) for r in self._done
                      if r in self._t_first)

        def pct(xs, q):
            return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else 0.0

        occ = [a for a, _ in self._timeline]
        qd = sorted(q for _, q in self._timeline)
        return {
            "outputs": dict(self._done),
            "cancelled": set(self._cancelled),
            "evicted": set(self._evicted),
            "wall_s": wall,
            "total_tokens": total_tokens,
            "tokens_per_s": total_tokens / max(wall, 1e-9),
            "latency_p50": pct(lat, 0.5),
            "latency_max": lat[-1] if lat else 0.0,
            "ttft_p50": pct(ttft, 0.5), "ttft_p99": pct(ttft, 0.99),
            "tpot_p50": pct(tpot, 0.5), "tpot_p99": pct(tpot, 0.99),
            "slot_utilization": (float(np.mean(occ)) / self.S) if occ else 0.0,
            "queue_depth_p50": pct(qd, 0.5),
            "queue_depth_max": qd[-1] if qd else 0,
            "steps": len(self._timeline),
        }
