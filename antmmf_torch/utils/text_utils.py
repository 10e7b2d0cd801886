"""Batched beam search over torch tensors.

Port of ``antmmf_tpu/utils/text_utils.py``'s ``beam_search`` (re-encode the
prefix every step) and ``beam_search_cached`` (one token a step against a
cache that is reordered with the beams), as Python loops over the same
batched-beam algorithm, step for step:

* ``B`` rows of ``K`` beams; a finished beam is frozen: its only candidate
  is EOS at log-probability 0, so its score stays;
* each step takes the ``K`` best of the ``K·V`` candidates of a row
  (``top_k``), splits each index into the beam it extends (``// V``) and
  the token (``% V``), and gathers the beams' tokens, finished flags and,
  for the cached search, cache rows;
* the best beam of a row is the argmax of score / length^penalty, the
  length counting the tokens that are not EOS, plus one.

Ties are decided as ``jax.lax.top_k`` decides them, lower flat index first:
``top_k`` here is a stable descending sort (``torch.topk`` makes no such
promise).

Nucleus sampling (``nucleus_sampling`` re-encoding, ``nucleus_sampling_cached``
against the cache) keeps the JAX package's nucleus: ``top_p_filter`` is
its ``sample_one`` filter (logits / temperature, no clamp; the cutoff is
the sorted logit at index count(cum < top_p), and where that index is V
every logit is kept, as JAX's out-of-bounds gather gives NaN). At top_p
1.0 every logit is kept: JAX's result where its fp32 cumsum ends below
1.0; where the sum rounds to 1.0 or above, JAX drops the last logits, whose
mass is below that rounding (XLA's CPU cumsum adds in blocks of 16, torch
in another order, and neither reproduces the other's softmax bits). The serving engine's filter
(``nucleus_filter``) is JAX's ``_step_sample``: the temperature clamped at
1e-6 and the index at V - 1. The draw is the port's own, not JAX's
threefry stream: a Gumbel-max over uniforms hashed from (a seed, the
token's absolute position, the vocabulary index) on the tensors' device
(``position_uniforms``), so a sampled token is a pure function of the seed,
the logits and its position, and the card and the CPU draw the same
uniforms. ``beam_search`` and ``nucleus_sampling`` are registered as the
JAX package's decoders of those names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from antmmf_torch.common.registry import registry

NEG_INF = -1e9  # a finished beam's other tokens, and the logit below a nucleus cutoff
_MASK32 = 0xFFFFFFFF


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``x`` [B, N] and their
    indices, ties in order of index (``jax.lax.top_k``'s rule)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def _frozen(V: int, eos_id: int, device) -> torch.Tensor:
    """A finished beam's next-token log-probabilities: EOS at 0, else NEG_INF."""
    frozen = torch.full((V,), NEG_INF, device=device)
    frozen[eos_id] = 0.0
    return frozen


def _expand(tokens, scores, finished, logits, eos_id: int, t: int):
    """One step of the batched beam: tokens int[B, K, T], scores f32[B, K],
    finished bool[B, K], logits [B·K, V] for the next token. Writes the
    chosen tokens at column ``t``; returns (tokens, scores, finished, beam_idx)."""
    B, K = scores.shape
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    logp = torch.where(finished[:, :, None], _frozen(V, eos_id, logits.device), logp)
    top_scores, top_idx = top_k((scores[:, :, None] + logp).reshape(B, K * V), K)
    beam_idx, tok_idx = top_idx // V, top_idx % V
    tokens = torch.gather(tokens, 1, beam_idx[:, :, None].expand(-1, -1, tokens.shape[2]))
    tokens[:, :, t] = tok_idx
    finished = torch.gather(finished, 1, beam_idx) | (tok_idx == eos_id)
    return tokens, top_scores, finished, beam_idx


def _best(tokens, scores, eos_id: int, length_penalty: float):
    """(best beam's tokens int[B, T], its normalised score f32[B])."""
    lengths = (tokens != eos_id).sum(dim=-1) + 1
    norm = scores / lengths.float() ** length_penalty
    best = norm.argmax(dim=-1)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    return tokens[rows, best], norm[rows, best]


def beam_search(logits_fn: Callable[[torch.Tensor], torch.Tensor], bos: torch.Tensor,
                eos_id: int, max_length: int = 20, num_beams: int = 4,
                length_penalty: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequences int[B, max_length], scores f32[B]) of each row's best beam.

    ``logits_fn(tokens int[B·K, max_length]) -> f32[B·K, V]`` scores the next
    token after each row's prefix (the tokens past it are EOS)."""
    B, K = bos.shape[0], num_beams
    device = bos.device
    tokens = torch.full((B, K, max_length), eos_id, dtype=torch.long, device=device)
    tokens[:, :, 0] = bos[:, None]
    # beam 0 alive, the others at NEG_INF, so the first step expands beam 0 only
    scores = torch.full((B, K), NEG_INF, device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=device)
    for t in range(1, max_length):
        logits = logits_fn(tokens.reshape(B * K, max_length))
        tokens, scores, finished, _ = _expand(tokens, scores, finished, logits, eos_id, t)
    return _best(tokens, scores, eos_id, length_penalty)


def beam_search_cached(decode_fn: Callable, init_logits: torch.Tensor, cache: Any,
                       start_pos: torch.Tensor, eos_id: int, max_new: int = 20,
                       num_beams: int = 4, length_penalty: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cache beam search: (best tokens int[B, max_new], scores f32[B]).

    ``init_logits`` f32[B, V] are the next-token logits after the prefix;
    ``cache`` is a list of {"k", "v"} tensors with B leading rows, expanded
    here to B·K rows and reordered with the beams every step;
    ``decode_fn(tokens int[N], pos int[N], cache) -> (logits f32[N, V],
    cache)`` scores one token a row and writes its k/v at ``pos``."""
    B, V = init_logits.shape
    K = num_beams
    device = init_logits.device
    scores, tok0 = top_k(torch.log_softmax(init_logits.float(), dim=-1), K)
    tokens = torch.full((B, K, max_new), eos_id, dtype=torch.long, device=device)
    tokens[:, :, 0] = tok0
    finished = tok0 == eos_id
    cache = [{n: c.repeat_interleave(K, dim=0) for n, c in layer.items()} for layer in cache]
    pos = start_pos.repeat_interleave(K)
    rows = torch.arange(B, device=device)[:, None] * K
    for t in range(1, max_new):
        logits, cache = decode_fn(tokens[:, :, t - 1].reshape(B * K), pos + t - 1, cache)
        tokens, scores, finished, beam_idx = _expand(tokens, scores, finished, logits,
                                                     eos_id, t)
        flat = (rows + beam_idx).reshape(B * K)
        cache = [{n: c.index_select(0, flat) for n, c in layer.items()} for layer in cache]
    return _best(tokens, scores, eos_id, length_penalty)


# ------------------------------------------------------------------ sampling
def nucleus_filter(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor
                   ) -> torch.Tensor:
    """The serving engine's filter, JAX's ``_step_sample``: logits [S, V] /
    max(temperature, 1e-6), sorted descending, softmax, cumsum; the cutoff
    is the sorted value at index count(cum < top_p) (at most V - 1), and
    every logit below it becomes -1e9."""
    lg = logits.float() / temps.clamp(min=1e-6)[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    idx = (cum < top_ps[:, None]).sum(-1).clamp(max=lg.shape[-1] - 1)
    cutoff = torch.gather(srt, -1, idx[:, None])
    return torch.where(lg < cutoff, NEG_INF, lg)


def top_p_filter(logits: torch.Tensor, top_p: float, temperature: float) -> torch.Tensor:
    """``generate``'s filter, JAX's ``sample_one``: logits [B, V] divided by
    ``temperature`` as given; the cutoff is the sorted logit at index
    count(cum < top_p), and a row whose index is V (fp32's cumsum ended
    below ``top_p``), or any row at ``top_p`` >= 1, keeps every logit."""
    lg = logits.float() / temperature
    srt = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    idx = (cum < top_p).sum(-1, keepdim=True)
    V = lg.shape[-1]
    cutoff = torch.gather(srt, -1, idx.clamp(max=V - 1))
    cutoff = torch.where((idx < V) & (top_p < 1.0), cutoff, float("-inf"))
    return torch.where(lg < cutoff, NEG_INF, lg)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32) on int64 holding uint32."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def position_uniforms(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Uniforms in (0, 1) [S, vocab], a pure function of each row's (seed,
    position) and the vocabulary index: 23-bit hashes of the three, centred
    in their cells, so that every value and its half-step offset are exact
    in fp32 (with 24 bits the top cell rounds to 1.0, whose Gumbel noise is
    infinite)."""
    h = _mix32(seeds.long() & _MASK32)
    h = _mix32(h ^ ((positions.long() * 0x9E3779B1) & _MASK32))
    v = torch.arange(vocab, device=seeds.device, dtype=torch.long)
    x = _mix32((h[:, None] + v[None] * 0x85EBCA6B) & _MASK32)
    return ((x >> 9).float() + 0.5) / float(1 << 23)


def gumbel_draw(filtered: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
    """One token a row from the softmax of ``filtered`` [S, V]: the argmax of
    the logits plus Gumbel noise from ``position_uniforms``."""
    u = position_uniforms(seeds, positions, filtered.shape[-1])
    return (filtered - torch.log(-torch.log(u))).argmax(dim=-1)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                  seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The engine's token a row: the greedy argmax where the temperature is
    0, else a Gumbel-max draw from the ``nucleus_filter``-ed logits."""
    greedy = logits.argmax(dim=-1)
    sampled = gumbel_draw(nucleus_filter(logits, temps, top_ps), seeds, positions)
    return torch.where(temps > 0, sampled, greedy)


def row_seeds(seed: int, rows: int, device=None) -> torch.Tensor:
    """One seed a row of a batch drawn under one integer ``seed``: rows at
    the same position draw apart."""
    base = _mix32(torch.tensor([int(seed) & _MASK32], dtype=torch.long, device=device))
    return (base + torch.arange(rows, device=device) * 0x632BE5AB) & _MASK32


def nucleus_sampling_cached(decode_fn: Callable, init_logits: torch.Tensor, cache: Any,
                            start_pos: torch.Tensor, seed: int, eos_id: int, max_new: int = 20,
                            top_p: float = 0.9, temperature: float = 1.0,
                            draw_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-cache top-p sampling: tokens int[B, max_new]. ``decode_fn(tokens
    int[B], pos int[B], cache) -> (logits f32[B, V], cache)`` scores one
    token a row written at ``pos`` = ``start_pos + t - 1``; token t is drawn
    at absolute position ``draw_pos + t`` (``start_pos`` unless given: a
    model whose RoPE positions differ from its cache slots passes its RoPE
    stream). A row that has drawn ``eos_id`` keeps emitting it."""
    B = init_logits.shape[0]
    seeds = row_seeds(seed, B, init_logits.device)
    draw_pos = start_pos if draw_pos is None else draw_pos
    tokens = torch.full((B, max_new), eos_id, dtype=torch.long, device=init_logits.device)

    def sample(logits, t):
        return gumbel_draw(top_p_filter(logits, top_p, temperature), seeds, draw_pos + t)

    tokens[:, 0] = sample(init_logits, 0)
    done = tokens[:, 0] == eos_id
    for t in range(1, max_new):
        logits, cache = decode_fn(tokens[:, t - 1], start_pos + t - 1, cache)
        nxt = torch.where(done, eos_id, sample(logits, t))
        tokens[:, t] = nxt
        done = done | (nxt == eos_id)
    return tokens


def nucleus_sampling(logits_fn: Callable[[torch.Tensor], torch.Tensor], bos: torch.Tensor,
                     seed: int, eos_id: int, max_length: int = 20, top_p: float = 0.9,
                     temperature: float = 1.0) -> torch.Tensor:
    """Top-p sampling by re-encoding: sequences int[B, max_length] from
    ``bos``. ``logits_fn(tokens int[B, max_length]) -> f32[B, V]`` scores
    the next token (the tokens past the prefix are EOS); column t is drawn
    at position t."""
    B = bos.shape[0]
    seeds = row_seeds(seed, B, bos.device)
    tokens = torch.full((B, max_length), eos_id, dtype=torch.long, device=bos.device)
    tokens[:, 0] = bos
    done = torch.zeros(B, dtype=torch.bool, device=bos.device)
    for t in range(1, max_length):
        filtered = top_p_filter(logits_fn(tokens), top_p, temperature)
        pos = torch.full((B,), t, dtype=torch.long, device=bos.device)
        nxt = torch.where(done, eos_id, gumbel_draw(filtered, seeds, pos))
        tokens[:, t] = nxt
        done = done | (nxt == eos_id)
    return tokens


@registry.register_decoder("beam_search")
class BeamSearchDecoder:
    """``beam_search`` with the decoder block's parameters under the call's."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self.params = dict(params or {})

    def __call__(self, logits_fn, bos, **kw):
        merged = {**self.params, **kw}
        return beam_search(logits_fn, bos, eos_id=int(merged.get("eos_id", 102)),
                           max_length=int(merged.get("max_length", 20)),
                           num_beams=int(merged.get("num_beams", 4)),
                           length_penalty=float(merged.get("length_penalty", 1.0)))


@registry.register_decoder("nucleus_sampling")
class NucleusSamplingDecoder:
    """``nucleus_sampling``; ``sum_threshold`` (the reference's name) or
    ``top_p``; ``seed`` takes the place of JAX's ``rng``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self.params = dict(params or {})

    def __call__(self, logits_fn, bos, seed: int = 0, **kw):
        merged = {**self.params, **kw}
        return nucleus_sampling(logits_fn, bos, seed, eos_id=int(merged.get("eos_id", 102)),
                                max_length=int(merged.get("max_length", 20)),
                                top_p=float(merged.get("sum_threshold", merged.get("top_p", 0.9))),
                                temperature=float(merged.get("temperature", 1.0)))
