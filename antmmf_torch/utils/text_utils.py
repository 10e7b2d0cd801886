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
promise). Nucleus sampling is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

NEG_INF = -1e9


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
