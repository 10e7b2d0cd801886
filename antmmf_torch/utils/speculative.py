"""Prompt-lookup speculative greedy decoding: exact greedy tokens, fewer steps.

Port of ``antmmf_tpu/utils/speculative.py``. Each verify step feeds
``gamma + 1`` tokens through one chunked KV-cache call: the last emitted
token and ``gamma`` draft tokens proposed by matching the trailing
``ngram`` against the sequence so far (no draft model). The greedy tokens of
the chunk decide how many drafts are accepted, so the output is token for
token the greedy loop's; a bad draft only yields fewer tokens a step.

The state is one batch: the token buffer, ``count`` (tokens emitted a row),
``done``, ``last_tok`` and the cache; the loop runs while any row is active,
as JAX's ``while_loop`` does, with the same windowed per-row writes, the
same EOS cut (the first EOS among the accepted tokens, within the
``max_new - count - 1`` budget) and the same EOS padding at the end.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def propose_prompt_lookup(tokens: torch.Tensor, cur_len: torch.Tensor, last_tok: torch.Tensor,
                          gamma: int, ngram: int = 2) -> torch.Tensor:
    """``gamma`` draft tokens a row: the continuation of the most recent
    earlier occurrence of the trailing ``ngram`` of ``tokens`` [B, W] (valid
    in [0, cur_len)); a row without one proposes ``last_tok`` repeated."""
    B, W = tokens.shape
    start = (cur_len - ngram).clamp(0, W - ngram)  # dynamic_slice's clamp
    key = torch.gather(tokens, 1, start[:, None] + torch.arange(ngram, device=tokens.device))
    windows = tokens.unfold(1, ngram, 1)  # [B, W - ngram + 1, ngram]
    hit = (windows == key[:, None, :]).all(-1)
    t_axis = torch.arange(W - ngram + 1, device=tokens.device)
    # a candidate must sit strictly before the trailing occurrence
    hit &= (t_axis[None] + ngram) <= (cur_len - 1)[:, None]
    t_star = torch.where(hit, t_axis[None], -1).max(dim=1).values
    src = (t_star + ngram)[:, None] + torch.arange(gamma, device=tokens.device)[None]
    draft = torch.gather(tokens, 1, src.clamp(0, W - 1))
    return torch.where((t_star >= 0)[:, None], draft, last_tok[:, None])


def speculative_greedy(decode_chunk_fn: Callable, logits0: torch.Tensor, cache: Any,
                       tokens: torch.Tensor, lens: torch.Tensor, eos_id: int, max_new: int,
                       gamma: int = 4, ngram: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy decoding with prompt-lookup speculation.

    ``decode_chunk_fn(chunk int[B, gamma+1], start_off int[B], cache) ->
    (logits f32[B, gamma+1, V], cache)``: ``start_off`` counts the decode
    tokens already consumed (the chunk's first token was emitted as token
    #start_off + 1; the model maps it onto its slot and RoPE streams). The
    cache must hold lens.max() + max_new + gamma slots and ``tokens`` [B, W]
    (the prompt at [0, lens)) lens.max() + max_new + gamma + 1 columns.
    Returns (tokens with the generation after each prompt and EOS after an
    early stop, as the per-token loop writes them; n_generated int[B];
    the number of verify steps)."""
    B, W = tokens.shape
    K = gamma + 1
    device = tokens.device
    j_axis = torch.arange(K, device=device)
    rows = torch.arange(B, device=device)
    tokens = tokens.clone()
    first = logits0.argmax(dim=-1)  # token #0 comes from the prefill's logits
    tokens[rows, lens] = first
    done = first == eos_id
    count = torch.ones(B, dtype=torch.long, device=device)
    last_tok = first
    n_steps = 0
    while bool((~done & (count < max_new)).any()):
        draft = propose_prompt_lookup(tokens, lens + count, last_tok, gamma, ngram)
        chunk = torch.cat([last_tok[:, None], draft], dim=1)
        logits, cache = decode_chunk_fn(chunk, count - 1, cache)
        g = logits.argmax(dim=-1)  # [B, K] the greedy tokens
        # the longest draft prefix that matches the greedy continuation
        m = torch.cumprod((draft == g[:, :-1]).long(), dim=1).sum(1)
        m = torch.minimum(m, max_new - count - 1)  # the token budget
        eos_hit = (g == eos_id) & (j_axis[None] <= m[:, None])
        first_eos = torch.where(eos_hit.any(1), eos_hit.long().argmax(1), K)
        m = torch.minimum(m, first_eos)
        active = ~done & (count < max_new)
        n_emit = torch.where(active, m + 1, 0)
        cols = (lens + count).clamp(0, W - K)[:, None] + j_axis[None]
        window = torch.gather(tokens, 1, cols)
        tokens.scatter_(1, cols, torch.where(j_axis[None] < n_emit[:, None], g, window))
        last_tok = torch.where(n_emit > 0, g[rows, (n_emit - 1).clamp(min=0)], last_tok)
        done = done | (active & eos_hit.any(1))
        count = count + n_emit
        n_steps += 1
    p_axis = torch.arange(W, device=device)[None]
    pad = (p_axis >= (lens + count)[:, None]) & (p_axis < (lens + max_new)[:, None])
    return torch.where(pad, eos_id, tokens), count, n_steps
