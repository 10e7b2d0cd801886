"""Beam search in the port against the JAX package, on the CPU.

The next-token logits come from seeded numpy tables, the same function of
the prefix on both sides: A[last token] + P[its position] + S[sum of the
prefix's tokens mod V]. The re-encode search (``beam_search``) reads the
prefix from the token rows; the cached one (``beam_search_cached``) from a
cache of token slots that each step writes at the row's position and that
the search reorders with the beams, so a wrong row gather changes the
logits. Cases: K = 1, 3, 4 on continuous logits; EOS made likely from the
third step on, so beams finish early and stay frozen; and integer-valued
tables that plant exact ties in every step's top-k, which the port breaks
as ``jax.lax.top_k`` does, lower flat index first.

The tokens must equal JAX's exactly and the scores agree within 1e-5
(fp32, the same sums). Cached and re-encode run one algorithm, but the
cached search's length normalisation leaves BOS out (as in JAX), so their
scores differ by that and their best beams may part: the port's do exactly
where JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antmmf_torch.utils import text_utils as t_text
from antmmf_tpu.utils import text_utils as j_text
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

V, T, B, BOS, EOS = 12, 7, 3, 1, 2
SCORE_ATOL = 1e-5


def _tables(case):
    rng = np.random.default_rng({"plain": 0, "early_eos": 1, "ties": 2}[case])
    if case == "ties":  # few distinct integer values: exact ties everywhere
        A, P, S = (rng.integers(0, 3, shape).astype(np.float32)
                   for shape in ((V, V), (T, V), (V, V)))
    else:
        A, P, S = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((V, V), (T, V), (V, V)))
    if case == "early_eos":
        P[3:, EOS] += 10.0
    return A, P, S


def _jax_fns(A, P, S):
    A, P, S = map(jnp.asarray, (A, P, S))

    def logits_fn(tokens):  # [N, T]: the prefix, then EOS
        filled = jnp.sum(tokens != EOS, axis=-1) - 1
        last = jnp.take_along_axis(tokens, filled[:, None], axis=1)[:, 0]
        hist = jnp.sum(jnp.where(jnp.arange(T)[None] <= filled[:, None], tokens, 0), axis=-1)
        return A[last] + P[filled] + S[hist % V]

    def decode_fn(tok, pos, cache):
        h = cache[0]["h"].at[jnp.arange(tok.shape[0]), pos].set(tok)
        return A[tok] + P[pos] + S[h.sum(-1) % V], [{"h": h}]

    return logits_fn, decode_fn


def _torch_fns(A, P, S):
    A, P, S = map(torch.from_numpy, (A, P, S))

    def logits_fn(tokens):
        filled = (tokens != EOS).sum(dim=-1) - 1
        last = tokens.gather(1, filled[:, None])[:, 0]
        hist = torch.where(torch.arange(T)[None] <= filled[:, None], tokens, 0).sum(dim=-1)
        return A[last] + P[filled] + S[hist % V]

    def decode_fn(tok, pos, cache):
        h = cache[0]["h"]
        h[torch.arange(tok.shape[0]), pos] = tok  # in place, as the decoder's caches
        return A[tok] + P[pos] + S[h.sum(-1) % V], cache

    return logits_fn, decode_fn


def _init(A, P, S, lib):
    """Logits after the prefix [BOS] and a cache holding BOS at slot 0."""
    logits = np.broadcast_to(A[BOS] + P[0] + S[BOS % V], (B, V)).copy()
    h = np.zeros((B, T), np.int64)
    h[:, 0] = BOS
    if lib == "jax":
        return jnp.asarray(logits), [{"h": jnp.asarray(h, jnp.int32)}], jnp.ones((B,), jnp.int32)
    return torch.from_numpy(logits), [{"h": torch.from_numpy(h)}], torch.ones(B, dtype=torch.long)


def _run(case, K):
    tables = _tables(case)
    j_logits, j_decode = _jax_fns(*tables)
    t_logits, t_decode = _torch_fns(*tables)
    out = {}
    out["jax_reencode"] = j_text.beam_search(j_logits, jnp.full((B,), BOS, jnp.int32), EOS,
                                             max_length=T, num_beams=K)
    init, cache, start = _init(*tables, "jax")
    best, scores = j_text.beam_search_cached(j_decode, init, cache, start, EOS,
                                             max_new=T - 1, num_beams=K)
    out["jax_cached"] = (jnp.concatenate([jnp.full((B, 1), BOS, best.dtype), best], 1), scores)
    out["port_reencode"] = t_text.beam_search(t_logits, torch.full((B,), BOS), EOS,
                                              max_length=T, num_beams=K)
    init, cache, start = _init(*tables, "torch")
    best, scores = t_text.beam_search_cached(t_decode, init, cache, start, EOS,
                                             max_new=T - 1, num_beams=K)
    out["port_cached"] = (torch.cat([torch.full((B, 1), BOS), best], 1), scores)
    return {k: (np.asarray(t), np.asarray(s)) for k, (t, s) in out.items()}


CASES = [("plain", 1), ("plain", 3), ("plain", 4), ("early_eos", 3), ("early_eos", 4),
         ("ties", 3), ("ties", 4)]


@pytest.mark.parametrize("case,K", CASES, ids=[f"{c}_k{k}" for c, k in CASES])
def test_beam_search_matches_jax(case, K):
    runs = _run(case, K)
    for search in ("reencode", "cached"):
        (tj, sj), (tt, st) = runs[f"jax_{search}"], runs[f"port_{search}"]
        np.testing.assert_array_equal(tt, tj, err_msg=search)
        np.testing.assert_allclose(st, sj, atol=SCORE_ATOL, rtol=0, err_msg=search)
    # one algorithm over the same logits; only the best beam's pick may part,
    # as the cached search's lengths leave BOS out: the port parts where JAX does
    same = {side: np.array_equal(runs[f"{side}_cached"][0], runs[f"{side}_reencode"][0])
            for side in ("jax", "port")}
    assert same["port"] == same["jax"]
    tokens = runs["port_cached"][0]
    assert (tokens[:, 0] == BOS).all() and tokens.shape == (B, T)
    if case == "early_eos":  # a best beam ended early: EOS up to the end
        ended = [(row[1:-1] == EOS).any() for row in tokens]
        assert any(ended)
        for row in tokens:
            hits = np.nonzero(row == EOS)[0]
            if len(hits):
                assert (row[hits[0]:] == EOS).all()


def test_top_k_breaks_ties_by_lower_index_as_jax():
    """Rows with planted exact ties, from 5 entries to a caption step's
    4 × 30,522 candidates with few distinct values."""
    rng = np.random.default_rng(3)
    rows = [np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], np.float32),
            rng.integers(0, 4, (3, 4 * 30522)).astype(np.float32),
            np.round(rng.standard_normal((2, 4096)), 1).astype(np.float32)]
    for x in rows:
        for k in (k for k in (1, 3, 4, 16) if k <= x.shape[1]):
            jv, ji = jax.lax.top_k(jnp.asarray(x), k)
            tv, ti = t_text.top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
