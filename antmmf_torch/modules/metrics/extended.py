"""Host-side caption metrics.

Port of ``antmmf_tpu/modules/metrics/extended.py``'s ``bleu4`` (corpus
BLEU-4, uniform n-gram weights, brevity penalty; 0 when some order has no
match) and ``rouge_l`` (the LCS F-measure with β = 1.2), on token
sequences. The device metrics of that module are not ported yet.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np


def bleu4(candidates: Sequence[Sequence], references: Sequence[Sequence]) -> float:
    """Corpus BLEU-4 with uniform n-gram weights and brevity penalty."""
    c_len = r_len = 0
    clipped, totals = [0] * 4, [0] * 4
    for cand, ref in zip(candidates, references):
        cand, ref = list(cand), list(ref)
        c_len += len(cand)
        r_len += len(ref)
        for n in range(1, 5):
            c_ngrams = Counter(tuple(cand[i:i + n]) for i in range(len(cand) - n + 1))
            r_ngrams = Counter(tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
            clipped[n - 1] += sum((c_ngrams & r_ngrams).values())
            totals[n - 1] += sum(c_ngrams.values())
    if any(t == 0 or c == 0 for c, t in zip(clipped, totals)):
        return 0.0
    log_p = sum(0.25 * np.log(c / t) for c, t in zip(clipped, totals))
    bp = 1.0 if c_len > r_len else float(np.exp(1 - r_len / max(c_len, 1)))
    return float(bp * np.exp(log_p))


def rouge_l(candidate: Sequence, reference: Sequence) -> float:
    """ROUGE-L F-measure via the longest common subsequence."""
    m, n = len(candidate), len(reference)
    if m == 0 or n == 0:
        return 0.0
    dp = np.zeros((m + 1, n + 1), np.int32)
    for i in range(m):
        for j in range(n):
            dp[i + 1, j + 1] = dp[i, j] + 1 if candidate[i] == reference[j] \
                else max(dp[i, j + 1], dp[i + 1, j])
    lcs = dp[m, n]
    prec, rec = lcs / m, lcs / n
    if prec + rec == 0:
        return 0.0
    beta2 = 1.2 ** 2
    return float((1 + beta2) * prec * rec / (rec + beta2 * prec))
