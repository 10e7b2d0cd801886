"""Text processors: BERT tokenization and masked-LM target synthesis.

Own copy of ``antmmf_tpu/datasets/processors/text_processors.py``'s
``MaskedTokenProcessor``: ``input_ids`` int64[L] = [CLS] a [SEP] (b [SEP])
padded with 0, ``input_mask`` 1 on real tokens, ``segment_ids`` 0/1, and
``lm_label_ids``: -1 except at masked positions, which hold the original
token's id. A positive masking probability (``probability``, else the
``mask_probability`` config, default 0.15) masks:

* candidates are single tokens, or with ``wwm`` (``whole_word_masking``) or
  ``significant_masking`` whole words (a start token and its ``##``
  continuations); [CLS] and [SEP] never;
* a candidate is taken with the probability, times its word's significance
  multiplier under ``significant_masking`` (``significant_boost`` for a
  listed term, or without a list for a word of 4+ characters; its inverse
  for an unlisted term, a stopword or a word of 2 characters or fewer);
* each token of a taken candidate becomes [MASK] (80 %), a random vocabulary
  token (10 %) or stays (10 %).

The draws come from one numpy ``default_rng(seed)`` a processor (``seed``
config, default None), in the JAX package's order: ``random()`` for each
candidate, then for each of its tokens ``random()`` and, on the random
branch, ``integers(0, len(vocabulary))``; so the same seed gives the same
ids and labels. ``trim_start_token`` drops the [CLS] position.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from antmmf_torch.common.constants import LM_IGNORE_INDEX
from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.utils.tokenization import CLS_TOKEN, SEP_TOKEN, BertTokenizer

DEFAULT_VOCAB = "tests/data/vocabs/bert-base-uncased_30522_vocab.txt"
MASK_TOKEN = "[MASK]"


def _resolve_vocab_path(path: str) -> str:
    """``path`` as given, else under the working directory or the repository
    root (and their ``tests/data``)."""
    if os.path.exists(path):
        return path
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for root in (os.getcwd(), os.path.join(os.getcwd(), "tests", "data"),
                 repo_root, os.path.join(repo_root, "tests", "data")):
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"Vocab file not found: {path!r}")


@registry.register_processor("masked_token")
@registry.register_processor("masked_bert_tokenizer")
class MaskedTokenProcessor(BaseProcessor):
    """Tokenize (a, optional b) into BERT input arrays with MLM targets."""

    _STOPWORDS = {
        "a", "an", "the", "is", "are", "was", "were", "be", "been", "being",
        "to", "of", "in", "on", "at", "by", "for", "with", "and", "or", "but",
        "it", "its", "this", "that", "these", "those", "as", "from", "into",
    }

    def __init__(self, config: Optional[Mapping[str, Any]] = None):
        super().__init__(config)
        cfg = self.config
        self.tokenizer = BertTokenizer(_resolve_vocab_path(cfg.get("vocab_file", DEFAULT_VOCAB)),
                                       do_lower_case=bool(cfg.get("do_lower_case", True)))
        self.vocab_size = len(self.tokenizer.vocab)
        self.max_seq_length = int(cfg.get("max_seq_length", 128))
        self.mask_probability = float(cfg.get("mask_probability", 0.15))
        self.whole_word_masking = bool(cfg.get("wwm", cfg.get("whole_word_masking", False)))
        self.trim_start_token = bool(cfg.get("trim_start_token", False))
        self.significant_masking = bool(cfg.get("significant_masking", False))
        self.significant_boost = float(cfg.get("significant_boost", 2.0))
        terms = cfg.get("significant_terms", [])
        if cfg.get("significant_terms_file"):
            with open(cfg["significant_terms_file"], encoding="utf-8") as f:
                terms = [line.strip() for line in f if line.strip()]
        self.significant_terms = set(terms)
        self.rng = np.random.default_rng(cfg.get("seed", None))

    def __call__(self, item: Mapping[str, Any],
                 probability: Optional[float] = None) -> Dict[str, Any]:
        prob = self.mask_probability if probability is None else float(probability)
        text_a = item.get("text", item.get("text_a", ""))
        text_b = item.get("text_b", None)
        tokens_a = self.tokenizer.tokenize(text_a)
        tokens_b = self.tokenizer.tokenize(text_b) if text_b else None
        self._truncate(tokens_a, tokens_b)

        tokens = [CLS_TOKEN] + tokens_a + [SEP_TOKEN]
        segment_ids = [0] * len(tokens)
        if tokens_b:
            tokens += tokens_b + [SEP_TOKEN]
            segment_ids += [1] * (len(tokens_b) + 1)
        lm_labels = [LM_IGNORE_INDEX] * len(tokens)
        if prob > 0:
            tokens, lm_labels = self._mask(tokens, prob)
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        L = self.max_seq_length
        pad = L - len(ids)
        out = {
            "input_ids": np.asarray(ids + [0] * pad, dtype=np.int64)[:L],
            "input_mask": np.asarray([1] * len(ids) + [0] * pad, dtype=np.int64)[:L],
            "segment_ids": np.asarray(segment_ids + [0] * pad, dtype=np.int64)[:L],
            "lm_label_ids": np.asarray(lm_labels + [LM_IGNORE_INDEX] * pad, dtype=np.int64)[:L],
        }
        if self.trim_start_token:
            out = {k: v[1:] for k, v in out.items()}
        return out

    def _truncate(self, tokens_a: List[str], tokens_b: Optional[List[str]]) -> None:
        """Reserve [CLS] a [SEP] (+ b [SEP]) within ``max_seq_length``."""
        if tokens_b is None:
            del tokens_a[self.max_seq_length - 2:]
            return
        while len(tokens_a) + len(tokens_b) > self.max_seq_length - 3:
            longer = tokens_a if len(tokens_a) >= len(tokens_b) else tokens_b
            longer.pop()

    def _word_significance(self, tokens: List[str], span: List[int]) -> float:
        """The masking-probability multiplier of a whole-word span."""
        word = "".join(tokens[i].replace("##", "") for i in span)
        if self.significant_terms:
            return self.significant_boost if word in self.significant_terms \
                else 1.0 / self.significant_boost
        if word in self._STOPWORDS or len(word) <= 2:
            return 1.0 / self.significant_boost
        return self.significant_boost if len(word) >= 4 else 1.0

    @staticmethod
    def _candidates(tokens: List[str], whole_words: bool) -> List[List[int]]:
        """Single non-special tokens, or whole words: a start token that is
        neither special nor a ``##`` continuation, with its continuations."""
        special = (CLS_TOKEN, SEP_TOKEN)
        if not whole_words:
            return [[i] for i, t in enumerate(tokens) if t not in special]
        spans = []
        for i, t in enumerate(tokens):
            if t in special or t.startswith("##"):
                continue
            j = i + 1
            while j < len(tokens) and tokens[j].startswith("##"):
                j += 1
            spans.append(list(range(i, j)))
        return spans

    def _mask(self, tokens: List[str], prob: float):
        tokens = list(tokens)
        labels = [LM_IGNORE_INDEX] * len(tokens)
        for span in self._candidates(tokens, self.whole_word_masking or self.significant_masking):
            p = prob
            if self.significant_masking:
                p = min(1.0, prob * self._word_significance(tokens, span))
            if self.rng.random() >= p:
                continue
            for i in span:
                labels[i] = self.tokenizer.convert_tokens_to_ids([tokens[i]])[0]
                r = self.rng.random()
                if r < 0.8:
                    tokens[i] = MASK_TOKEN
                elif r < 0.9:
                    tokens[i] = self.tokenizer.convert_ids_to_tokens(
                        [int(self.rng.integers(0, self.vocab_size))])[0]
        return tokens, labels
