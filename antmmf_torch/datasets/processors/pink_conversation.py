"""Pink conversation templates and answer-only label masking.

Own copy of ``antmmf_tpu/datasets/processors/pink_conversation.py``:

* ``ConversationTemplate`` renders a conversation in one of four separator
  styles (``single``, ``two``, ``llama2``, ``mpt``); ``CONV_TEMPLATES``
  holds ``llamav1``, ``llamav2``, ``vicuna_v1_1`` and ``mpt``;
* ``build_prompt`` puts ``"Image: " + N × <im_patch>`` (or ``"Image:
  N/A"``) in the system slot and renders the turns;
* ``construct_target`` tokenises each round's instruction, answer and round
  separator on their own and concatenates them, so ids and labels are built
  together: the instruction and its role marker are ``IGNORE_INDEX``, the
  answer and its separator supervise, BOS appears once and never
  supervises (the reference counts tokens instead, which assumes LLaMA's
  tokenizer and drifts with another);
* ``PinkConversationProcessor`` (``pink_conversation``) turns
  ``{"conversations": [{"from", "value"}, ...], "has_image"}`` into
  ``input_ids``, ``input_mask`` and ``labels`` int64[max_length]: BOS
  (``[CLS]``'s id unless ``bos_id`` is given), then wordpieces from the
  port's ``MaskedTokenProcessor`` at masking 0 (no draw), each
  ``<im_patch>`` as ``im_patch_id``; cut at ``max_length``, padded with 0
  and ``IGNORE_INDEX``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor

IGNORE_INDEX = -100
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
PREFIX_IMAGE = "Image: "
PREFIX_NO_IMAGE = "Image: N/A"


@dataclass
class ConversationTemplate:
    """One chat format."""

    system: str
    roles: Tuple[str, str]
    sep_style: str  # "single" | "two" | "llama2" | "mpt"
    sep: str
    sep2: Optional[str] = None

    @property
    def sep_template(self) -> str:
        if self.sep_style == "llama2":
            return self.sep + self.roles[1] + " "
        return self.sep + self.roles[1] + ": "

    @property
    def system_template(self) -> str:
        if self.sep_style == "llama2":
            return "[INST] <<SYS>>\n{}\n<</SYS>>\n\n"
        return "{}"

    def render(self, system: str, messages: Sequence[Tuple[str, Optional[str]]]) -> str:
        """The prompt of ``messages`` after the formatted ``system`` string."""
        if self.sep_style == "single":
            ret = system + self.sep if system else ""
            for role, msg in messages:
                ret += (role + ": " + msg + self.sep) if msg else (role + ":")
            return ret
        if self.sep_style == "two":
            seps = [self.sep, self.sep2]
            ret = system + seps[0] if system else ""
            for i, (role, msg) in enumerate(messages):
                ret += (role + ": " + msg + seps[i % 2]) if msg else (role + ":")
            return ret
        if self.sep_style == "llama2":
            seps = [self.sep, self.sep2]
            ret = system if system else "[INST] "
            for i, (role, msg) in enumerate(messages):
                if not msg:
                    ret += role
                elif i == 0:
                    ret += msg + " "
                else:
                    ret += role + " " + msg + seps[i % 2]
            return ret
        if self.sep_style == "mpt":
            ret = system + self.sep if system else ""
            for role, msg in messages:
                ret += (role + msg + self.sep) if msg else role
            return ret
        raise ValueError(f"Unknown sep_style {self.sep_style!r}")


CONV_TEMPLATES: Dict[str, ConversationTemplate] = {
    "llamav1": ConversationTemplate(
        system="", roles=("USER", "ASSISTANT"), sep_style="two", sep="\n", sep2="</s>"),
    "llamav2": ConversationTemplate(
        system="", roles=("[INST]", "[/INST]"), sep_style="llama2", sep=" ",
        sep2=" </s><s>"),
    "vicuna_v1_1": ConversationTemplate(
        system="A chat between a curious user and an artificial intelligence assistant. "
               "The assistant gives helpful, detailed, and polite answers to the user's "
               "questions.",
        roles=("USER", "ASSISTANT"), sep_style="two", sep=" ", sep2="</s>"),
    "mpt": ConversationTemplate(
        system="<|im_start|>system\n- You are a helpful language and vision assistant.",
        roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), sep_style="mpt",
        sep="<|im_end|>"),
}


def build_prompt(template: ConversationTemplate, conversations: Sequence[Mapping[str, str]],
                 has_image: bool, num_patch_tokens: int) -> str:
    """The item's prompt: the image line in the system slot, then the turns."""
    system = template.system_template.format(
        (PREFIX_IMAGE + num_patch_tokens * DEFAULT_IMAGE_PATCH_TOKEN) if has_image
        else PREFIX_NO_IMAGE)
    role_of = {"human": template.roles[0], "gpt": template.roles[1],
               "user": template.roles[0], "assistant": template.roles[1]}
    messages = [(role_of.get(m.get("from", "human"), template.roles[0]), m.get("value"))
                for m in conversations]
    return template.render(system, messages)


def construct_target(prompt: str, template: ConversationTemplate,
                     tokenize: Callable[[str], List[int]]) -> Tuple[List[int], List[int]]:
    """(ids, labels) of ``prompt``, segment by segment: each round's
    instruction and role marker unsupervised, its answer and round separator
    supervised; a chunk without the separator template unsupervised."""
    if template.sep2 is None:
        raise ValueError("construct_target needs a two-separator template (sep2); "
                         f"template with sep_style={template.sep_style!r} has none")
    sep = template.sep_template
    rounds = prompt.split(template.sep2)
    inputs: List[int] = []
    target: List[int] = []

    def seg(text: str, supervise: bool) -> None:
        if not text:
            return
        ids = tokenize(text)[0 if not inputs else 1:]  # BOS once, at the start
        tg = list(ids) if supervise else [IGNORE_INDEX] * len(ids)
        if supervise and not inputs:
            tg[0] = IGNORE_INDEX  # BOS never supervises
        inputs.extend(ids)
        target.extend(tg)

    for i, rou in enumerate(rounds):
        if rou == "":
            continue
        parts = rou.split(sep)
        if len(parts) != 2:
            seg(rou, False)
            continue
        seg(parts[0] + sep, False)
        # the split removed exactly one sep2 after every round but the last
        seg(parts[1] + (template.sep2 if i < len(rounds) - 1 else ""), True)
    return inputs, target


@registry.register_processor("pink_conversation")
class PinkConversationProcessor(BaseProcessor):
    """{'conversations': [...], 'has_image': bool} → {'input_ids',
    'input_mask', 'labels'} int64[max_length] and the ``prompt``."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *args, **kwargs):
        super().__init__(config)
        cfg = self.config
        self.template_name = str(cfg.get("template", "llamav1"))
        if self.template_name not in CONV_TEMPLATES:
            raise KeyError(f"Unknown conversation template {self.template_name!r}; "
                           f"known: {sorted(CONV_TEMPLATES)}")
        self.template = CONV_TEMPLATES[self.template_name]
        if self.template.sep2 is None:
            raise ValueError(f"template {self.template_name!r} has no round separator (sep2): "
                             "label masking needs a two-separator format "
                             "(llamav1/llamav2/vicuna_v1_1)")
        self.num_patch_tokens = int(cfg.get("num_patch_tokens", 49))
        self.max_length = int(cfg.get("max_length", 256))
        self._text = MaskedTokenProcessor({**dict(cfg.get("text", {})), "mask_probability": 0.0,
                                           "max_seq_length": self.max_length})
        tok = self._text.tokenizer
        self.bos_id = int(cfg.get("bos_id", tok.convert_tokens_to_ids(["[CLS]"])[0]))
        self.im_patch_id = int(cfg.get("im_patch_id", 1))

    def tokenize(self, text: str) -> List[int]:
        """BOS, then wordpiece ids, each ``<im_patch>`` as ``im_patch_id``."""
        tok = self._text.tokenizer
        out = [self.bos_id]
        for i, piece in enumerate(text.split(DEFAULT_IMAGE_PATCH_TOKEN)):
            if i:
                out.append(self.im_patch_id)
            if piece:
                out.extend(tok.convert_tokens_to_ids(tok.tokenize(piece)))
        return out

    def __call__(self, item: Mapping[str, Any], *args, **kwargs) -> Dict[str, Any]:
        has_image = bool(item.get("has_image", item.get("image") is not None))
        prompt = build_prompt(self.template, item.get("conversations", []), has_image,
                              self.num_patch_tokens)
        inputs, target = construct_target(prompt, self.template, self.tokenize)
        L = self.max_length
        ids = np.zeros((L,), np.int64)
        mask = np.zeros((L,), np.int64)
        labels = np.full((L,), IGNORE_INDEX, np.int64)
        n = min(len(inputs), L)
        ids[:n] = inputs[:n]
        mask[:n] = 1
        labels[:n] = target[:n]
        return {"input_ids": ids, "input_mask": mask, "labels": labels, "prompt": prompt}
