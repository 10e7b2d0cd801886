"""Conversation templates for chat-tuned MLLMs (Pink / LLaVA class).

Own copy of ``antmmf_tpu/utils/conversation.py``: a ``Conversation`` record
(system prompt, roles, separator style) whose ``get_prompt`` assembles the
exact training/eval string, the template registry (vicuna v1, llama2, simple,
plain), and ``build_prompt`` (``antmmf_tpu/scripts/pink_eval.py``), which
renders one question with an open assistant turn.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"
    LLAMA2 = "llama2"
    PLAIN = "plain"


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]] = dataclasses.field(default_factory=list)
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "\n"
    sep2: str = "</s>"

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep if self.system else ""
            for role, message in self.messages:
                ret += f"{role}: {message}{self.sep}" if message else f"{role}:"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            ret = self.system + seps[0] if self.system else ""
            for i, (role, message) in enumerate(self.messages):
                ret += f"{role}: {message}{seps[i % 2]}" if message else f"{role}:"
            return ret
        if self.sep_style == SeparatorStyle.LLAMA2:
            seps = (self.sep, self.sep2)
            ret = self.system if self.system else "[INST] "
            for i, (role, message) in enumerate(self.messages):
                if not message:
                    ret += role
                elif i == 0:
                    ret += message + " "
                else:
                    ret += f"{role} {message}{seps[i % 2]}"
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            return self.sep.join(m for _, m in self.messages if m)
        raise ValueError(f"Invalid style: {self.sep_style}")

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=[list(m) for m in self.messages],
                            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2)


conv_templates: Dict[str, Conversation] = {
    "plain": Conversation(system="", roles=("", ""), sep_style=SeparatorStyle.PLAIN, sep="\n"),
    "simple": Conversation(
        system="A chat between a curious human and an artificial "
               "intelligence assistant. The assistant gives helpful, "
               "detailed, and polite answers to the human's questions.",
        roles=("Human", "Assistant"), sep_style=SeparatorStyle.SINGLE, sep="###"),
    "vicuna_v1": Conversation(
        system="A chat between a curious user and an artificial intelligence "
               "assistant. The assistant gives helpful, detailed, and polite "
               "answers to the user's questions.",
        roles=("USER", "ASSISTANT"), sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>"),
    "llama2": Conversation(
        system="[INST] <<SYS>>\nYou are a helpful language and vision "
               "assistant.\n<</SYS>>\n\n",
        roles=("[INST]", "[/INST]"), sep_style=SeparatorStyle.LLAMA2, sep=" ", sep2="</s>"),
}


def get_conv_template(name: str) -> Conversation:
    return conv_templates[name].copy()


def build_prompt(question: str, template: str = "vicuna_v1") -> str:
    """The prompt of one question under ``template``, the assistant's turn
    left open."""
    conv = get_conv_template(template)
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()
