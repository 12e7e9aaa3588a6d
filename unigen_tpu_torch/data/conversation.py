"""Conversation templates (reference: data/llava/conversation.py:401-447).

Only the ChatML/Qwen template is active in the reference (conv_qwen, :401-410);
the registry shape is kept so alternative templates slot in. The port's copy of
``unigen_tpu/data/conversation.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    sep: str = "<|im_end|>"
    messages: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def append_message(self, role: str, message: str) -> None:
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        """ChatML rendering (reference conv_qwen template)."""
        out = [f"<|im_start|>system\n{self.system}{self.sep}\n"] if self.system else []
        for role, msg in self.messages:
            if msg is None:
                out.append(f"<|im_start|>{role}\n")
            else:
                out.append(f"<|im_start|>{role}\n{msg}{self.sep}\n")
        return "".join(out)

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, self.sep, list(self.messages))


conv_qwen = Conversation(
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
)

conv_templates: Dict[str, Conversation] = {
    "qwen_1_5": conv_qwen,
    "qwen_2": conv_qwen,
    "qwen_2.5": conv_qwen,
}

default_conversation = conv_qwen
