"""Tokenize functions: raw jsonl sample -> {input_ids, labels, num_tokens}
(counterpart: `xtuner_tpu/datasets/tokenize_fns.py`).

Each function exposes `hash()` so token counts can be disk-cached keyed by
(tokenizer, function).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

from ..data_proto.templates import ChatMessages, ChatTemplate, get_chat_template


def _tokenizer_fingerprint(tokenizer) -> str:
    name = getattr(tokenizer, "name_or_path", type(tokenizer).__name__)
    vocab = getattr(tokenizer, "vocab_size", len(tokenizer) if hasattr(tokenizer, "__len__") else 0)
    return f"{name}:{vocab}"


class OpenaiSFTTokenizeFn:
    """{"messages": [{role, content}, ...]} -> supervised chat sample."""

    def __init__(self, tokenizer, chat_template: ChatTemplate | str = "qwen",
                 max_length: int | None = None):
        self.tokenizer = tokenizer
        self.chat_template = (
            get_chat_template(chat_template) if isinstance(chat_template, str) else chat_template
        )
        self.max_length = max_length

    def __call__(self, item: dict[str, Any]) -> dict:
        out = ChatMessages(messages=item["messages"], tools=item.get("tools")).tokenize(
            self.tokenizer, self.chat_template)
        if self.max_length is not None and out["num_tokens"] > self.max_length:
            out["input_ids"] = out["input_ids"][: self.max_length]
            out["labels"] = out["labels"][: self.max_length]
            out["num_tokens"] = self.max_length
        return out

    def hash(self) -> str:
        key = json.dumps(
            ["openai_sft", _tokenizer_fingerprint(self.tokenizer),
             dataclasses.asdict(self.chat_template), self.max_length],
            sort_keys=True,
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]


class PretrainTokenizeFn:
    """{"content"|"text": str} -> every token supervised (+ optional eos)."""

    def __init__(self, tokenizer, add_eos: bool = True, max_length: int | None = None):
        self.tokenizer = tokenizer
        self.add_eos = add_eos
        self.max_length = max_length

    def __call__(self, item: dict[str, Any]) -> dict:
        text = item.get("content") or item.get("text") or ""
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        if self.add_eos and getattr(self.tokenizer, "eos_token_id", None) is not None:
            ids = ids + [self.tokenizer.eos_token_id]
        if self.max_length is not None:
            ids = ids[: self.max_length]
        return {"input_ids": ids, "labels": list(ids), "num_tokens": len(ids)}

    def hash(self) -> str:
        key = json.dumps(
            ["pretrain", _tokenizer_fingerprint(self.tokenizer), self.add_eos, self.max_length]
        )
        return hashlib.sha256(key.encode()).hexdigest()[:16]
