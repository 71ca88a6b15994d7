"""RL rollout tokenize functions (counterpart:
`xtuner_tpu/datasets/rl_tokenize.py`, a copy: that module imports no JAX).

`RLTextTokenizeFn` converts verl-style RL dataset items

    {"data_source": ..., "prompt": [{"role": "user", "content": ...}],
     "ability": "math", "reward_model": {"style": "rule", "ground_truth": ...},
     "extra_info": {...}}

into rollout-ready samples: prompt token ids (with the generation prompt
appended), reward metadata, and the judger routing weights. Also accepts this
repo's simpler {"messages"|"prompt", "label"} schema. Works as a JsonlDataset
tokenize_fn (exposes num_tokens for count caching; over-length prompts count
0 so the dataset filter drops them)."""

from __future__ import annotations

from typing import Any, Optional

from ..data_proto.templates import get_chat_template, tool_formatter


class RLTextTokenizeFn:
    def __init__(self, tokenizer, chat_template: str = "qwen",
                 max_length: Optional[int] = None,
                 tools_schema: Optional[list] = None,
                 data_judger_mapping: Optional[dict] = None,
                 system_prompt: Optional[str] = None):
        self.tokenizer = tokenizer
        self.chat_template = chat_template
        self.max_length = max_length
        self.tools_schema = tools_schema or []
        self.data_judger_mapping = data_judger_mapping
        self.system_prompt = system_prompt

    def hash(self) -> str:
        import hashlib
        import json

        from .tokenize_fns import _tokenizer_fingerprint

        key = json.dumps([self.chat_template, self.max_length, self.tools_schema,
                          self.system_prompt, _tokenizer_fingerprint(self.tokenizer)],
                         sort_keys=True)
        return f"rl-text-v1-{hashlib.sha256(key.encode()).hexdigest()[:12]}"

    def _messages(self, item: dict) -> list[dict]:
        msgs = item.get("prompt") if isinstance(item.get("prompt"), list) else None
        if msgs is None:
            msgs = item.get("messages")
        if msgs is None:
            msgs = [{"role": "user", "content": item["prompt"]}]
        if self.system_prompt:
            if msgs and msgs[0]["role"] == "system":
                msgs = msgs[1:]
            msgs = [{"role": "system", "content": self.system_prompt}] + list(msgs)
        return list(msgs)

    def __call__(self, item: dict) -> dict[str, Any]:
        template = get_chat_template(self.chat_template)
        msgs = self._messages(item)
        if self.tools_schema:
            if template.tool_prompt is None:
                raise ValueError(f"template {self.chat_template!r} cannot format tools")
            tool_text = template.tool_prompt.format(tool_text=tool_formatter(self.tools_schema))
            if msgs and msgs[0]["role"] == "system":
                msgs[0] = dict(msgs[0], content=(msgs[0].get("content") or "") + tool_text)
            else:
                msgs = [{"role": "system", "content": tool_text}] + msgs

        ids: list[int] = []
        for m in msgs:
            role, content = m["role"], m.get("content", "")
            if role == "system":
                text = template.system.format(system=content)
            elif role == "assistant":
                text = template.assistant.format(assistant=content)
            else:  # user / tool; the user template ends with the generation prompt
                text = template.user.format(user=content)
            ids.extend(self.tokenizer.encode(text, add_special_tokens=False))

        num_tokens = len(ids)
        if self.max_length is not None and num_tokens > self.max_length:
            # dropped by the dataset-level num_tokens filter
            return {"num_tokens": 0, "input_ids": [], "prompt_ids": [], "labels": []}

        data_source = item.get("data_source")
        if self.data_judger_mapping is not None and data_source is not None:
            judger_weights = self.data_judger_mapping.get(data_source)
        elif data_source is not None:
            judger_weights = {data_source: 1.0}
        else:
            judger_weights = None

        reward_model = item.get("reward_model", {})
        label = item.get("label", reward_model.get("ground_truth"))
        return {
            "prompt_ids": ids,
            "input_ids": ids,  # counting/packing compatibility
            "labels": [-100] * num_tokens,
            "num_tokens": num_tokens,
            "messages": msgs,
            "reward_model": reward_model,
            "label": label,
            "data_source": judger_weights,
            "extra_info": dict(item.get("extra_info", {}), raw_prompt=None),
        }
