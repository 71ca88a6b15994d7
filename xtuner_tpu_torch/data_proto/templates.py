"""Chat templates and message tokenization (counterpart:
`xtuner_tpu/data_proto/templates.py`).

The same templates, formatting and loss flags, with dataclasses in place of
pydantic models: `ChatTemplate` keeps the fields and defaults, the template
map holds the same instances, and `ChatMessages.tokenize` gives the JAX
package's ids and labels token for token.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ChatTemplate:
    """Format-string chat template (defaults: ChatML / Qwen)."""

    system: str = "<|im_start|>system\n{system}<|im_end|>\n"
    user: str = "<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n"
    assistant: str = "{assistant}<|im_end|>\n"
    # developer role (reference decorate_developer); falls back to system
    developer: Optional[str] = None
    # tool RESULT framing fed back to the model (reference tool_extractor)
    tool_extractor: Optional[str] = None
    # system-suffix announcing available tools; {tool_text} = json signatures
    tool_prompt: Optional[str] = None
    # thinking-model variants (reference glm52/qwen35/gpt-oss templates)
    thinking: Optional[str] = None
    stop_words: list[str] = field(default_factory=lambda: ["<|im_end|>"])
    default_system: Optional[str] = None
    sep: str = ""
    # gpt-oss: supervise only the final assistant turn (chat.py:190-198)
    only_last_assistant_loss: bool = False
    # gpt-oss: rewrite the supervised assistant text (e.g. <|end|> -> <|return|>)
    loss_assistant_format_mapping: Optional[dict[str, str]] = None
    # retained for round-1 compat (alias of `thinking` in older configs)
    thinking_prefix: Optional[str] = None


def tool_formatter(tools: list[dict[str, Any]]) -> str:
    """OpenAI tool list -> json signature block (reference chat.py:68-74)."""
    text = ""
    for tool in tools:
        wrapped = tool if tool.get("type") == "function" else {"type": "function", "function": tool}
        text += "\n" + json.dumps(wrapped, ensure_ascii=False)
    return text


def function_formatter(tool_calls: list[dict[str, Any]]) -> str:
    """Assistant tool_calls -> <tool_call> json blocks (chat.py:76-83)."""
    texts = []
    for call in tool_calls:
        fn = call.get("function", call)
        args = fn.get("arguments", {})
        if isinstance(args, str):
            args = json.loads(args)
        texts.append(json.dumps({"name": fn["name"], "arguments": args}, ensure_ascii=False))
    return "\n".join(f"<tool_call>\n{t}\n</tool_call>" for t in texts)


CHAT_TEMPLATE_MAP: dict[str, ChatTemplate] = {
    "qwen": ChatTemplate(),
    "chatml": ChatTemplate(),
    "internlm2": ChatTemplate(
        system="<|im_start|>system\n{system}<|im_end|>\n",
        user="<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n",
        assistant="{assistant}<|im_end|>\n",
        stop_words=["<|im_end|>"],
    ),
    # full qwen3 surface: tools + tool results (reference templates/__init__.py qwen3)
    "qwen3": ChatTemplate(
        system="<|im_start|>system\n{system}<|im_end|>\n",
        user="<|im_start|>user\n{user}<|im_end|>\n<|im_start|>assistant\n",
        assistant="{assistant}<|im_end|>",
        developer="<|im_start|>system\n{developer}<|im_end|>\n",
        tool_prompt=(
            "\n\n# Tools\n\nYou may call one or more functions to assist with the user query.\n\n"
            "You are provided with function signatures within <tools></tools> XML tags:\n"
            "<tools>{tool_text}\n</tools>\n\nFor each function call, return a json object "
            "with function name and arguments within <tool_call></tool_call> XML tags:\n"
            '<tool_call>\n{{"name": <function-name>, "arguments": <args-json-object>}}\n</tool_call>'
        ),
        tool_extractor=(
            "<|im_start|>user\n<tool_response>\n{tool_extractor}\n</tool_response>"
            "<|im_end|>\n<|im_start|>assistant\n"
        ),
        stop_words=["<|im_end|>", "<|endoftext|>"],
        sep="\n",
    ),
    "llama3": ChatTemplate(
        system="<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>",
        user="<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
             "<|start_header_id|>assistant<|end_header_id|>\n\n",
        assistant="{assistant}<|eot_id|>",
        stop_words=["<|eot_id|>"],
    ),
    # thinking-channel template (reference gpt-oss: analysis channel, final-only
    # loss, <|end|> -> <|return|> on the supervised turn)
    "gpt-oss": ChatTemplate(
        system="<|start|>system<|message|>{system}<|end|>",
        developer="<|start|>developer<|message|># Instructions\n\n{developer}\n\n<|end|>",
        user="<|start|>user<|message|>{user}<|end|><|start|>assistant",
        assistant="<|channel|>final<|message|>{assistant}<|end|>",
        thinking="<|channel|>analysis<|message|>{thinking}<|end|><|start|>assistant",
        stop_words=["<|return|>"],
        only_last_assistant_loss=True,
        loss_assistant_format_mapping={"<|end|>": "<|return|>"},
    ),
    "deepseek-v3": ChatTemplate(
        system="<｜begin▁of▁sentence｜>{system}",
        user="<｜User｜>{user}<｜Assistant｜></think>",
        assistant="{assistant}<｜end▁of▁sentence｜>",
        stop_words=["<｜end▁of▁sentence｜>"],
    ),
    # GLM-5.2 wire format (reference messages/glm52_chat.py:158-202:
    # [gMASK]<sop> preamble, <|user|>/<|system|>/<|assistant|> role tags,
    # non-thinking turns render an empty <think></think>)
    "glm": ChatTemplate(
        system="[gMASK]<sop><|system|>{system}",
        user="<|user|>{user}<|assistant|><think></think>",
        assistant="{assistant}",
        stop_words=["<|endoftext|>", "<|observation|>"],
        tool_extractor="<|observation|>{tool_extractor}",  # JAX: "{}", which raises
    ),
}
CHAT_TEMPLATE_MAP["glm52"] = CHAT_TEMPLATE_MAP["glm"]
# Qwen3.5 text models keep the Qwen3 ChatML wire format (the reference maps
# only a "qwen3.5-vl" variant, differing in vision tokens)
CHAT_TEMPLATE_MAP["qwen35"] = CHAT_TEMPLATE_MAP["qwen3"]
CHAT_TEMPLATE_MAP["qwen3.5"] = CHAT_TEMPLATE_MAP["qwen3"]


def get_chat_template(name: str) -> ChatTemplate:
    if name not in CHAT_TEMPLATE_MAP:
        raise KeyError(f"Unknown chat template {name!r}; known: {sorted(CHAT_TEMPLATE_MAP)}")
    return CHAT_TEMPLATE_MAP[name]


class ChatMessages:
    """OpenAI-format message list with loss-flag tokenization.

    Supports tool use end-to-end (reference chat.py:86-280):
    - `tools=[...]` injects json signatures into the system prompt via
      `tool_prompt`
    - assistant messages may carry `tool_calls` -> <tool_call> json blocks,
      SUPERVISED (the policy must learn to emit them)
    - `tool` role messages are framed with `tool_extractor` and loss-masked
    - assistant `thinking` is decorated on the LAST message only
    """

    def __init__(self, messages: list[dict[str, Any]],
                 tools: Optional[list[dict[str, Any]]] = None, **extra: Any):
        self.messages = messages
        self.tools = tools

    def _decorated(self, msg: dict[str, Any], chat_template: ChatTemplate,
                   is_last: bool, supervised: bool) -> str:
        role, content = msg["role"], msg.get("content") or ""
        if role == "system":
            return chat_template.system.format(system=content)
        if role == "developer":
            fmt = chat_template.developer or chat_template.system
            key = "developer" if chat_template.developer else "system"
            return fmt.format(**{key: content})
        if role == "user":
            return chat_template.user.format(user=content)
        if role == "tool":
            if chat_template.tool_extractor is not None:
                return chat_template.tool_extractor.format(tool_extractor=content)
            return chat_template.user.format(user=content)
        if role == "assistant":
            text = content
            if msg.get("tool_calls"):
                fn_text = function_formatter(msg["tool_calls"])
                if text and not text.endswith("\n\n"):
                    fn_text = "\n" + fn_text
                text = text + fn_text
            prompt = ""
            thinking = msg.get("thinking")
            if thinking is not None and is_last and chat_template.thinking is not None:
                # only the last round keeps its thinking (chat.py:186-188)
                prompt += chat_template.thinking.format(thinking=thinking)
            body = chat_template.assistant.format(assistant=text)
            if supervised and chat_template.loss_assistant_format_mapping:
                for k, v in chat_template.loss_assistant_format_mapping.items():
                    body = body.replace(k, v)
            return prompt + body
        raise ValueError(f"Unknown role {role!r}")

    def tokenize(self, tokenizer, chat_template: ChatTemplate) -> dict:
        """-> {input_ids, labels, num_tokens}. Assistant turns are supervised;
        system/developer/user/tool text is masked with -100."""
        input_ids: list[int] = []
        labels: list[int] = []

        msgs = [dict(m) for m in self.messages]
        if chat_template.default_system is not None and (not msgs or msgs[0]["role"] != "system"):
            msgs = [{"role": "system", "content": chat_template.default_system}] + msgs
        if self.tools:
            if chat_template.tool_prompt is None:
                raise ValueError("this chat template has no tool_prompt; cannot format tools")
            tool_text = chat_template.tool_prompt.format(tool_text=tool_formatter(self.tools))
            if msgs and msgs[0]["role"] == "system":
                msgs[0]["content"] = (msgs[0].get("content") or "") + tool_text
            else:
                msgs = [{"role": "system", "content": tool_text}] + msgs

        last_assistant = max((i for i, m in enumerate(msgs) if m["role"] == "assistant"),
                             default=-1)
        for i, msg in enumerate(msgs):
            role = msg["role"]
            supervised = bool(msg.get("loss", role == "assistant"))
            if (chat_template.only_last_assistant_loss and role == "assistant"
                    and i != last_assistant):
                supervised = False
            text = self._decorated(msg, chat_template, is_last=(i == len(msgs) - 1),
                                   supervised=supervised)
            if role == "assistant" and chat_template.sep:
                text += chat_template.sep
            ids = tokenizer.encode(text, add_special_tokens=False)
            input_ids.extend(ids)
            labels.extend(ids if supervised else [-100] * len(ids))
        return {"input_ids": input_ids, "labels": labels, "num_tokens": len(input_ids)}
