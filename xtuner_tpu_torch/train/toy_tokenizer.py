"""UTF-8 byte toy tokenizer, used when no tokenizer_path is given
(counterpart: `xtuner_tpu/train/toy_tokenizer.py`, the same ids)."""

from __future__ import annotations


class UTF8ByteTokenizer:
    """Bytes 0-255 are ids 0-255; specials follow (extra specials — e.g. VLM
    image tokens — get ids from 259 upward)."""

    def __init__(self, extra_specials: list[str] | None = None):
        self.specials = ["<pad>", "<bos>", "<eos>"]
        self.pad_token_id = 256
        self.bos_token_id = 257
        self.eos_token_id = 258
        self.extra_specials = list(extra_specials or [])
        self.special_ids = {s: 259 + i for i, s in enumerate(self.extra_specials)}
        self.vocab_size = 259 + len(self.extra_specials)

    def __len__(self):
        return self.vocab_size

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids: list[int] = []
        rest = text
        while rest:
            hit = None
            for s, sid in self.special_ids.items():
                idx = rest.find(s)
                if idx != -1 and (hit is None or idx < hit[0]):
                    hit = (idx, s, sid)
            if hit is None:
                ids.extend(rest.encode("utf-8"))
                break
            idx, s, sid = hit
            ids.extend(rest[:idx].encode("utf-8"))
            ids.append(sid)
            rest = rest[idx + len(s):]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def decode(self, ids) -> str:
        inv = {v: k for k, v in self.special_ids.items()}
        out = []
        buf = bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if i in inv:
                    out.append(inv[i])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}
