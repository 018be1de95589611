"""Tokenizer layer for the duet stream format.

The learn-range machinery (`template.get_learn_ranges`) works in *character*
offsets; converting those to token label positions requires a tokenizer that
reports a char offset mapping. Two implementations:

- :class:`HFTokenizerAdapter` — wraps any HuggingFace *fast* tokenizer
  (Qwen2 in practice), adding the ``<image>`` placeholder as a special token
  and remapping bos/eos to ``<|im_start|>`` / ``<|im_end|>``, mirroring
  reference `build_live_tokenizer_and_update_config`
  (`models/tokenization_live.py:115-134`).
- :class:`CharTokenizer` — a dependency-free char-level tokenizer with exact
  offsets, used by the test-suite and tiny-model integration tests (the
  reference has no equivalent: it cannot test without the 7B checkpoint).

Both speak the same small protocol (:class:`StreamTokenizer`).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

from .template import BOS, EOS, StreamTemplate, get_learn_ranges, render_conversation


class StreamTokenizer(Protocol):
    template: StreamTemplate
    eos_token_id: int
    v_placeholder_id: int
    pad_token_id: int
    vocab_size: int

    def encode(self, text: str) -> List[int]: ...

    def encode_with_offsets(self, text: str) -> Tuple[List[int], List[Tuple[int, int]]]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...


class _TemplateMixin:
    """Chat-format helpers shared by all tokenizers."""

    def apply_chat_template(self, conversation, *, tokenize: bool = False, **flags):
        text = render_conversation(conversation, template=self.template, **flags)
        return self.encode(text) if tokenize else text

    def get_learn_ranges(self, conversation) -> List[range]:
        return get_learn_ranges(conversation, template=self.template)


class CharTokenizer(_TemplateMixin):
    """Char-level tokenizer: 1 ASCII char = 1 token; specials get own ids.

    ``<image>`` is deliberately the LAST vocab id, replicating the
    reference's "placeholder is the last added token" layout that the
    embedding clamp trick depends on (`models/modeling_live.py:44`).
    """

    def __init__(self, frame_num_tokens: int = 4, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.v_placeholder_id = vocab_size - 1
        self.template = StreamTemplate(frame_num_tokens=frame_num_tokens)
        self._specials = {
            BOS: self.bos_token_id,
            EOS: self.eos_token_id,
            self.template.v_placeholder: self.v_placeholder_id,
        }
        # longest-first so <|im_start|> wins over '<'
        self._special_order = sorted(self._specials, key=len, reverse=True)
        self._id_to_special = {v: k for k, v in self._specials.items()}

    def encode_with_offsets(self, text: str):
        ids: List[int] = []
        offsets: List[Tuple[int, int]] = []
        i = 0
        n = len(text)
        while i < n:
            for sp in self._special_order:
                if text.startswith(sp, i):
                    ids.append(self._specials[sp])
                    offsets.append((i, i + len(sp)))
                    i += len(sp)
                    break
            else:
                ids.append(ord(text[i]) % 256)
                offsets.append((i, i + 1))
                i += 1
        return ids, offsets

    def encode(self, text: str) -> List[int]:
        return self.encode_with_offsets(text)[0]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        parts = []
        for t in ids:
            t = int(t)
            if t in self._id_to_special or t >= 256:
                if not skip_special_tokens and t in self._id_to_special:
                    parts.append(self._id_to_special[t])
                continue
            parts.append(chr(t))
        return "".join(parts)


class HFTokenizerAdapter(_TemplateMixin):
    """Adapter over a HuggingFace fast tokenizer (Qwen2 for LLaVA-OV).

    Adds ``<image>`` as an additional special token (so it becomes the last
    vocab id) and uses `<|im_start|>`/`<|im_end|>` as turn delimiters.
    """

    def __init__(self, hf_tokenizer, frame_num_tokens: int = 49,
                 v_placeholder: str = "<image>"):
        self.hf = hf_tokenizer
        if v_placeholder not in getattr(hf_tokenizer, "additional_special_tokens", []):
            hf_tokenizer.add_special_tokens({"additional_special_tokens": [v_placeholder]})
        self.v_placeholder_id = hf_tokenizer.convert_tokens_to_ids(v_placeholder)
        self.eos_token_id = hf_tokenizer.convert_tokens_to_ids(EOS)
        self.bos_token_id = hf_tokenizer.convert_tokens_to_ids(BOS)
        self.pad_token_id = (
            hf_tokenizer.pad_token_id
            if hf_tokenizer.pad_token_id is not None
            else self.eos_token_id
        )
        self.vocab_size = len(hf_tokenizer)
        self.template = StreamTemplate(
            frame_num_tokens=frame_num_tokens, v_placeholder=v_placeholder
        )

    @classmethod
    def from_pretrained(cls, name_or_path: str, **kw):
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(name_or_path, use_fast=True), **kw)

    def encode_with_offsets(self, text: str):
        enc = self.hf(text, return_offsets_mapping=True, add_special_tokens=False)
        return enc["input_ids"], [tuple(o) for o in enc["offset_mapping"]]

    def encode(self, text: str) -> List[int]:
        return self.hf(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.hf.decode(
            list(map(int, ids)),
            skip_special_tokens=skip_special_tokens,
            clean_up_tokenization_spaces=True,
        )
