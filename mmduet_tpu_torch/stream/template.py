"""The video-text duet chat format: rendering + char-offset learn ranges.

This is the text-layout contract of the duet interaction format. A
conversation is a list of turns with roles ``system`` / ``user`` /
``assistant`` / ``stream``; stream turns carry ``num_frames`` frames, each
expanded to ``frame_num_tokens`` copies of the ``<image>`` placeholder.

The rendered string layout matches the reference's Jinja template
(`models/tokenization_live.py:34-63`) byte-for-byte — it is a data-format
contract (trained checkpoints depend on it) — but is implemented as a plain
renderer: no Jinja, O(n) single pass, and the char offsets of every turn are
computed in the same pass instead of a separate offset table
(`tokenization_live.py:66-84`).

Layout (bos=<|im_start|>, eos=<|im_end|>):

    <|im_start|>system\nSYS<|im_end|>
    \n<|im_start|>stream\n<image>...<image><|im_end|>
    \n<|im_start|>user\nQ<|im_end|>
    \n<|im_start|>assistant\nA<|im_end|>
    ...

Incremental-prompt modes used by the streaming engine
(`test/inference.py:61-63` in the reference):

- ``add_stream_prompt``             → append ``\n<|im_start|>stream\n`` (open a stream turn)
- ``add_generation_prompt``         → append ``\n<|im_start|>assistant\n``
- ``add_stream_generation_prompt``  → append ``<|im_end|>\n<|im_start|>assistant\n``
  (close the open stream turn, then assistant header)
- ``add_stream_query_prompt``       → every rendered USER turn starts with
  ``<|im_end|>\n`` instead of ``\n`` (closes an open stream turn before a
  user query arrives mid-stream; other roles are unaffected)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

BOS = "<|im_start|>"
EOS = "<|im_end|>"

Turn = Dict  # {'role': ..., 'content': ... | 'num_frames': ..., 'learn': bool}


@dataclass(frozen=True)
class StreamTemplate:
    """Holds the per-frame placeholder expansion parameters."""

    frame_num_tokens: int = 49
    v_placeholder: str = "<image>"
    bos: str = BOS
    eos: str = EOS

    @property
    def frame_placeholder(self) -> str:
        return self.v_placeholder * self.frame_num_tokens

    def stream_placeholder_len(self, num_frames: int) -> int:
        return num_frames * self.frame_num_tokens * len(self.v_placeholder)


def _header(tpl: StreamTemplate, role: str, stream_query: bool) -> str:
    """Transition string entering a turn of `role`.

    Byte-exact to the reference Jinja (`tokenization_live.py:36-58`,
    fuzz-verified): every user/assistant/stream turn is prefixed with
    ``\\n`` — including the first turn of an incremental fragment — and
    only the system turn opens bare. ``add_stream_query_prompt``
    prefixes ``eos`` on every USER turn (closing the open stream turn
    before the query), never on other roles."""
    if role == "user" and stream_query:
        # close an open stream turn, then start the user turn
        return f"{tpl.eos}\n{tpl.bos}{role}\n"
    if role == "system":
        return f"{tpl.bos}{role}\n"
    return f"\n{tpl.bos}{role}\n"


def render_conversation(
    conversation: Sequence[Turn],
    *,
    template: StreamTemplate,
    add_generation_prompt: bool = False,
    add_stream_prompt: bool = False,
    add_stream_generation_prompt: bool = False,
    add_stream_query_prompt: bool = False,
) -> str:
    """Render a conversation to its exact textual form.

    Empty turns (``{}``) are skipped, so the incremental fragments can be
    produced by rendering ``[{}]`` with one of the add_* flags, matching
    the reference's `apply_chat_template([{}], add_stream_prompt=True)`
    usage (`test/inference.py:62-63`).
    """
    parts: List[str] = []
    for msg in conversation:
        role = msg.get("role")
        if role is None:
            continue
        if role == "stream":
            if msg.get("num_frames", 0) <= 0:
                continue
            parts.append(_header(template, "stream", add_stream_query_prompt))
            parts.append(template.frame_placeholder * msg["num_frames"])
            parts.append(template.eos)
        elif role in ("system", "user", "assistant"):
            parts.append(_header(template, role, add_stream_query_prompt))
            parts.append(msg["content"])
            parts.append(template.eos)
        else:
            raise ValueError(f"unknown role: {role!r}")

    if add_generation_prompt:
        parts.append(f"\n{template.bos}assistant\n")
    elif add_stream_prompt:
        parts.append(f"\n{template.bos}stream\n")
    elif add_stream_generation_prompt:
        # closes the currently-open stream turn with eos first
        parts.append(f"{template.eos}\n{template.bos}assistant\n")
    return "".join(parts)


def get_learn_ranges(
    conversation: Sequence[Turn], *, template: StreamTemplate
) -> List[range]:
    """Char ranges of each ``learn: True`` assistant message (+ its eos).

    Single pass mirroring the renderer, so offsets are consistent with
    :func:`render_conversation` by construction. Equivalent behavior to
    reference `get_learn_ranges` (`tokenization_live.py:96-112`).
    """
    offset = 0
    out: List[range] = []
    for msg in conversation:
        role = msg.get("role")
        if role is None:
            continue
        if role == "stream" and msg.get("num_frames", 0) <= 0:
            continue
        offset += len(_header(template, role, False))
        if role == "stream":
            offset += template.stream_placeholder_len(msg["num_frames"])
        else:
            if role == "assistant" and msg.get("learn", False):
                out.append(range(offset, offset + len(msg["content"]) + len(template.eos)))
            offset += len(msg["content"])
        offset += len(template.eos)
    return out
