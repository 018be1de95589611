"""The token ids of MMDuet's chat format, as the reference works them out.

The benchmark serves random weights with a character-level vocabulary:
one token a character (its code modulo 256), ``<|im_start|>`` 256 and
``<|im_end|>`` 257. With the answers removed from the context
(``remove_assistant_turns``), a stream whose query comes at time 0 is
[the query's turn, which opens the stream turn] followed by every frame's
tokens; an answer branches off it with the assistant prompt.
"""

from __future__ import annotations

from typing import List

BOS, EOS = "<|im_start|>", "<|im_end|>"
SPECIAL = {BOS: 256, EOS: 257}


def encode(text: str) -> List[int]:
    ids, i = [], 0
    while i < len(text):
        for tok, tid in SPECIAL.items():
            if text.startswith(tok, i):
                ids.append(tid)
                i += len(tok)
                break
        else:
            ids.append(ord(text[i]) % 256)
            i += 1
    return ids


def query_ids(query: str) -> List[int]:
    """A time-0 user query, then the opened stream turn."""
    return encode(f"\n{BOS}user\n{query}{EOS}\n{BOS}stream\n")


def answer_prompt_ids() -> List[int]:
    """What closes the stream turn and opens the assistant's."""
    return encode(f"{EOS}\n{BOS}assistant\n")
