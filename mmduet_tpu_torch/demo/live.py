"""Interactive single-frame engine API for demos.

Equivalent of the reference `LiveInferForDemo`
(`demo/liveinfer.py:60-105`): one frame in → scores + maybe a response
out, plus mid-stream user queries typed at arbitrary times.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..infer.engine import LiveInferEngine


class LiveInferForDemo(LiveInferEngine):
    def encode_given_query(self, query: str) -> None:
        """Inject a user query at the current stream position
        (reference `demo/liveinfer.py:61-67`)."""
        ids = self.tokenizer.apply_chat_template(
            [{"role": "user", "content": query}],
            tokenize=True,
            add_stream_query_prompt=self.last_role == "stream",
            add_stream_prompt=True,
        )
        self._feed(self._embed_ids(ids))
        self.last_role = "user"

    def input_one_frame(self) -> Optional[Dict[str, Any]]:
        """Process exactly one frame; returns scores + optional response
        (reference `demo/liveinfer.py:69-105`)."""
        if self.frame_embeds is None or self._next_frame >= len(self.frame_times):
            return None
        scores = self._encode_frame()
        self.debug_data_list.append(dict(time=self.video_time, **scores))
        stream_end_score = sum(
            v for k, v in scores.items() if k in self.score_heads
        )
        response = None
        if self._threshold_triggered(stream_end_score) and not self.grounding_mode:
            response = self._generate_response()
        result = {
            "frame_idx": self.frame_idx,
            "time": self.video_time,
            "informative_score": scores["informative_score"],
            "relevance_score": scores["relevance_score"],
            "response": response,
        }
        self.video_time += self.frame_interval
        return result
