"""Benchmark eval dataset: streaming VideoQA JSON → (frames, conversation).

Equivalent of the reference `FastAndAccurateStreamingVideoQADataset`
(`test/datasets.py:8-104`). Plain-python iterable (no torch DataLoader
dependency) with an optional background-thread prefetcher so host video
decode overlaps TPU compute.
"""

from __future__ import annotations

import json
import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..config import DEFAULT_SYSTEM_PROMPT
from .video import decode_video


@dataclass
class EvalSample:
    question_id: Any
    frames: Optional[np.ndarray]  # (T,H,W,3) uint8, None if load failed
    conversation: List[dict]
    fps: float
    video_duration: float
    error: Optional[str] = None
    # filled by StreamingEvalDatasetWithGenTime only
    gold_answers: Optional[List[str]] = None
    gold_end_times: Optional[List[float]] = None


class StreamingEvalDataset:
    def __init__(
        self,
        data_file: str,
        video_base_folder: str,
        start_idx: int = 0,
        end_idx: Optional[int] = None,
        output_fps: float = 2.0,
        output_resolution: int = 384,
        max_num_frames: int = 400,
        system_prompt: str = DEFAULT_SYSTEM_PROMPT,
        time_instruction_format: Optional[str] = None,
    ):
        with open(data_file) as f:
            self.data = json.load(f)[start_idx:end_idx]
        self.video_base_folder = video_base_folder
        self.output_fps = output_fps
        self.output_resolution = output_resolution
        self.max_num_frames = max_num_frames
        self.system_prompt = system_prompt
        self.time_instruction_format = time_instruction_format

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> EvalSample:
        ex = self.data[idx]
        qid = ex.get("question_id")
        try:
            frames, fps, duration = decode_video(
                f"{self.video_base_folder}/{ex['video']}",
                self.output_fps,
                self.output_resolution,
                self.max_num_frames,
            )
            conversation = list(ex["conversation"])
            if self.time_instruction_format == "timechat":
                secs = ",".join(f"{i / fps:.2f}s" for i in range(len(frames)))
                instr = (
                    f"The video lasts for {duration:.2f} seconds, and "
                    f"{len(frames)} frames are uniformly sampled from it. "
                    f"These frames are located at {secs}."
                    "Please answer the following questions related to this video."
                )
                conversation[0] = dict(
                    conversation[0], content=instr + "\n" + conversation[0]["content"]
                )
            elif self.time_instruction_format == "vtimellm":
                conversation[0] = dict(
                    conversation[0],
                    content=f"This is a video with {len(frames)} frames.\n"
                    + conversation[0]["content"],
                )
            conversation = [
                {"role": "system", "content": self.system_prompt}
            ] + conversation
            return EvalSample(qid, frames, conversation, fps, duration)
        except Exception as e:  # broken video → skippable sample
            return EvalSample(qid, None, [], 0.0, 0.0, error=str(e))

    def __iter__(self) -> Iterator[EvalSample]:
        for i in range(len(self)):
            yield self[i]

    def prefetch(self, depth: int = 2) -> Iterator[EvalSample]:
        """Background-thread decode: the host decodes sample i+1 while the
        TPU streams sample i (the reference uses torch DataLoader workers
        for this, `test/inference.py:341`)."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()

        def worker():
            for i in range(len(self)):
                q.put(self[i])
            q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


class StreamingEvalDatasetWithGenTime(StreamingEvalDataset):
    """Variant also returning the gold answers + their end times
    (reference `StreamingVideoQADatasetWithGenTime`,
    `test/datasets.py:107-119` — unused by the main driver but part of
    the eval-dataset surface)."""

    def __getitem__(self, idx: int) -> "EvalSample":
        sample = super().__getitem__(idx)
        ex = self.data[idx]
        answers = ex.get("answer", [])
        sample.conversation = list(sample.conversation)
        sample.gold_answers = [a.get("content") for a in answers]
        sample.gold_end_times = [
            (a["time"][1] if isinstance(a.get("time"), (list, tuple)) else a.get("time"))
            for a in answers
        ]
        return sample
