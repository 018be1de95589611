"""Training datasets in the duet stream format.

Rebuild of the reference data layer (`data/stream.py`, `data/dvc.py`,
`data/magqa.py`, `data/grounding.py`): annotation files are converted into
duet conversations (stream turns carrying frame counts + learn flags),
videos are decoded host-side at the dataset fps, and per-frame
informative/relevance labels come from `mmduet_tpu_torch.stream.labels`.

Differences from the reference (deliberate):
- `<image>` (the placeholder literal) is stripped from free-text content —
  it would corrupt frame-label positions (hazard found in verification;
  the reference has the same latent bug);
- label construction lives in pure functions shared with the test-suite;
- random-resample-on-error is kept (reference `dvc.py:76-86`) but bounded
  to avoid infinite recursion.
"""

from __future__ import annotations

import json
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_SYSTEM_PROMPT
from ..stream.labels import get_informative_labels, get_relevance_labels
from .time_utils import ceil_time_by_fps
from .video import build_metadata, decode_video


def sanitize_text(text: str, v_placeholder: str = "<image>") -> str:
    """Free text must never contain the frame placeholder literal."""
    return text.replace(v_placeholder, "") if v_placeholder in text else text


class StreamDataset:
    """Base: metadata prep, video loading, conversation → sample assembly."""

    def __init__(
        self,
        video_root: Optional[str] = None,
        anno_file: Optional[str] = None,
        metadata_path: Optional[str] = None,
        frame_fps: float = 2.0,
        frame_size: int = 384,
        system_prompt: Optional[str] = None,
        max_num_frames: int = 128,
        tokenizer=None,
        skip_video: bool = False,
        **kwargs,
    ):
        self.video_root = video_root
        self.anno_file = anno_file
        self.frame_fps = frame_fps
        self.frame_size = frame_size
        self.system_prompt = system_prompt or DEFAULT_SYSTEM_PROMPT
        self.max_num_frames = max_num_frames
        self.tokenizer = tokenizer
        self.skip_video = skip_video
        self._epoch = 0
        self.metadata = (
            build_metadata(video_root, metadata_path)
            if metadata_path and video_root
            else {}
        )
        with open(anno_file) as f:
            self.raw_annos = json.load(f)
        self.annos: List[dict] = self.build_annos(self.raw_annos)

    def set_epoch(self, epoch: int) -> None:
        """Vary the per-item RNG across epochs (torch DistributedSampler
        convention)."""
        self._epoch = int(epoch)

    def item_rng(self, index: int) -> random.Random:
        """Deterministic per-(epoch, index) RNG for __getitem__-time draws.

        The global `random` module is NOT safe here: the train loop
        prefetches samples from a thread pool, and concurrent draws from
        one shared Mersenne-Twister stream interleave
        schedule-dependently, destroying seeded reproducibility."""
        return random.Random(f"{type(self).__name__}:{self._epoch}:{index}")

    # subclasses convert raw annotation format → duet conversations
    def build_annos(self, raw) -> List[dict]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.annos)

    # --- label policies; subclasses disable the irrelevant stream -------

    def informative_labels(self, conversation):
        return get_informative_labels(conversation)

    def relevance_labels(self, conversation):
        return get_relevance_labels(conversation)

    # --- frame loading ---------------------------------------------------

    def load_frames(self, load_ranges: Dict[str, range]) -> np.ndarray:
        parts = []
        for file, rng in load_ranges.items():
            meta = self.metadata[file]
            frames, _, _ = decode_video(
                meta["path"], self.frame_fps, self.frame_size,
                duration=meta["duration"],
            )
            parts.append(frames[rng.start : rng.stop])
        return np.concatenate(parts) if parts else np.zeros(
            (0, self.frame_size, self.frame_size, 3), np.uint8
        )

    def max_frames_clip(
        self, conversation: List[dict], load_ranges: Dict[str, range]
    ) -> Tuple[List[dict], Dict[str, range]]:
        """Truncate the conversation + frame ranges at max_num_frames
        (reference `stream.py:57-71` semantics)."""
        limit = self.max_num_frames
        cum = 0
        for i, msg in enumerate(conversation):
            if msg.get("role") != "stream":
                continue
            if cum + msg["num_frames"] >= limit:
                if cum < limit:
                    msg = dict(msg, num_frames=limit - cum)
                    conversation = conversation[:i] + [msg]
                else:
                    conversation = conversation[:i]
                load_ranges = {
                    p: range(r.start, r.start + limit) for p, r in load_ranges.items()
                }
                break
            cum += msg["num_frames"]
        return conversation, load_ranges

    # --- sample assembly -------------------------------------------------

    def make_sample(
        self, conversation: List[dict], load_ranges: Optional[Dict[str, range]]
    ) -> Tuple[str, np.ndarray, List[range], Optional[list], Optional[list]]:
        if self.skip_video or load_ranges is None:
            frames = np.zeros((0, self.frame_size, self.frame_size, 3), np.uint8)
        else:
            conversation, load_ranges = self.max_frames_clip(conversation, load_ranges)
            frames = self.load_frames(load_ranges)

        conversation = [
            dict(m, content=sanitize_text(m["content"])) if "content" in m else m
            for m in conversation
        ]
        conversation = [{"role": "system", "content": self.system_prompt}] + conversation
        text = self.tokenizer.apply_chat_template(conversation)
        learn_ranges = self.tokenizer.get_learn_ranges(conversation)

        if not self.skip_video:
            n_text = sum(
                m["num_frames"] for m in conversation if m.get("role") == "stream"
            )
            if len(frames) != n_text:
                raise ValueError(
                    f"frames in video ({len(frames)}) != frames in text ({n_text})"
                )

        inf = self.informative_labels(conversation)
        rel = self.relevance_labels(conversation)
        # overlong label vectors are truncated at the actual frame count
        # (reference stream.py:179-185)
        if not self.skip_video:
            if inf is not None:
                assert len(inf) >= len(frames), (len(inf), len(frames))
                inf = inf[: len(frames)]
            if rel is not None:
                assert len(rel) >= len(frames), (len(rel), len(frames))
                rel = rel[: len(frames)]
        return text, frames, learn_ranges, inf, rel

    def __getitem__(self, index: int, _depth: int = 0):
        try:
            anno = self.annos[index]
            conv = [dict(m) for m in anno["conversation"]]
            return (*self.make_sample(conv, anno.get("load_ranges")), index)
        except Exception as e:
            if _depth >= 10:
                raise
            # fault tolerance: resample a deterministic alternative index
            # (reference dvc.py:76-86 resamples via global random)
            alt = self.item_rng(index + 7919 * (_depth + 1)).randrange(len(self))
            return self.__getitem__(alt, _depth + 1)


class DenseVideoCaptioningStreamDataset(StreamDataset):
    """Timed narrations → alternating stream/assistant turns
    (reference `data/dvc.py:11-86`). A random captioning instruction is
    prepended per sample at __getitem__ time."""

    instructions = [
        "Please concisely narrate the video in real time.",
        "Help me to illustrate my view in short.",
        "Please simply describe what do you see.",
        "Continuously answer what you observed with simple text.",
        "Do concise real-time narration.",
        "Hey assistant, do you know the current video content? Reply me concisely.",
        "Simply interpret the scene for me.",
        "What can you tell me about? Be concise.",
        "Use simple text to explain what is shown in front of me.",
        "What is the action now? Please response in short.",
    ]

    def relevance_labels(self, conversation):
        return None

    def build_annos(self, raw) -> List[dict]:
        out = []
        for video_uid, groups in raw.items():
            meta = self.metadata.get(video_uid)
            if meta is None:
                continue
            duration = meta["duration"]
            for narrations in groups.values():
                if not narrations:
                    continue
                fps = self.frame_fps
                start_time = ceil_time_by_fps(0, fps, 0, duration)
                conversation: List[dict] = []
                last_time, last_text = start_time, None
                for n in narrations:
                    if last_time >= duration:
                        break
                    text = n["text"]
                    if text == last_text:
                        continue
                    t = ceil_time_by_fps(n["time"], fps, 0, duration)
                    if t == last_time:
                        if conversation:
                            conversation[-1]["content"] = text
                    else:
                        num_frames = int((t - last_time) * fps)
                        # frames after the narration-span midpoint count as
                        # "respond now" frames
                        resp_start = ceil_time_by_fps(
                            (n["timespan"][0] + n["timespan"][1]) / 2, fps, 0, duration
                        )
                        response_frame_num = int((t - resp_start) * fps) + 1
                        conversation += [
                            {"role": "stream", "num_frames": num_frames, "learn": True},
                            {
                                "role": "assistant",
                                "content": text,
                                "learn": n.get("learn", True),
                                "response_frame_num": response_frame_num,
                            },
                        ]
                    last_time, last_text = t, text
                if conversation:
                    out.append({
                        "conversation": conversation,
                        "load_ranges": {
                            video_uid: range(
                                int(start_time * fps), int(last_time * fps)
                            )
                        },
                    })
        return out

    def __getitem__(self, index: int, _depth: int = 0):
        try:
            anno = self.annos[index]
            rng = self.item_rng(index)
            conv = [{"role": "user", "content": rng.choice(self.instructions)}]
            conv += [dict(m) for m in anno["conversation"]]
            return (*self.make_sample(conv, anno.get("load_ranges")), index)
        except Exception:
            if _depth >= 10:
                raise
            alt = self.item_rng(index + 7919 * (_depth + 1)).randrange(len(self))
            return self.__getitem__(alt, _depth + 1)


class MAGQAStreamDataset(StreamDataset):
    """Multi-turn grounded QA: random waiting frames, then user / stream /
    assistant interleaved by timestamp (reference `data/magqa.py:11-72`)."""

    def relevance_labels(self, conversation):
        return None

    def build_annos(self, raw) -> List[dict]:
        out = []
        fps = self.frame_fps
        for anno in raw:
            video_uid = anno.get("video_uid")
            meta = self.metadata.get(video_uid)
            if meta is None or not anno.get("conversation"):
                continue
            duration = meta["duration"]
            first = anno["conversation"][0]
            if not (
                first.get("role") == "user"
                and 0 < first.get("time", -1) <= duration
                and first.get("content")
            ):
                continue
            video_start_time = anno.get("video_start_time", 1e8)
            fps_time = ceil_time_by_fps(first["time"], fps, 0, duration)
            lo = int((fps_time - video_start_time) * fps)
            hi = int(fps_time * fps)
            waiting = max(0, min(20, random.randint(min(lo, hi), hi)))
            conversation: List[dict] = []
            if waiting:
                conversation.append(
                    {"role": "stream", "num_frames": waiting, "learn": waiting > 1}
                )
            conversation.append(
                {"role": "user", "content": first["content"], "fps_time": fps_time}
            )
            start_fps_time = fps_time - waiting / fps

            for msg in anno["conversation"][1:]:
                t = msg["time"]
                if t > duration:
                    break
                prev_fps_time = conversation[-1]["fps_time"] if "fps_time" in conversation[-1] else fps_time
                fps_t = ceil_time_by_fps(t, fps, prev_fps_time, duration)
                if fps_t > duration:
                    break
                if msg["role"] == "user":
                    if fps_t > prev_fps_time:
                        conversation.append({
                            "role": "stream",
                            "num_frames": int((fps_t - prev_fps_time) * fps),
                            "learn": True,
                        })
                    conversation.append(
                        {"role": "user", "content": msg["content"], "fps_time": fps_t}
                    )
                else:
                    if fps_t > prev_fps_time:
                        num_frames = int((fps_t - prev_fps_time) * fps)
                        conversation.append(
                            {"role": "stream", "num_frames": num_frames, "learn": True}
                        )
                        span = msg.get("timespan")
                        resp_start = ceil_time_by_fps(
                            (span[0] + span[1]) / 2, fps, 0, duration
                        )
                        response_frame_num = min(
                            int((t - resp_start) * fps) + 1, num_frames
                        )
                        conversation.append({
                            "role": "assistant",
                            "content": msg["content"],
                            "fps_time": fps_t,
                            "learn": msg.get("learn", True),
                            "response_frame_num": response_frame_num,
                        })
            if conversation:
                last_fps_time = next(
                    (m["fps_time"] for m in reversed(conversation) if "fps_time" in m),
                    fps_time,
                )
                out.append({
                    "conversation": [
                        {k: v for k, v in m.items() if k != "fps_time"}
                        for m in conversation
                    ],
                    "load_ranges": {
                        video_uid: range(
                            int(start_fps_time * fps), int(last_fps_time * fps)
                        )
                    },
                })
        return out


class GroundingStreamDataset(StreamDataset):
    """One query + ONE stream turn spanning the video, labeled by
    relevance spans (reference `data/grounding.py:13-55`)."""

    query_templates = [
        "%s",
        "%s",
        "What segment of the video addresses the topic '%s'?",
        "At what timestamp can I find information about '%s' in the video?",
        "Can you highlight the section of the video that pertains to '%s'?",
        "Which moments in the video discuss '%s' in detail?",
        "Identify the parts that mention '%s'.",
        "Where in the video is '%s' demonstrated or explained?",
        "What parts are relevant to the concept of '%s'?",
        "Which clips in the video relate to the query '%s'?",
        "Can you point out the video segments that cover '%s'?",
        "What are the key timestamps in the video for the topic '%s'?",
    ]

    def informative_labels(self, conversation):
        return None

    def build_annos(self, raw) -> List[dict]:
        out = []
        fps = self.frame_fps
        for anno in raw:
            video_uid = anno.get("video_uid")
            meta = self.metadata.get(video_uid)
            if meta is None:
                continue
            duration = meta["duration"]
            related, current = [], 0
            for start_time, end_time in anno["timestamps"]:
                start_f = math.floor(start_time * fps)
                if start_f > current:
                    related.append({"related": False, "num_frames": start_f - current})
                end_f = math.floor(end_time * fps)
                related.append({"related": True, "num_frames": end_f - start_f})
                current = end_f
            last_f = math.floor(duration * fps)
            if last_f > current:
                related.append({"related": False, "num_frames": last_f - current})
            conversation = [
                {
                    "role": "user",
                    "content": random.choice(self.query_templates) % anno["query"],
                },
                {
                    "role": "stream",
                    "num_frames": last_f,
                    "learn": True,
                    "related": related,
                },
            ]
            out.append({
                "conversation": conversation,
                "load_ranges": {video_uid: range(0, last_f)},
            })
        return out


DATASET_CLASSES = {
    "DenseVideoCaptioningStreamDataset": DenseVideoCaptioningStreamDataset,
    "MAGQAStreamDataset": MAGQAStreamDataset,
    "GroundingStreamDataset": GroundingStreamDataset,
}


class ConcatStreamDataset:
    """Mixture of datasets (reference `data/__init__.py:17-22` +
    torch ConcatDataset)."""

    def __init__(self, datasets: Sequence[StreamDataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __getitem__(self, index: int):
        ds = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[ds][index - int(self._offsets[ds])]


def build_concat_train_dataset(config_path: str, tokenizer, **common) -> ConcatStreamDataset:
    """JSON list of {dataset_cls, ...kwargs} entries → concat dataset."""
    with open(config_path) as f:
        entries = json.load(f)
    datasets = []
    for entry in entries:
        entry = dict(entry)
        cls = DATASET_CLASSES[entry.pop("dataset_cls")]
        kwargs = {**common, **entry}
        datasets.append(cls(tokenizer=tokenizer, **kwargs))
    return ConcatStreamDataset(datasets)
