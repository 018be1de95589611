"""Host-side video decode utilities (CPU, OpenCV).

Video decode stays on the host CPU and feeds the TPU via device puts —
the equivalent of the reference's cv2 pipelines (`data/stream.py:97-117`,
`test/datasets.py:32-85`). Behavior contract kept exactly:

- wall-clock resampling: emit the next frame once the source timestamp
  passes ``i / output_fps``;
- aspect-preserving letterbox to a square canvas, centered, black padding;
- BGR→RGB; frames returned as (T, H, W, 3) uint8 (channels-last, the TPU
  layout, unlike the reference's TCHW).
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def letterbox(frame: np.ndarray, size: int, pad_color=(0, 0, 0)) -> np.ndarray:
    """Resize keeping aspect ratio, pad to (size, size) centered."""
    h, w = frame.shape[:2]
    if h == size and w == size:
        return frame
    if w > h:
        nw, nh = size, int(h / w * size)
    else:
        nh, nw = size, int(w / h * size)
    resized = cv2.resize(frame, (nw, nh))
    return cv2.copyMakeBorder(
        resized,
        top=(size - nh) // 2,
        bottom=(size - nh + 1) // 2,
        left=(size - nw) // 2,
        right=(size - nw + 1) // 2,
        borderType=cv2.BORDER_CONSTANT,
        value=pad_color,
    )


def probe_video(path: str) -> Dict:
    """Duration / fps / frame count of one file (cv2 header read)."""
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frame_count = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return {
        "duration": frame_count / fps if fps > 0 else 0.0,
        "fps": fps,
        "path": path,
        "frame_count": frame_count,
    }


def decode_video(
    path: str,
    output_fps: float,
    resolution: int,
    max_num_frames: Optional[int] = None,
    duration: Optional[float] = None,
) -> Tuple[np.ndarray, float, float]:
    """Sequential decode + wall-clock resample + letterbox.

    ``output_fps <= 0`` means 'auto': spread ``max_num_frames`` over the
    whole video (reference `test/datasets.py:43`).
    Returns (frames (T,H,W,3) uint8 RGB, effective_fps, video_duration).
    """
    cap = cv2.VideoCapture(path)
    in_fps = cap.get(cv2.CAP_PROP_FPS)
    frame_count = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    video_duration = duration if duration is not None else (
        frame_count / in_fps if in_fps > 0 else 0.0
    )
    fps = output_fps if output_fps > 0 else (max_num_frames / video_duration)
    n_total = math.ceil(video_duration * fps)
    target_sec = [i / fps for i in range(n_total)]

    frames: List[np.ndarray] = []
    cur_time, idx = 0.0, 0
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        if idx < len(target_sec) and cur_time >= target_sec[idx]:
            canvas = letterbox(frame, resolution)
            frames.append(cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB))
            idx += 1
        if max_num_frames is not None and len(frames) >= max_num_frames:
            break
        cur_time += 1.0 / in_fps
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), fps, video_duration


def build_metadata(
    video_root: str, metadata_path: str, num_workers: int = 16
) -> Dict[str, Dict]:
    """Probe every file under ``video_root`` once and cache to JSON
    (the reference's `videos_metadata.json` prep, `data/stream.py:73-95`;
    multi-host coordination is by filesystem atomicity instead of
    `dist.barrier`: the first process to finish wins the rename)."""
    if os.path.exists(metadata_path):
        with open(metadata_path) as f:
            return json.load(f)
    files = []
    for root, _, names in os.walk(video_root):
        for n in names:
            files.append(os.path.relpath(os.path.join(root, n), video_root))
    metadata = {}
    with ProcessPoolExecutor(num_workers) as pool:
        for file, meta in zip(
            files, pool.map(probe_video, [os.path.join(video_root, f) for f in files])
        ):
            metadata[file] = meta
    tmp = metadata_path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(metadata, f, indent=2)
    os.replace(tmp, metadata_path)
    return metadata
