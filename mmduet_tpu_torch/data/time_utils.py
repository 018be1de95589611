"""Frame-grid time snapping (reference `data/utils.py:119-126`)."""

import math


def _clamp(t: float, lo: float, hi: float) -> float:
    return min(max(t, lo), hi)


def round_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return _clamp(round(time * fps) / fps, min_time, max_time)


def ceil_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return _clamp(math.ceil(time * fps) / fps, min_time, max_time)


def floor_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return _clamp(math.floor(time * fps) / fps, min_time, max_time)
