"""Offline preprocessing: re-encode videos and pre-extract tower features.

Port of `mmduet_tpu/data/preprocess.py`, the rebuild of the reference's
offline pipeline (`data/utils.py:63-117`):

- `ffmpeg_once`, `reencode_video_cv2`, `sharded_reencode` (and
  `VIDEO_EXTS`, `_have_ffmpeg`, `list_videos`, `dst_root_for`): copies of the
  JAX module's host functions, pinned equal by the tests;
- `extract_features` / `sharded_extract`: decode each video and run the
  port's SigLIP tower (`models.siglip`; its attention is kernel D on a CUDA
  device), ``batch_size`` frames at a time, each batch padded to that size
  and uploaded through pinned memory; per-video RAW tower patches (T,
  num_patches, vision_hidden) saved as ``.npy`` with a ``.json`` sidecar,
  the JAX package's file names and format, so either package reads the
  other's files. The training collator consumes them as ``vision_feats``
  and the engine through ``input_vision_feats``.

On a CUDA device the tower runs in bf16 (kernel D takes bf16 only) and the
features come back as f32; on the CPU it runs in f32, as the JAX default
does. ``--bf16`` stores the features rounded to bf16 (round to nearest
even) as the JAX package's ``ml_dtypes`` arrays are stored, ``'<V2'``
items, without ``ml_dtypes``; `load_features` widens such a file to f32.

CLI:
    python -m mmduet_tpu_torch.data.preprocess reencode --src_root d/videos \\
        --fps 2 --resolution 384 [--num_shards 8 --shard_index 0]
    python -m mmduet_tpu_torch.data.preprocess encode \\
        --src_root d/videos_2fps_max384 --checkpoint <ckpt> --fps 2 \\
        [--batch_size 32] [--bf16] [--device cpu]

Shards come from ``--num_shards`` / ``--shard_index``, else a SLURM array or
job, else the rank and world size of a `torch.distributed` process group
that the caller has already initialized (this module never initializes one).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
from typing import Any, List, Optional

import numpy as np
import torch

VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".webm", ".mov")


def ffmpeg_once(
    src_path: str,
    dst_path: str,
    *,
    fps: Optional[int] = None,
    resolution: Optional[int] = None,
    pad: str = "#000000",
    mode: str = "bicubic",
    ffmpeg_bin: str = "ffmpeg",
) -> None:
    """Re-encode one video (same CLI contract as reference
    `data/utils.py:63-79`): ``-n`` skip-if-exists, audio stripped, optional
    fps resample and aspect-preserving scale to ``resolution`` with
    centered padding."""
    if os.path.exists(dst_path):
        return  # skip-if-exists (ffmpeg's -n would EXIT 1 on an existing
        # file, which would abort a resumed sharded run under check=True)
    os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
    command = [
        ffmpeg_bin,
        "-n",  # belt-and-braces vs concurrent writers
        "-sws_flags", mode,
        "-i", src_path,
        "-an",
        "-threads", "10",
    ]
    if fps is not None:
        command += ["-r", str(fps)]
    if resolution is not None:
        assert pad is not None
        command += [
            "-vf",
            f"scale='if(gt(iw\\,ih)\\,{resolution}\\,-2)':'if(gt(iw\\,ih)\\,-2\\,{resolution})'"
            f",pad={resolution}:{resolution}:(ow-iw)/2:(oh-ih)/2:color='{pad}'",
        ]
    command += [dst_path]
    subprocess.run(command, check=True)


def reencode_video_cv2(
    src_path: str,
    dst_path: str,
    *,
    fps: Optional[int] = None,
    resolution: Optional[int] = None,
) -> None:
    """cv2 fallback with the same semantics (fps resample via wall-clock
    selection, letterbox to a square canvas). Skips if dst exists."""
    import cv2

    from .video import letterbox

    if os.path.exists(dst_path):
        return
    os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
    cap = cv2.VideoCapture(src_path)
    in_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    out_fps = fps if fps is not None else in_fps
    size = None
    writer = None
    cur, next_t = 0.0, 0.0
    tmp = dst_path + ".tmp.mp4"
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        if cur + 1e-9 >= next_t:
            if resolution is not None:
                frame = letterbox(frame, resolution)
            if writer is None:
                size = (frame.shape[1], frame.shape[0])
                writer = cv2.VideoWriter(
                    tmp, cv2.VideoWriter_fourcc(*"mp4v"), out_fps, size
                )
            writer.write(frame)
            next_t += 1.0 / out_fps
        cur += 1.0 / in_fps
    cap.release()
    if writer is None:
        raise ValueError(f"no frames decoded from {src_path}")
    writer.release()
    os.replace(tmp, dst_path)


def _have_ffmpeg(ffmpeg_bin: str) -> bool:
    try:
        subprocess.run(
            [ffmpeg_bin, "-version"], capture_output=True, check=True
        )
        return True
    except Exception:
        return False


def list_videos(src_root: str) -> List[str]:
    pather = pathlib.Path(src_root)
    return sorted(
        str(p) for p in pather.rglob("*")
        if p.is_file() and p.suffix.lower() in VIDEO_EXTS
    )


def dst_root_for(src_root: str, fps: Optional[int], resolution: Optional[int]) -> str:
    """Reference naming: ``videos`` -> ``videos_2fps_max384``
    (`data/utils.py:88-92`)."""
    dst = src_root.rstrip("/")
    if fps is not None:
        dst += f"_{fps}fps"
    if resolution is not None:
        dst += f"_max{resolution}"
    return dst


def sharded_reencode(
    src_root: str,
    *,
    fps: Optional[int] = None,
    resolution: Optional[int] = None,
    pad: str = "#000000",
    mode: str = "bicubic",
    num_shards: int = 1,
    shard_index: int = 0,
    ffmpeg_bin: str = "ffmpeg",
) -> str:
    """Re-encode every video under ``src_root`` (this shard's slice) into
    the derived dst root. Returns the dst root."""
    src_root = src_root.rstrip("/")
    dst_root = dst_root_for(src_root, fps, resolution)
    use_ffmpeg = _have_ffmpeg(ffmpeg_bin)
    for i, src in enumerate(list_videos(src_root)):
        if i % num_shards != shard_index:
            continue
        # relpath+join, NOT str.replace: a filename containing the root
        # string (e.g. videos/my_videos.mp4) must keep its basename
        dst = os.path.join(dst_root, os.path.relpath(src, src_root))
        if use_ffmpeg:
            ffmpeg_once(
                src, dst, fps=fps, resolution=resolution, pad=pad, mode=mode,
                ffmpeg_bin=ffmpeg_bin,
            )
        else:
            reencode_video_cv2(dst_path=dst, src_path=src, fps=fps, resolution=resolution)
    return dst_root


def _tower_as(tree: Any, dtype: torch.dtype) -> Any:
    """The tower's floating leaves in ``dtype`` (no copy where they are
    already); quantized leaves (``{"qw", "qs"}``) stay as they are."""
    from ..models.quant import is_quantized

    if isinstance(tree, dict):
        return tree if is_quantized(tree) else {k: _tower_as(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _encode_frames(frames: np.ndarray, vision_params, vision_cfg, batch_size: int = 32,
                   dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """uint8 (T, H, W, 3) frames -> raw SigLIP patch features (T,
    num_patches, vision_hidden), f32 numpy, on the tower's device: each
    batch of ``batch_size`` frames is padded to that size (one batch shape,
    as the engines encode), uploaded through pinned memory on a CUDA
    device, normalized, cast to ``dtype`` (default: bf16 on a CUDA device,
    f32 on the CPU) and encoded; the features cross to the host in f32,
    each batch into its rows of one host array."""
    from ..infer.state import upload_pixels
    from ..models.siglip import normalize_pixels, siglip_encode

    device = vision_params["pos_embed"].device
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = _tower_as(vision_params, dtype)
    frames = np.asarray(frames)
    if frames.shape[0] == 0:
        raise ValueError("_encode_frames: no frames to encode")
    feats = None
    with torch.inference_mode():
        for i in range(0, frames.shape[0], batch_size):
            up = upload_pixels(frames[i: i + batch_size], device, batch_size)
            px = normalize_pixels(up.buf).to(dtype)
            out = siglip_encode(params, vision_cfg, px)
            if feats is None:
                feats = torch.empty((frames.shape[0], *out.shape[1:]), dtype=torch.float32)
            feats[i: i + up.n].copy_(out[: up.n])
    return feats.numpy()


def extract_features(
    video_path: str,
    vision_params,
    vision_cfg,
    *,
    output_fps: float,
    resolution: int,
    batch_size: int = 32,
    max_num_frames: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
):
    """Decode one video and run the SigLIP tower -> raw patch features
    (T, num_patches, vision_hidden) as an f32 numpy array, with the
    video's fps and duration."""
    from .video import decode_video

    frames, fps, duration = decode_video(
        video_path, output_fps=output_fps, resolution=resolution,
        max_num_frames=max_num_frames,
    )
    feats = _encode_frames(frames, vision_params, vision_cfg, batch_size, dtype)
    return feats, fps, duration


def write_bf16_npy(path: str, feats: np.ndarray) -> None:
    """``feats`` rounded to bf16 (round to nearest even, as ``ml_dtypes``
    rounds) and saved as the JAX package saves an ``ml_dtypes.bfloat16``
    array: a ``.npy`` of ``'<V2'`` items holding the bf16 bits. Byte-equal
    to that file, without ``ml_dtypes``."""
    bits = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(torch.bfloat16)
    raw = bits.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": raw.shape})
        f.write(raw.astype("<i2", copy=False).tobytes())


def sharded_extract(
    src_root: str,
    vision_params,
    vision_cfg,
    *,
    output_fps: float,
    resolution: int,
    embed_mark: str = "local",
    model_tag: str = "siglip",
    batch_size: int = 32,
    num_shards: int = 1,
    shard_index: int = 0,
    save_bf16: bool = False,
) -> str:
    """Feature-extract every video under ``src_root`` (this shard's
    slice) to ``<src_root>_<mark>_<model_tag>/<name>.npy`` + a sidecar
    ``.json`` with fps/duration (reference dst naming,
    `data/utils.py:104`). Returns the dst root."""
    src_root = src_root.rstrip("/")
    dst_root = f"{src_root}_{embed_mark.split('_')[-1]}_{model_tag.replace('/', '--')}"
    os.makedirs(dst_root, exist_ok=True)
    for i, src in enumerate(list_videos(src_root)):
        if i % num_shards != shard_index:
            continue
        rel = os.path.relpath(src, src_root)
        dst = os.path.join(dst_root, os.path.splitext(rel)[0] + ".npy")
        if os.path.exists(dst):
            continue
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        feats, fps, duration = extract_features(
            src, vision_params, vision_cfg,
            output_fps=output_fps, resolution=resolution, batch_size=batch_size,
        )
        if save_bf16:  # stored compact; `load_features` widens it to f32
            write_bf16_npy(dst + ".tmp.npy", feats)
        else:
            np.save(dst + ".tmp.npy", feats)
        os.replace(dst + ".tmp.npy", dst)
        with open(os.path.splitext(dst)[0] + ".json", "w") as f:
            json.dump({"fps": fps, "duration": duration, "src": rel}, f)
    return dst_root


def load_features(path: str) -> np.ndarray:
    """Load a pre-extracted feature file as f32: f32, another float type,
    or bf16 bits (``'<V2'`` items as the JAX package's ``ml_dtypes`` arrays
    are stored, or ``uint16``), widened exactly."""
    feats = np.load(path)
    if feats.dtype.kind == "V" and feats.dtype.itemsize == 2 or feats.dtype == np.uint16:
        bits = feats.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    if feats.dtype != np.float32:
        feats = feats.astype(np.float32)
    return feats


def _resolve_cluster_shard(num_shards: int, shard_index: int):
    """Auto-shard from the cluster scheduler when the CLI is launched as an
    array or distributed job with default shard args (the reference's
    submitit SLURM sharding, `data/utils.py:81-117`, without submitit):
    SLURM array / step env vars first, then the rank and world size of a
    `torch.distributed` process group, only if one is available and already
    initialized (preprocessing never initializes one). Explicit
    --num_shards/--shard_index always win."""
    if num_shards != 1 or shard_index != 0:
        return num_shards, shard_index
    env = os.environ
    if env.get("SLURM_ARRAY_TASK_COUNT"):
        n = int(env["SLURM_ARRAY_TASK_COUNT"])
        i = int(env.get("SLURM_ARRAY_TASK_ID", 0)) - int(
            env.get("SLURM_ARRAY_TASK_MIN", 0)
        )
        if n > 1:
            print(f"[preprocess] SLURM array sharding: {i}/{n}")
            return n, i
    if env.get("SLURM_NTASKS"):
        n = int(env["SLURM_NTASKS"])
        i = int(env.get("SLURM_PROCID", 0))
        if n > 1:
            print(f"[preprocess] SLURM task sharding: {i}/{n}")
            return n, i
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
        if n > 1:
            print(f"[preprocess] torch.distributed sharding: {i}/{n}")
            return n, i
    return num_shards, shard_index


def main(argv=None):
    p = argparse.ArgumentParser(description="MMDuet offline preprocessing (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reencode", help="fps/resolution re-encode a video tree")
    r.add_argument("--src_root", required=True)
    r.add_argument("--fps", type=int, default=None)
    r.add_argument("--resolution", type=int, default=None)
    r.add_argument("--pad", default="#000000")
    r.add_argument("--mode", default="bicubic")
    r.add_argument("--num_shards", type=int, default=1)
    r.add_argument("--shard_index", type=int, default=0)
    r.add_argument("--ffmpeg_bin", default="ffmpeg")

    e = sub.add_parser("encode", help="pre-extract SigLIP features")
    e.add_argument("--src_root", required=True)
    e.add_argument("--checkpoint", required=True,
                   help="the port's checkpoint dir (for the vision tower)")
    e.add_argument("--fps", type=float, required=True)
    e.add_argument("--resolution", type=int, default=None,
                   help="default: the checkpoint's frame_resolution")
    e.add_argument("--embed_mark", default="local")
    e.add_argument("--batch_size", type=int, default=32)
    e.add_argument("--num_shards", type=int, default=1)
    e.add_argument("--shard_index", type=int, default=0)
    e.add_argument("--bf16", action="store_true")
    e.add_argument("--device", default="cuda",
                   help="torch device the tower runs on (default cuda)")

    args = p.parse_args(argv)
    args.num_shards, args.shard_index = _resolve_cluster_shard(
        args.num_shards, args.shard_index
    )
    if args.cmd == "reencode":
        dst = sharded_reencode(
            args.src_root, fps=args.fps, resolution=args.resolution,
            pad=args.pad, mode=args.mode, num_shards=args.num_shards,
            shard_index=args.shard_index, ffmpeg_bin=args.ffmpeg_bin,
        )
    else:
        from ..models.io import load_checkpoint

        cfg, params, _ = load_checkpoint(args.checkpoint, torch.device(args.device))
        if cfg.vision_arch != "siglip":
            raise SystemExit("encode extracts SigLIP features; the checkpoint's tower is "
                             f"{cfg.vision_arch!r}")
        resolution = args.resolution or cfg.frame_resolution
        dst = sharded_extract(
            args.src_root, params["vision"], cfg.vision,
            output_fps=args.fps, resolution=resolution,
            embed_mark=args.embed_mark, model_tag="siglip",
            batch_size=args.batch_size, num_shards=args.num_shards,
            shard_index=args.shard_index, save_bf16=args.bf16,
        )
    print(f"done -> {dst}")


if __name__ == "__main__":
    main()
