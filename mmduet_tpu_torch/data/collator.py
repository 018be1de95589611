"""Training collator: duet samples → static-shape TPU batches.

Rebuild of `data_collator_with_video_labels`
(`data/data_collator.py:7-52`): tokenize with char offsets, convert learn
ranges to PRE-SHIFTED LM labels, attach per-frame informative/relevance
labels to the last ``<image>`` token of each frame.

TPU-first differences:
- **right padding** to a FIXED (seq_len, num_frames) shape — every batch
  compiles once (the reference left-pads to the longest-in-batch, a new
  shape every step);
- **static length buckets** (``buckets=...``): pad each micro-batch to the
  smallest bucket that fits its longest sample instead of always
  ``seq_len``. The MMDuetIT mixture spans ~1k-token grounding samples to
  ~5k-token DVC samples, so one protocol-max pad burns full-length
  attention+matmul on padding for most samples (measured 0.395 MFU at
  T≈5k vs 0.534 at T=2048 — VERDICT r4 weak #5). A handful of static
  shapes keeps XLA's compile-once property (the inference engines'
  bucket-table pattern, `infer/state.py`); the reference's per-batch
  longest-in-batch pad is a NEW shape every step. Padding never changes
  the step's math (every loss masks pads) — pinned by
  `tests/test_train_buckets.py::test_pad_invariance`;
- frames ride as uint8 pixels (vision encode happens on device inside the
  train step) or as pre-extracted features;
- overlong samples are truncated at a frame boundary, never mid-frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..stream.labels import (
    IGNORE_INDEX,
    char_ranges_to_token_labels,
    scatter_frame_labels,
)


@dataclass
class Collator:
    tokenizer: object
    seq_len: int  # fixed padded sequence length
    max_frames: int  # fixed padded frame count (across the whole batch)
    frame_size: Optional[int] = None  # None → samples carry vision feats
    # (patches, channels) of pre-extracted features — required in feature
    # mode to emit a correctly-shaped empty ``vision_feats`` when a
    # micro-batch has zero frames (text-only / skip_video samples)
    feat_shape: Optional[Tuple[int, int]] = None
    # static pad-length table (ascending, each <= seq_len): pad to the
    # smallest bucket >= the micro-batch's longest sample. None = always
    # pad to seq_len (the fixed-shape r4 behavior).
    buckets: Optional[Tuple[int, ...]] = None
    # same idea for the FRAME axis (each <= max_frames): in pixel mode
    # the tower encodes every padded slot, so a grounding micro with 10
    # frames padded to 100 burns 10x vision compute; padded frames are
    # never gathered into the text stream either way (joint_embed's
    # cumsum stops at the real placeholders), so this is pure throughput.
    frame_buckets: Optional[Tuple[int, ...]] = None

    @staticmethod
    def _norm_table(table, cap, what):
        b = tuple(sorted(table))
        if not b or b[-1] > cap:
            raise ValueError(
                f"{what} {b} must be non-empty and <= {cap}"
            )
        # the cap is always the terminal bucket, so every micro fits
        return b if b[-1] == cap else b + (cap,)

    def __post_init__(self):
        if self.buckets is not None:
            # truncation caps sample length at seq_len
            self.buckets = self._norm_table(
                self.buckets, self.seq_len, "buckets"
            )
        if self.frame_buckets is not None:
            self.frame_buckets = self._norm_table(
                self.frame_buckets, self.max_frames, "frame_buckets"
            )

    def __call__(self, samples: Sequence[tuple]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer
        ft = tok.template.frame_num_tokens
        vid = tok.v_placeholder_id
        B = len(samples)

        ids_list, labels_list, inf_list, rel_list, nreal = [], [], [], [], []
        all_frames: List[np.ndarray] = []
        sample_idxs = []
        for text, frames, learn_ranges, inf, rel, idx in samples:
            ids, offsets = tok.encode_with_offsets(text)
            ids = np.asarray(ids, np.int32)
            labels = char_ranges_to_token_labels(ids, offsets, learn_ranges)
            inf_tok = scatter_frame_labels(ids, vid, ft, inf)
            rel_tok = scatter_frame_labels(ids, vid, ft, rel)
            if len(ids) > self.seq_len:
                # truncate at a frame boundary: drop any frame whose
                # placeholder group would be split by the cut, and the
                # corresponding trailing pixels/features
                cut = self.seq_len
                (v_pos,) = np.nonzero(ids[:cut] == vid)
                complete = len(v_pos) // ft
                if len(v_pos) % ft:
                    cut = int(v_pos[complete * ft])
                if frames is not None and len(frames) > complete:
                    frames = frames[:complete]
                ids = ids[:cut]
                labels = labels[:cut]
                inf_tok = inf_tok[:cut]
                rel_tok = rel_tok[:cut]
            ids_list.append(ids)
            labels_list.append(labels)
            inf_list.append(inf_tok)
            rel_list.append(rel_tok)
            nreal.append(len(ids))
            if frames is not None and len(frames):
                all_frames.append(np.asarray(frames))
            sample_idxs.append(idx)

        L = self.seq_len
        if self.buckets is not None:
            longest = max(nreal)
            L = next(b for b in self.buckets if b >= longest)
        pad_id = tok.pad_token_id

        def pad2(rows, fill):
            out = np.full((B, L), fill, np.int32)
            for i, r in enumerate(rows):
                out[i, : len(r)] = r
            return out

        input_ids = pad2(ids_list, pad_id)
        attn_mask = np.zeros((B, L), bool)
        for i, n in enumerate(nreal):
            attn_mask[i, :n] = True

        batch = {
            "input_ids": input_ids,
            "attn_mask": attn_mask,
            "labels": pad2(labels_list, IGNORE_INDEX),
            "informative_labels": pad2(inf_list, IGNORE_INDEX),
            "relevance_labels": pad2(rel_list, IGNORE_INDEX),
            "sample_idxs": np.asarray(sample_idxs, np.int32),
            # host-side metadata (stripped before device put): real-token
            # throughput / pad-fraction reporting in the train loop
            "n_real_tokens": np.asarray(sum(nreal), np.int64),
        }

        if all_frames:
            frames_cat = np.concatenate(all_frames)
        elif self.frame_size is not None:
            frames_cat = np.zeros(
                (0, self.frame_size, self.frame_size, 3), np.uint8
            )
        elif self.feat_shape is not None:
            # feature mode: the empty batch must still carry the
            # ``vision_feats`` key (and shape) so grad-accum stacking and
            # the jitted step see one consistent layout
            frames_cat = np.zeros((0, *self.feat_shape), np.float32)
        else:
            raise ValueError(
                "feature-mode Collator (frame_size=None) needs feat_shape "
                "to collate a micro-batch with zero frames"
            )
        n_frames = len(frames_cat)
        if n_frames > self.max_frames:
            raise ValueError(
                f"batch has {n_frames} frames > collator max_frames "
                f"{self.max_frames}"
            )
        # pad the frame axis to a static count (bucketed or max); padded
        # frames are never gathered (joint_embed's cumsum stops at the
        # real placeholders)
        N = self.max_frames
        if self.frame_buckets is not None:
            N = next(b for b in self.frame_buckets if b >= n_frames)
        padded = np.zeros((N, *frames_cat.shape[1:]), frames_cat.dtype)
        padded[:n_frames] = frames_cat
        batch["frames" if frames_cat.ndim == 4 else "vision_feats"] = padded
        batch["num_frames"] = np.asarray(n_frames, np.int32)
        return batch


def stack_accum(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack A collated micro-batches into the (A, ...) layout the jitted
    train step scans over."""
    keys = batches[0].keys()
    return {k: np.stack([b[k] for b in batches]) for k in keys}
