"""The training step: gradient accumulation over micro-batches, one AdamW
update, and the non-finite guard.

Port of `mmduet_tpu/train/step.py`:

- one call consumes a whole accumulation window of A micro-batches (a
  host loop where JAX scans on device); gradients and metrics are
  averaged in f32 over A, then one optimizer update;
- the frozen SigLIP tower runs under `torch.no_grad()`; the projector and
  the pooling stay inside the differentiated region (they are trained);
- a non-finite loss or gradient norm skips the update: the trainable
  leaves and the optimizer state (its count included) stay as they were,
  while ``state.step`` still advances, so ``metrics["lr"] =
  sched(state.step)`` and the optimizer's count part, as in JAX.

``use_flash="auto"`` resolves to `qwen2_forward`'s own auto: kernel C for
every CUDA tensor, under a mesh too (on each rank's heads). The JAX step
resolves it to the plain attention, on the strength of a TPU timing that
does not carry to the GPU, and has no flash route under a mesh; on the
CPU both take the plain path.

Under a process mesh (``mesh=``, a `parallel.ProcessMesh`, one process per
rank; the base tree from `parallel.shard_params`, the state from
`parallel.shard_train_state`), every rank is called with its own share of
the global batch, cut on the host by `rank_batch` before it is staged
(or read alone, `train.loop.rank_real_batches`), and the ranks together
compute the step the one process computes on the whole batch, as the JAX
step under ``mesh=`` does:

- a rank's share is its part of the batch dim (dim 1) of every (A, B, T)
  leaf, the data cut of JAX's `batch_shardings`, and the frames of its own
  samples (the frame slots its placeholders count: the dim-1 cut of an
  (A, N, ...) leaf when every sample holds N / B slots), one array a
  micro-batch, since a rank's frame count differs between micro-batches;
- each loss is the rank's share of the global token mean
  (`models.mmduet.masked_ce`); gradients are summed over ``data`` once
  after the A micro-batches, then divided by A; a whole adapter of a
  projection cut over ``model`` has a partial gradient on each rank
  (`parallel.sharding.lora_cut_over_model`), summed over ``model``;
- the gradient norm is the whole tree's (`optimizer.global_norm` with the
  leaves cut over ``model``), and metrics are read only from reduced
  values, so every rank reports the same bits and skips together;
- the update is ZeRO-2 (`optimizer.zero2_update`) where ``data`` > 1.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import MMDuetConfig, TrainArgs

from ..models import mmduet, siglip
from ..models.lora import lora_scale
from ..parallel.collectives import sum_data, sum_flat, sum_model
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import lora_cut_over_model, trainable_specs
from .optimizer import (AdamW, Schedule, global_norm, merge_trainable, trainable_params,
                        tree_leaves, tree_map, zero2_update)

METRIC_KEYS = ("loss", "lm_loss", "video_loss")
_FRAME_KEYS = ("frames", "vision_feats")


class TrainState(NamedTuple):
    step: int
    trainable: Any
    opt_state: Any


def init_train_state(params: Dict, lora: Any, tx: AdamW) -> TrainState:
    trainable = trainable_params(params, lora)
    return TrainState(step=0, trainable=trainable, opt_state=tx.init(trainable))


def _frame_embeds(params: Dict, cfg: MMDuetConfig, micro: Dict) -> Optional[torch.Tensor]:
    """Frame tokens of one micro-batch: frozen SigLIP (no graph), then the
    trained projector and pooling."""
    if "vision_feats" in micro:
        feats = micro["vision_feats"].detach()
    elif "frames" in micro:
        px = siglip.normalize_pixels(micro["frames"]).to(params["projector"]["fc1"].dtype)
        with torch.no_grad():
            feats = siglip.siglip_encode(params["vision"], cfg.vision, px)
    else:
        return None
    return mmduet.spatial_pool(mmduet.project(params, feats), cfg)


def rank_batch(batch: Dict, cfg: MMDuetConfig, mesh) -> Dict:
    """This rank's share of a host ``batch`` of A micro-batches (numpy
    arrays or CPU tensors), the placement JAX's `batch_shardings` gives a
    device: rows ``[d * B / D, (d + 1) * B / D)`` of every (A, B, T) leaf for
    data rank ``d`` of ``D``, and of each frame leaf (``frames`` (A, N, H,
    W, 3), ``vision_feats`` (A, N, P, C)) a tuple of A arrays, micro-batch
    ``a``'s slots that those rows' placeholders count. A rank whose samples
    hold no frame keeps one zero frame slot, which nothing reads, so that
    every rank of the data axis runs the tower's collectives (a rank that
    reads only its own samples, `train.loop.rank_real_batches`, has no
    other rank's slot to keep). With no mesh or one data rank (the model
    ranks of a data rank stage the same rows) the batch is returned as it
    is. A batch is cut once: a share, its frames a tuple, is refused."""
    data_n = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if data_n == 1:
        return batch
    if any(isinstance(v, tuple) for v in batch.values()):
        raise ValueError("rank_batch: the batch is already a rank's share")
    A, B = batch["input_ids"].shape[:2]
    if B % data_n:
        raise ValueError(f"a micro-batch of {B} samples over a data axis of {data_n}")
    per, d = B // data_n, mesh.index(DATA_AXIS)
    rows = slice(d * per, (d + 1) * per)
    counts = (batch["input_ids"] == cfg.v_placeholder_id).sum(-1) // cfg.frame_num_tokens
    spans = []
    for a in range(A):
        start, n = int(counts[a, :rows.start].sum()), int(counts[a, rows].sum())
        spans.append(slice(start, start + n) if n else None)

    def frames(v, a, span):
        if span is not None:
            return v[a, span]
        zero = (1, *v.shape[2:])
        return torch.zeros(zero, dtype=v.dtype) if torch.is_tensor(v) else np.zeros(zero, v.dtype)

    return {k: tuple(frames(v, a, span) for a, span in enumerate(spans)) if k in _FRAME_KEYS
            else v[:, rows] for k, v in batch.items()}


def make_grad_fn(cfg: MMDuetConfig, args: TrainArgs, mesh=None,
                 use_flash: Any = "auto") -> Callable[[Any, Dict, Dict], Tuple[Any, Dict]]:
    """``grads(trainable, base_params, batch) -> (grads, metrics)``: the
    f32 gradients of the trainable leaves and the losses, averaged over the
    A micro-batches, on a mesh reduced to the whole batch's from the rank's
    share (`rank_batch`) (the rank's local blocks of the whole gradients;
    metrics as tensors, the same bits on every rank)."""
    scale = lora_scale(args.lora_r, args.lora_alpha)
    remat = args.gradient_checkpointing
    flash = None if use_flash == "auto" else use_flash

    def grads_of(trainable: Any, base_params: Dict, batch: Dict) -> Tuple[Any, Dict]:
        A = batch["input_ids"].shape[0]
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), trainable)
        sums = {k: 0.0 for k in METRIC_KEYS}
        for a in range(A):
            micro = {k: v[a] for k, v in batch.items()}
            leaves = tree_map(lambda p: p.detach().requires_grad_(True), trainable)
            params = merge_trainable(base_params, leaves)
            out = mmduet.train_forward(
                params, cfg, micro["input_ids"], micro["attn_mask"],
                _frame_embeds(params, cfg, micro), micro["labels"],
                micro["informative_labels"], micro["relevance_labels"],
                lora=leaves["lora"], lora_scale=scale, remat=remat, use_flash=flash,
            )
            # a leaf the loss does not reach (the projector of a text-only
            # micro-batch) gets no gradient: it adds zero, as in JAX
            got = iter(torch.autograd.grad(out.loss, list(tree_leaves(leaves)),
                                           allow_unused=True))
            grads = tree_map(lambda acc: _add(acc, next(got)), grads)
            del got  # its tuple would hold these gradients through the next backward
            for k in METRIC_KEYS:
                sums[k] = sums[k] + getattr(out, k).detach().float()
        if mesh is not None:
            grads = _reduce_grads(grads, mesh)
            total = sum_data(torch.stack([sums[k] for k in METRIC_KEYS]))
            sums = dict(zip(METRIC_KEYS, total.unbind()))
        return tree_map(lambda g: g / A, grads), {k: v / A for k, v in sums.items()}

    return grads_of


def _reduce_grads(grads: Dict, mesh) -> Dict:
    """A rank's accumulated gradients made the whole batch's: every leaf
    summed over ``data`` and the adapters of cut projections over
    ``model``, one collective each."""
    flat = list(tree_leaves(grads))
    it = iter(sum_flat(flat, sum_data))
    grads = tree_map(lambda _: next(it), grads)
    summed = [name for name, c in lora_cut_over_model(grads["lora"], mesh).items() if c]
    parts = [grads["lora"][n][k] for n in summed for k in ("a", "b")]
    it = iter(sum_flat(parts, sum_model))
    lora = dict(grads["lora"])
    for n in summed:
        lora[n] = {k: next(it) for k in ("a", "b")}
    return dict(grads, lora=lora)


def make_train_step(
    cfg: MMDuetConfig,
    args: TrainArgs,
    tx: AdamW,
    lr_sched: Optional[Schedule] = None,
    use_flash: Any = "auto",
    mesh=None,
):
    """Build ``train_step(state, base_params, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device with a leading
    accumulation dim A: input_ids / attn_mask / labels /
    informative_labels / relevance_labels (A, B, T), and optionally frames
    (A, N, H, W, 3) uint8 or vision_feats (A, N, P, C). ``metrics`` are
    host floats under the JAX step's keys. With ``mesh`` (this rank's
    `parallel.ProcessMesh`), ``state`` and ``base_params`` are the rank's
    local trees and ``batch`` is the rank's share that `rank_batch` cut on
    the host, its frames one tensor a micro-batch (see the module's
    docstring)."""
    if mesh is not None:
        model_n = mesh.shape[MODEL_AXIS]
        t = cfg.text
        if any(n % model_n for n in (t.num_heads, t.num_kv_heads, t.intermediate_size)):
            raise ValueError(f"mesh {mesh.shape}: {t.num_heads} heads, {t.num_kv_heads} kv "
                             f"heads and {t.intermediate_size} MLP units must divide the "
                             "model axis")
    grads_of = make_grad_fn(cfg, args, mesh, use_flash)
    zero2 = mesh is not None and mesh.shape[DATA_AXIS] > 1

    def train_step(state: TrainState, base_params: Dict, batch: Dict):
        grads, metrics = grads_of(state.trainable, base_params, batch)
        cut = None
        if mesh is not None:
            cut = tree_map(lambda s: MODEL_AXIS in s, trainable_specs(state.trainable, mesh))
        grad_norm = global_norm(grads, cut)
        finite = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(grad_norm))
        if finite and zero2:
            trainable, opt_state = zero2_update(tx, grads, state.opt_state, state.trainable,
                                                grad_norm, mesh)
        elif finite:
            trainable, opt_state = tx.update(grads, state.opt_state, state.trainable, grad_norm)
        else:  # skip the update, keep the state; the step still advances
            trainable, opt_state = state.trainable, state.opt_state
        out_metrics = {k: float(v) for k, v in metrics.items()}
        out_metrics["grad_norm"] = float(grad_norm)
        out_metrics["skipped_nonfinite"] = 0.0 if finite else 1.0
        if lr_sched is not None:
            out_metrics["lr"] = float(lr_sched(state.step))
        return TrainState(state.step + 1, trainable, opt_state), out_metrics

    return train_step


def _add(acc: torch.Tensor, grad: Optional[torch.Tensor]) -> torch.Tensor:
    return acc if grad is None else acc + grad.float()
