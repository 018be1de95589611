"""The training step: gradient accumulation over micro-batches, one AdamW
update, and the non-finite guard.

Port of `mmduet_tpu/train/step.py` on one device:

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
every CUDA tensor. The JAX step resolves it to the plain attention, on the
strength of a TPU timing that does not carry to the GPU; on the CPU both
take the plain path.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from mmduet_tpu.config import MMDuetConfig, TrainArgs

from ..models import mmduet, siglip
from ..models.lora import lora_scale
from .optimizer import (AdamW, Schedule, global_norm, merge_trainable, trainable_params,
                        tree_leaves, tree_map)

METRIC_KEYS = ("loss", "lm_loss", "video_loss")


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


def make_train_step(
    cfg: MMDuetConfig,
    args: TrainArgs,
    tx: AdamW,
    lr_sched: Optional[Schedule] = None,
    use_flash: Any = "auto",
):
    """Build ``train_step(state, base_params, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the model's device with a leading
    accumulation dim A: input_ids / attn_mask / labels /
    informative_labels / relevance_labels (A, B, T), and optionally frames
    (A, N, H, W, 3) uint8 or vision_feats (A, N, P, C). ``metrics`` are
    host floats under the JAX step's keys."""
    scale = lora_scale(args.lora_r, args.lora_alpha)
    remat = args.gradient_checkpointing
    flash = None if use_flash == "auto" else use_flash

    def train_step(state: TrainState, base_params: Dict, batch: Dict):
        A = batch["input_ids"].shape[0]
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), state.trainable)
        sums = {k: 0.0 for k in METRIC_KEYS}
        for a in range(A):
            micro = {k: v[a] for k, v in batch.items()}
            leaves = tree_map(lambda p: p.detach().requires_grad_(True), state.trainable)
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
            for k in METRIC_KEYS:
                sums[k] = sums[k] + getattr(out, k).detach().float()
        grads = tree_map(lambda g: g / A, grads)
        metrics = {k: v / A for k, v in sums.items()}

        grad_norm = global_norm(grads)
        finite = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(grad_norm))
        if finite:
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
