#!/usr/bin/env bash
# MMDuet training recipe on GPUs (the PyTorch port), the counterpart of
# `scripts/train.sh` with the same protocol knobs (the reference's
# `scripts/train.sh:4-17`: torchrun x 8 with DeepSpeed ZeRO-2, batch 1,
# accum 16, LR 2e-5 cosine with warmup 0.05, 2 fps, <= 100 frames, LoRA
# r 16 / alpha 32). The port runs one process per card: NPROC > 1 starts
# the trainer under `python -m torch.distributed.run`, and the mesh flags
# say how the ranks split the work (MESH_DATA x MESH_MODEL = NPROC;
# PARAM_MODE replicate is ZeRO-2, fsdp also cuts the frozen base).
#
#   CHECKPOINT=<converted dir> NPROC=8 bash scripts/train_torch.sh
#
# Smoke mode (no checkpoint / no datasets):
#   TINY_RANDOM=1 bash scripts/train_torch.sh                  # one process on the card
#   TINY_RANDOM=1 DEVICE=cpu bash scripts/train_torch.sh        # on the CPU
#   TINY_RANDOM=1 NPROC=2 DIST_BACKEND=gloo DEVICE=cuda:0 bash scripts/train_torch.sh
#                                          # two ranks sharing one card
# Environment: DEVICE (cuda; cuda:N or cpu), NPROC (1), MESH_DATA (NPROC /
# MESH_MODEL), MESH_MODEL (1), PARAM_MODE (replicate), DIST_BACKEND (nccl;
# gloo for CPU ranks or ranks sharing one card), and the knobs of
# `scripts/train.sh`: TINY_RANDOM, DATASET_CONFIG, SEQ_LEN, SYNTHETIC_STEPS,
# CHECKPOINT, RESUME, OUTPUT_DIR, EPOCHS, ACCUM, SAVE_STEPS,
# SAVE_TOTAL_LIMIT, LR, LOGGING_STEPS, MAX_FRAMES.
set -eo pipefail

output_dir=${OUTPUT_DIR:-outputs/mmduet-train_output}
mkdir -p "$output_dir"

if [ -n "$TINY_RANDOM" ]; then
    if [ -n "$DATASET_CONFIG" ]; then
        # tiny random model over real datasets
        model_args=(--tiny_random --dataset_config "$DATASET_CONFIG"
                    --seq_len "${SEQ_LEN:-256}")
    else
        model_args=(--tiny_random --synthetic_steps "${SYNTHETIC_STEPS:-3}" --seq_len 64)
    fi
else
    # base checkpoint dir converted via `python -m mmduet_tpu_torch.models.convert`
    model_args=(--checkpoint "${CHECKPOINT:?set CHECKPOINT to the converted llava-OV dir}"
                --dataset_config "${DATASET_CONFIG:-configs/datasets/mmduetit.json}")
fi
if [ -n "$RESUME" ]; then
    model_args+=(--resume_from_checkpoint "$RESUME")
fi

nproc=${NPROC:-1}
mesh_model=${MESH_MODEL:-1}
launch=(python -u -m)
if [ "$nproc" -gt 1 ]; then
    launch=(python -u -m torch.distributed.run --standalone --nproc_per_node "$nproc" -m)
    model_args+=(--mesh_data "${MESH_DATA:-$((nproc / mesh_model))}" --mesh_model "$mesh_model"
                 --param_mode "${PARAM_MODE:-replicate}"
                 --dist_backend "${DIST_BACKEND:-nccl}")
fi

"${launch[@]}" mmduet_tpu_torch.train.loop \
    "${model_args[@]}" \
    --device "${DEVICE:-cuda}" \
    --num_epochs "${EPOCHS:-1}" --per_device_batch_size 1 \
    --grad_accum_steps "${ACCUM:-16}" \
    --save_steps "${SAVE_STEPS:-500}" --save_total_limit "${SAVE_TOTAL_LIMIT:-5}" \
    --learning_rate "${LR:-0.00002}" --lr_schedule cosine --warmup_ratio 0.05 \
    --logging_steps "${LOGGING_STEPS:-10}" \
    --frame_fps 2 --max_num_frames "${MAX_FRAMES:-100}" \
    --lora_r 16 --lora_alpha 32 \
    --output_dir "$output_dir" \
    2>&1 | tee "$output_dir/train.log"
