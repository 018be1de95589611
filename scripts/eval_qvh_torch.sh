#!/usr/bin/env bash
# The PyTorch port's counterpart of `scripts/eval_qvh.sh`, with its knobs
# flag for flag.
#
# QVHighlights highlight detection protocol — exact knobs of the
# reference `scripts/inference/qvh.sh:8-15`: grounding_mode, fps 1,
# <=400 frames; relevance score -> 2-sec clip saliency, smooth sweep.
#
# Smoke mode:
#   TINY_RANDOM=1 INPUT_DIR=... TEST_FNAME=... GOLD_FILE=... DEVICE=cpu bash scripts/eval_qvh_torch.sh
#
# The port adds DEVICE (cuda; cuda:N or cpu) and NPROC (1): above 1 the
# inference CLI runs under `python -m torch.distributed.run` with MESH_MODEL
# (NPROC / MESH_DATA), MESH_DATA (1) and DIST_BACKEND (nccl; gloo for CPU
# ranks or ranks sharing one card). The eval recipes decode mp4s with cv2.
set -eo pipefail

output_dir=${OUTPUT_DIR:-outputs/mmduet}
mkdir -p "${output_dir}/eval"

input_dir=${INPUT_DIR:-datasets/qvh/videos}
test_fname=${TEST_FNAME:-datasets/qvh/annotations/highlight_val-random_prompt.json}
gold_file=${GOLD_FILE:-datasets/qvh/annotations/highlight_val_release.jsonl}
pred=${output_dir}/eval/qvh_val-random_prompt-pred.json

if [ -n "$TINY_RANDOM" ]; then model_args=(--tiny_random --frame_resolution 32);
else model_args=(--checkpoint "${CHECKPOINT:?set CHECKPOINT or TINY_RANDOM=1}"); fi
# BATCH_STREAMS=N serves N samples concurrently (continuous batching);
# per-sample outputs are identical to the sequential driver
if [ -n "$BATCH_STREAMS" ]; then model_args+=(--batch_streams "$BATCH_STREAMS"); fi
# PREWARM=1 compiles every hot serving shape before the first sample
if [ -n "$PREWARM" ]; then model_args+=(--prewarm); fi

nproc=${NPROC:-1}
launch=(python -u -m)
if [ "$nproc" -gt 1 ]; then
    # one process per rank: tensor parallelism over MESH_MODEL ranks, lanes
    # (BATCH_STREAMS) over MESH_DATA ranks
    mesh_data=${MESH_DATA:-1}
    launch=(python -u -m torch.distributed.run --standalone --nproc_per_node "$nproc" -m)
    model_args+=(--mesh_data "$mesh_data" --mesh_model "${MESH_MODEL:-$((nproc / mesh_data))}"
                 --dist_backend "${DIST_BACKEND:-nccl}")
fi

"${launch[@]}" mmduet_tpu_torch.eval.inference --grounding_mode true \
    "${model_args[@]}" --device "${DEVICE:-cuda}" \
    --stream_end_prob_threshold 1 \
    --input_dir "$input_dir" --frame_fps 1 --max_num_frames 400 \
    --test_fname "$test_fname" \
    --output_fname "$pred" \
    2>&1 | tee "${pred%.json}.log"

python -u -m mmduet_tpu_torch.eval.evaluate --func qvh_highlight \
    --pred_file "$pred" \
    --gold_file "$gold_file" \
    --output_file "${output_dir}/eval/qvh_val-random_prompt-eval.json" \
    2>&1 | tee "${output_dir}/eval/qvh_val-random_prompt-eval.log"
