#!/usr/bin/env bash
# The PyTorch port's counterpart of `scripts/eval_youcook2.sh`, with its knobs
# flag for flag.
#
# YouCook2 dense video captioning protocol — exact knobs of the reference
# `scripts/inference/youcook2.sh:9-16`: fps 0.5, <=200 frames,
# sum-threshold 2, remove assistant turns, informative head only.
#
# Smoke mode (random tiny model + synthetic fixtures):
#   TINY_RANDOM=1 INPUT_DIR=/tmp/fixt/videos TEST_FNAME=/tmp/fixt/val.json DEVICE=cpu bash scripts/eval_youcook2_torch.sh
#
# The port adds DEVICE (cuda; cuda:N or cpu) and NPROC (1): above 1 the
# inference CLI runs under `python -m torch.distributed.run` with MESH_MODEL
# (NPROC / MESH_DATA), MESH_DATA (1) and DIST_BACKEND (nccl; gloo for CPU
# ranks or ranks sharing one card). The eval recipes decode mp4s with cv2.
set -eo pipefail

output_dir=${OUTPUT_DIR:-outputs/mmduet}
mkdir -p "${output_dir}/eval"

thres_sum=2
input_dir=${INPUT_DIR:-datasets/youcook2/videos}
test_fname=${TEST_FNAME:-datasets/youcook2/annotations/val-random_prompt.json}
pred=${output_dir}/eval/youcook2_val-thres_sum_${thres_sum}-rm_ass_turns-pred.json

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

"${launch[@]}" mmduet_tpu_torch.eval.inference \
    "${model_args[@]}" --device "${DEVICE:-cuda}" \
    --input_dir "$input_dir" --frame_fps 0.5 --max_num_frames 200 \
    --test_fname "$test_fname" \
    --stream_end_score_sum_threshold ${thres_sum} --remove_assistant_turns true \
    --output_fname "$pred" \
    2>&1 | tee "${pred%.json}.log"

python -m mmduet_tpu_torch.eval.evaluate --func dense_captioning \
    --pred_file "$pred" \
    --gold_file "$test_fname" \
    2>&1 | tee "${pred%-pred.json}-eval.log"
