#!/usr/bin/env bash
# The PyTorch port's counterpart of `scripts/eval_magqa.sh`, with its knobs
# flag for flag.
#
# Shot2Story MAGQA protocol — exact knobs of the reference
# `scripts/inference/magqa.sh:9-17`: fps 2, <=400 frames, prob-threshold
# 0.5, heads informative+relevance, remove assistant turns. The judge
# stage (LLaMA-3.1-70B or GPT-4o batch) is optional and gated on model /
# API availability, as in the reference.
#
# Smoke mode:
#   TINY_RANDOM=1 INPUT_DIR=... TEST_FNAME=... DEVICE=cpu bash scripts/eval_magqa_torch.sh
#
# The port adds DEVICE (cuda; cuda:N or cpu) and NPROC (1): above 1 the
# inference CLI runs under `python -m torch.distributed.run` with MESH_MODEL
# (NPROC / MESH_DATA), MESH_DATA (1) and DIST_BACKEND (nccl; gloo for CPU
# ranks or ranks sharing one card). The eval recipes decode mp4s with cv2.
set -eo pipefail

output_dir=${OUTPUT_DIR:-outputs/mmduet}
mkdir -p "${output_dir}/eval" "${output_dir}/eval/openai"

thres=0.5
input_dir=${INPUT_DIR:-datasets/shot2story/videos}
test_fname=${TEST_FNAME:-datasets/shot2story/annotations/magqa_test.json}
pred=${output_dir}/eval/magqa_test-thres_${thres}-rm_ass_turn-pred.json

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
    --input_dir "$input_dir" --frame_fps 2 --max_num_frames 400 \
    --test_fname "$test_fname" \
    --stream_end_prob_threshold ${thres} --score_heads "informative_score,relevance_score" \
    --remove_assistant_turns true \
    --output_fname "$pred" \
    2>&1 | tee "${pred%.json}.log"

# ---- judge stage (pick ONE backend) ----------------------------------
eval_out=${output_dir}/eval/magqa_test-thres_${thres}-rm_ass_turn-llama_score-eval.json

if [ -n "$JUDGE_LLM" ]; then
    # 1. local 6-shot LLM judge (reference uses Meta-Llama-3.1-70B-Instruct)
    python -u -m mmduet_tpu_torch.eval.evaluate --func magqa \
        --llm_pretrained "$JUDGE_LLM" \
        --gold_file "$test_fname" \
        --pred_file "$pred" \
        --output_file "$eval_out"
    # 2. final in-span score
    python -m mmduet_tpu_torch.eval.evaluate --func magqa_analyze --pred_file "$eval_out"
elif [ -n "$OPENAI_API_KEY" ]; then
    # GPT-4o Batch-API flow (build input -> send -> poll -> join):
    batch_in=${output_dir}/eval/openai/magqa-batch_input.jsonl
    python -m mmduet_tpu_torch.eval.evaluate --func magqa_batch_input \
        --pred_file "$pred" --gold_file "$test_fname" --output_file "$batch_in"
    echo "submit $batch_in via the OpenAI Batch API, then run:"
    echo "  python -m mmduet_tpu_torch.eval.evaluate --func magqa_batch_output \\"
    echo "     --pred_file $pred --gold_file $test_fname \\"
    echo "     --openai_file <batch_output.jsonl> --output_file $eval_out"
else
    echo "no JUDGE_LLM / OPENAI_API_KEY set; skipping the judge stage"
    echo "(predictions written to $pred)"
fi
