"""Single-stream streaming-inference CLI of the PyTorch port.

Port of the single-stream path of `python -m mmduet_tpu.eval.inference`:
the same flags (plus ``--device``) and the same JSONL schema, so the
evaluation stack scores the output unchanged::

    {"question_id": ..., "model_response_list": [...],
     "video_duration": ..., "debug_data": [{"time":..,
     "informative_score":.., "relevance_score":..}, ...],
     "latency": {"p50_ms":.., "p90_ms":.., "frames":..}}

Usage:

    python -m mmduet_tpu_torch.eval.inference --checkpoint <dir> \\
        --test_fname data.json --input_dir videos/ --output_fname out.jsonl \\
        --stream_end_prob_threshold 0.5 [--kv_cache_quant int8] [--device cpu]

``--checkpoint`` is a checkpoint directory of the port
(`models.io.save_checkpoint`: ``config.json`` + ``params.pt``, dense or
quantized weights, with its scale-folded adapter if it has one) that also
holds the HF tokenizer's files. ``--tiny_random`` instead builds a tiny
random-weight model with the char tokenizer (2 layers, hidden 512,
head_dim 128; bf16 on a GPU, f32 on the CPU). ``--kv_cache_quant int8``
keeps the KV cache as per-token int8.

``--device`` defaults to ``cuda``; nothing switches to the CPU on its
own. Not ported yet (each raises): ``--batch_streams`` > 1,
``--mesh_model`` / ``--mesh_data`` > 1, ``--is_online_model false``,
``--prewarm`` and ``--profile_dir``; nor is the conversion of HF
safetensors into a checkpoint directory.

`round_floats`, `_argparser`, `_test_args` and `_make_dataset` are the
JAX CLI's host helpers, copied (its `build_argparser` under the name
`_argparser`); the tests pin them equal.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def round_floats(o, n: int = 3):
    if isinstance(o, float):
        return round(o, n)
    if isinstance(o, list):
        return [round_floats(x, n) for x in o]
    if isinstance(o, dict):
        return {k: round_floats(v, n) for k, v in o.items()}
    return o


def _argparser() -> argparse.ArgumentParser:
    from ..config import DEFAULT_SYSTEM_PROMPT

    p = argparse.ArgumentParser(description="MMDuet-TPU streaming inference")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--tiny_random", action="store_true",
                   help="tiny random-weight model (smoke tests)")
    p.add_argument("--test_fname", type=str, required=True)
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_fname", type=str, required=True)
    p.add_argument("--frame_fps", type=float, default=2.0)
    p.add_argument("--frame_resolution", type=int, default=None,
                   help="decode resolution override; default: the "
                        "model config's frame_resolution")
    p.add_argument("--max_num_frames", type=int, default=400)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=None)
    p.add_argument("--system_prompt", type=str, default=DEFAULT_SYSTEM_PROMPT)
    p.add_argument("--grounding_mode", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--stream_end_prob_threshold", type=float, default=None)
    p.add_argument("--stream_end_score_sum_threshold", type=float, default=None)
    p.add_argument("--threshold_z", type=float, default=None)
    p.add_argument("--first_n_frames_no_generate", type=int, default=0)
    p.add_argument("--running_list_length", type=int, default=20)
    p.add_argument("--score_heads", type=str, default="informative_score")
    p.add_argument("--remove_assistant_turns", type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--repetition_penalty", type=float, default=None)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--time_instruction_format", type=str, default=None)
    p.add_argument("--is_online_model", type=lambda s: s.lower() == "true",
                   default=True,
                   help="false = offline whole-video baseline "
                        "(reference test/inference.py:382-423)")
    p.add_argument("--no_prefetch", action="store_true")
    p.add_argument("--batch_streams", type=int, default=1,
                   help=">1 = continuous-batched serving: stream this many "
                        "samples concurrently through BatchedStreamEngine "
                        "(one weight sweep per step serves every stream; "
                        "identical per-sample outputs; per-stream "
                        "clocks, so mixed-fps samples batch together). "
                        "Runtime-LoRA checkpoints serve batched too "
                        "(one adapter across all lanes); composes with "
                        "--mesh_model N (TP x batched serving)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help=">1 = tensor-parallel serving over this many "
                        "chips (Megatron-layout sharding; keeps the full "
                        "model resident on a v5e-8)")
    p.add_argument("--gen_coalesce_rounds", type=int, default=0,
                   help="with --batch_streams: a triggered stream may "
                        "wait this many scheduling rounds (its own "
                        "stream stalled, others streaming on) so "
                        "staggered triggers merge into one batched "
                        "decode — same per-stream outputs, higher "
                        "aggregate throughput under mixed workloads")
    p.add_argument("--mesh_data", type=int, default=1,
                   help=">1 = with --batch_streams B (divisible), shard "
                        "the B serving lanes over this many chips (data-"
                        "parallel serving: each shard owns B/N sessions' "
                        "caches); composes with --mesh_model")
    p.add_argument("--prewarm", action="store_true",
                   help="compile every hot serving shape before the first "
                        "sample (prefill buckets, fused block, decode "
                        "loop) — an un-warmed shape mid-stream stalls "
                        "that sample for a full XLA compile")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a jax.profiler trace of the run (view "
                        "with tensorboard/xprof) — the tracing hook the "
                        "reference lacks (SURVEY.md §5.1)")
    p.add_argument("--kv_cache_quant", type=str, default=None,
                   choices=["int8"],
                   help="int8: per-token-quantized KV cache — halves "
                        "cache HBM (doubling lanes-per-chip at protocol "
                        "scale) and decode cache bandwidth; score drift "
                        "bound pinned by tests/test_kv_quant.py")
    return p


def _test_args(args, cfg):
    from ..config import TestArgs

    return TestArgs(
        system_prompt=args.system_prompt,
        frame_fps=args.frame_fps,
        frame_resolution=args.frame_resolution or cfg.frame_resolution,
        max_num_frames=args.max_num_frames,
        grounding_mode=args.grounding_mode,
        stream_end_prob_threshold=args.stream_end_prob_threshold,
        stream_end_score_sum_threshold=args.stream_end_score_sum_threshold,
        threshold_z=args.threshold_z,
        first_n_frames_no_generate=args.first_n_frames_no_generate,
        running_list_length=args.running_list_length,
        score_heads=args.score_heads,
        remove_assistant_turns=args.remove_assistant_turns,
        repetition_penalty=args.repetition_penalty,
        max_new_tokens=args.max_new_tokens,
    )


def _make_dataset(args, resolution: int):
    from ..data.eval_dataset import StreamingEvalDataset

    return StreamingEvalDataset(
        data_file=args.test_fname,
        video_base_folder=args.input_dir,
        start_idx=args.start_idx,
        end_idx=args.end_idx,
        output_fps=args.frame_fps,
        # decode at the MODEL's frame resolution unless explicitly
        # overridden with --frame_resolution
        output_resolution=args.frame_resolution or resolution,
        max_num_frames=args.max_num_frames,
        system_prompt=args.system_prompt,
        time_instruction_format=args.time_instruction_format,
    )


def build_argparser() -> argparse.ArgumentParser:
    p = _argparser()
    p.description = "MMDuet streaming inference (PyTorch port)"
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda)")
    return p


def _not_ported(args) -> None:
    unported = {
        "--batch_streams > 1": args.batch_streams > 1,
        "--mesh_model > 1": args.mesh_model > 1,
        "--mesh_data > 1": args.mesh_data > 1,
        "--is_online_model false": not args.is_online_model,
        "--prewarm": args.prewarm,
        "--profile_dir": args.profile_dir is not None,
    }
    for flag, given in unported.items():
        if given:
            raise SystemExit(f"{flag} is not yet ported to mmduet_tpu_torch")


def _load_model(args):
    """(cfg, params, lora, tokenizer) from --tiny_random / --checkpoint."""
    from ..config import tiny_config
    from ..models import init_mmduet_params
    from ..models.io import load_checkpoint
    from ..stream import CharTokenizer, HFTokenizerAdapter

    device = torch.device(args.device)
    lora = None
    if args.tiny_random:
        # head_dim 128 in bf16 on a GPU: the width and dtype the CUDA
        # attention kernel takes; f32 elsewhere
        cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_mmduet_params(cfg, gen, device, dtype)
        tokenizer = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    elif args.checkpoint:
        cfg, params, lora = load_checkpoint(args.checkpoint, device)
        tokenizer = HFTokenizerAdapter.from_pretrained(
            args.checkpoint, frame_num_tokens=cfg.frame_num_tokens,
            v_placeholder=cfg.v_placeholder,
        )
        # the tokenizer owns the special-token ids: the checkpoint's
        # placeholder id is a vocab-size guess, overridden by the actual
        # `<image>` / eos ids the tokenizer produces
        cfg = cfg.replace(
            v_placeholder_id=tokenizer.v_placeholder_id,
            eos_token_id=tokenizer.eos_token_id,
        )
    else:
        raise SystemExit("one of --checkpoint or --tiny_random is required")
    return cfg, params, lora, tokenizer


def build_engine(args):
    from ..infer import LiveInferEngine

    cfg, params, lora, tokenizer = _load_model(args)
    return LiveInferEngine(
        params, cfg, tokenizer, _test_args(args, cfg), lora=lora,
        # saved adapters are scale-folded (`lora.fold_lora_scale`), so the
        # runtime scale is exactly 1.0
        lora_scale=1.0 if lora is not None else 0.0,
        kv_cache_quant=args.kv_cache_quant,
    )


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    _not_ported(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = build_engine(args)
    dataset = _make_dataset(args, engine.cfg.frame_resolution)

    n_done = 0
    t_start = time.perf_counter()
    samples = dataset if args.no_prefetch else dataset.prefetch()
    with open(args.output_fname, "w") as f_out:
        for i, sample in enumerate(samples):
            if sample.frames is None:
                print(f"skipping {sample.question_id}: {sample.error}", file=sys.stderr)
                continue
            engine.reset()
            engine.set_fps(fps=sample.fps)
            engine.input_video_stream(sample.frames)
            engine.input_query_stream(sample.conversation)
            responses = engine.inference()
            lat = np.array(engine.frame_latencies_ms or [0.0])
            res = {
                "question_id": sample.question_id,
                "model_response_list": responses,
                "video_duration": sample.video_duration,
                "debug_data": round_floats(engine.debug_data_list, 3),
                "latency": {
                    "p50_ms": round(float(np.percentile(lat, 50)), 2),
                    "p90_ms": round(float(np.percentile(lat, 90)), 2),
                    "frames": len(engine.frame_latencies_ms),
                },
            }
            f_out.write(json.dumps(res) + "\n")
            n_done += 1
            if i % 5 == 0:
                f_out.flush()
    dt = time.perf_counter() - t_start
    print(f"done: {n_done} samples in {dt:.1f}s -> {args.output_fname}")


if __name__ == "__main__":
    main()
