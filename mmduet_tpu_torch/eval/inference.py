"""Streaming-inference CLI of the PyTorch port, single-stream and batched.

Port of the online paths of `python -m mmduet_tpu.eval.inference`: the
same flags (plus ``--device``) and the same JSONL schema, so the
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
keeps the KV cache as per-token int8. ``--batch_streams B`` (> 1) streams
B samples at a time through `BatchedStreamEngine.serve()` (continuous
admission; ``--gen_coalesce_rounds`` merges staggered answers into one
batched decode): the same rows per sample, written as samples finish, the
``latency`` block holding the run's aggregate per-frame time.

``--prewarm`` pays the first calls' costs (the kernels' builds, their
scratch, cuBLAS's handles) before the first sample, single-stream and
batched. ``--profile_dir DIR`` runs under `torch.profiler` and writes its
Chrome trace, ``DIR/trace.json``: the program's ``mmduet.*`` spans
(`mmduet_tpu_torch.trace`: rounds, admissions and the tower, dispatches,
forwards, decodes and their steps and flag reads) and, with ``--device
cuda``, the card's kernels and copies on the same clock; it opens in
Perfetto or ``chrome://tracing``. ``--is_online_model false`` runs the offline whole-video baseline
(`eval.offline_baseline`), one row per sample with the JAX CLI's schema
``{question_id, model_response, question, video_duration}``. An HF
checkpoint becomes a ``--checkpoint`` directory through
`python -m mmduet_tpu_torch.models.convert`.

``--mesh_model M`` serves tensor-parallel and ``--mesh_data D`` (with
``--batch_streams B``, which D divides) cuts the B lanes over D ranks,
one process per rank on a (D, M) mesh, each holding its shard
(`parallel.shard_params`) on its own device::

    python -m torch.distributed.run --nproc_per_node D*M \
        -m mmduet_tpu_torch.eval.inference --mesh_model M \
        [--mesh_data D --batch_streams B] ... \
        [--dist_backend nccl|gloo] [--device cuda|cuda:0|cpu]

The single-stream, ``--batch_streams`` and ``--is_online_model false``
routes all take ``--mesh_model``, and their rows equal one process's;
``--mesh_data`` > 1 needs ``--batch_streams`` > 1, as in the JAX CLI (the
offline baseline, reached with both, runs whole on each data replica).
``--dist_backend`` (default ``nccl``) is the backend named to
`torch.distributed`: ``nccl`` where each rank has its own card
(``--device cuda`` is then ``cuda:LOCAL_RANK``), ``gloo`` on the CPU and
for ranks that share one card (``--device cuda:0``; NCCL refuses two ranks
on one device). Rank 0 alone writes the output file.

``--device`` defaults to ``cuda``; nothing switches to the CPU on its
own.

Each sample is decoded once on a mesh: sample ``k`` by rank ``k mod (D*M)``
alone (row-major over (data, model)), in a thread of the CLI's own that
runs two samples ahead over that rank's indices (inline with
``--no_prefetch``); the decoded sample crosses to every rank bit for bit
(`mesh_samples`: over ``data``, then over ``model``), a failed decode as
failed, so every rank skips it together. Each rank prints to stderr, at
the end, how many samples it decoded and the bytes it sent and received.
One process reads the dataset as the JAX CLI does (``prefetch()``).

`round_floats`, `_argparser`, `_test_args` and `_make_dataset` are the
JAX CLI's host helpers, copied (its `build_argparser` under the name
`_argparser`); the tests pin them equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

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


def _ahead(fetch: Callable[[int], Any], indices, depth: int) -> Iterator[Any]:
    """``fetch(k)`` of each index in order, ``depth`` ahead on a thread of
    its own (inline with depth 0); an index whose fetch raised yields the
    exception."""
    def call(k):
        try:
            return fetch(k)
        except Exception as e:  # handed to the share, which raises on every rank
            return e

    if depth <= 0:
        yield from map(call, indices)
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    threading.Thread(target=lambda: [q.put(call(k)) for k in indices], daemon=True).start()
    for _ in indices:
        yield q.get()


def mesh_items(n: int, fetch: Callable[[int], Dict[str, Any]], mesh, depth: int = 2,
               stats: Optional[Dict[str, int]] = None) -> Iterator[Dict[str, Any]]:
    """Items ``0 .. n - 1`` in order on every rank of the process ``mesh``,
    each fetched once on the mesh: item ``k`` by rank ``k mod (D * M)`` in
    row-major (data, model) order, ``fetch(k)`` on a thread that runs
    ``depth`` items ahead over that rank's own indices (inline with 0). An
    item is a dict of host arrays and JSON values (`collectives.share`); it
    crosses over ``data`` to the owner's model column, then over ``model``
    to every rank, bit for bit. A fetch that raises raises on every rank.
    ``stats`` counts this rank's fetches ("fetched") and bytes ("sent",
    "received")."""
    from ..parallel.collectives import share

    data_n, model_n = mesh.dims
    d, m = mesh.coords
    own = range(d * model_n + m, n, data_n * model_n)
    fetched = _ahead(fetch, own, depth)
    if stats is not None:
        for k in ("fetched", "sent", "received"):
            stats.setdefault(k, 0)
    for k in range(n):
        od, om = divmod(k % (data_n * model_n), model_n)
        item = None
        if (od, om) == (d, m):
            item = next(fetched)
            if stats is not None:
                stats["fetched"] += 1
        if om == m:
            try:
                item = share("data", od, item, mesh.device, stats)
            except Exception as e:  # passed on over model, so that no rank waits
                item = e
        yield share("model", om, item, mesh.device, stats)


def mesh_samples(dataset, mesh, depth: int = 2,
                 stats: Optional[Dict[str, int]] = None) -> Iterator[Any]:
    """The dataset's `EvalSample`s in order on every rank of ``mesh``, each
    decoded by one rank (`mesh_items`): its frames cross as uint8, the
    other fields (the owner's conversation, which a time-instruction
    format writes the frame count into; its fps, duration and error) as
    JSON. A failed decode (``frames`` None) arrives as failed."""
    from ..data.eval_dataset import EvalSample

    def fetch(k):
        sample = dataset[k]
        return {f.name: getattr(sample, f.name) for f in dataclasses.fields(sample)}

    for item in mesh_items(len(dataset), fetch, mesh, depth, stats):
        yield EvalSample(**item)


def _samples(args, dataset, mesh) -> Iterator[Any]:
    """The CLI's samples: with one process, the dataset as read
    (``prefetch()`` unless ``--no_prefetch``); on a process mesh, each
    decoded once (`mesh_samples`), and this rank's count and bytes printed
    to stderr at the end."""
    if mesh is None:
        yield from (dataset if args.no_prefetch else dataset.prefetch())
        return
    stats: Dict[str, int] = {}
    yield from mesh_samples(dataset, mesh, 0 if args.no_prefetch else 2, stats)
    print(f"samples, rank {mesh.coords}: decoded {stats['fetched']} of {len(dataset)}; "
          f"sent {stats['sent']} bytes, received {stats['received']} bytes",
          file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    p = _argparser()
    p.description = "MMDuet streaming inference (PyTorch port)"
    # the copied parser's text names the JAX package's profiler
    p._option_string_actions["--profile_dir"].help = (
        "write a torch.profiler Chrome trace of the run to DIR/trace.json: the "
        "program's mmduet.* spans and, on a card, its kernels and copies (open it "
        "in Perfetto or chrome://tracing)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; on a mesh, "
                        "cuda:LOCAL_RANK)")
    p.add_argument("--dist_backend", type=str, default="nccl", choices=("nccl", "gloo"),
                   help="with --mesh_model / --mesh_data: the torch.distributed backend "
                        "(nccl: a card per rank; gloo: CPU ranks, or ranks sharing one card)")
    return p


def _make_mesh(args):
    """This rank's (--mesh_data, --mesh_model) process mesh, or None for
    one process."""
    n = args.mesh_data * args.mesh_model
    if n <= 1:
        return None
    from ..parallel import initialize_distributed, make_mesh

    if "RANK" not in os.environ:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} x --mesh_model {args.mesh_model} runs one process "
            f"per rank: start it with python -m torch.distributed.run --nproc_per_node {n} "
            "-m mmduet_tpu_torch.eval.inference ...")
    initialize_distributed(args.dist_backend)
    device = torch.device(args.device)
    # a bare "cuda" is each rank's own card; "cuda:i" or "cpu" is named
    return make_mesh((args.mesh_data, args.mesh_model),
                     device=None if device == torch.device("cuda") else device)


def _load_model(args, mesh=None):
    """(cfg, params, lora, tokenizer) from --tiny_random / --checkpoint;
    under ``mesh``, the parameters are this rank's local tree."""
    from ..config import tiny_config
    from ..models import init_mmduet_params
    from ..models.io import load_checkpoint
    from ..parallel import shard_params
    from ..stream import CharTokenizer, HFTokenizerAdapter

    device = torch.device(args.device) if mesh is None else mesh.device
    lora = None
    if args.tiny_random:
        # head_dim 128 in bf16 on a GPU: the width and dtype the CUDA
        # attention kernel takes; f32 elsewhere
        cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_mmduet_params(cfg, gen, device, dtype)
        if mesh is not None:
            params = shard_params(params, mesh)
        tokenizer = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    elif args.checkpoint:
        cfg, params, lora = load_checkpoint(args.checkpoint, device, mesh=mesh)
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
    """The single-stream engine of the CLI's arguments (on this rank's
    process mesh with ``--mesh_model``)."""
    from ..infer import LiveInferEngine

    mesh = _make_mesh(args)
    cfg, params, lora, tokenizer = _load_model(args, mesh)
    return LiveInferEngine(
        params, cfg, tokenizer, _test_args(args, cfg), lora=lora,
        # saved adapters are scale-folded (`lora.fold_lora_scale`), so the
        # runtime scale is exactly 1.0
        lora_scale=1.0 if lora is not None else 0.0,
        kv_cache_quant=args.kv_cache_quant, mesh=mesh,
    )


def _output(args, mesh):
    """The output file, opened for writing on rank 0 (or one process);
    the other ranks of a mesh write to os.devnull."""
    if mesh is not None and mesh.coords != (0, 0):
        return open(os.devnull, "w")
    return open(args.output_fname, "w")


def _prewarm(args, engine) -> None:
    if args.prewarm:
        t0 = time.perf_counter()
        # grounding never generates: skip warming the decode loop
        engine.prewarm(vision=True, generate=not args.grounding_mode)
        print(f"prewarm: {time.perf_counter() - t0:.1f}s", file=sys.stderr)


def _run_batched(args) -> None:
    """Continuous-batched serving: stream the samples through
    `BatchedStreamEngine.serve()`, ``--batch_streams`` at a time — per-sample
    JSONL lines equal to the sequential path's, with the ``latency`` block
    reporting the aggregate per-frame wall time (individual frame
    latencies are not observable when B streams share one dispatch)."""
    from ..infer import BatchedStreamEngine

    if args.mesh_data > 1 and args.batch_streams % args.mesh_data != 0:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} must divide --batch_streams "
            f"{args.batch_streams} (lanes shard over the data axis)"
        )
    mesh = _make_mesh(args)
    cfg, params, lora, tokenizer = _load_model(args, mesh)
    B = args.batch_streams
    engine = BatchedStreamEngine(
        params, cfg, tokenizer, _test_args(args, cfg), n_streams=B, mesh=mesh,
        gen_coalesce_rounds=args.gen_coalesce_rounds,
        kv_cache_quant=args.kv_cache_quant,
        lora=lora, lora_scale=1.0 if lora is not None else 0.0,
        # same block policy as the single engine: grounding never
        # generates, so a trigger never rolls frames back and a big
        # fused block is a pure win
        block_frames=32 if args.grounding_mode else 8,
    )
    _prewarm(args, engine)
    dataset = _make_dataset(args, cfg.frame_resolution)

    n_done = 0
    t_start = time.perf_counter()
    samples = _samples(args, dataset, mesh)

    # sessions are admitted into lanes the moment one frees up: a short
    # video does not hold its lane idle while long ones drain, and at
    # most B decoded videos are resident (serve() pulls lazily)
    meta: dict = {}

    def session_iter():
        for sample in samples:
            if sample.frames is None:
                print(f"skipping {sample.question_id}: {sample.error}",
                      file=sys.stderr)
                continue
            meta[len(meta)] = (
                sample.question_id, sample.video_duration, len(sample.frames)
            )
            yield {
                "frames": sample.frames,
                "conversation": sample.conversation,
                "fps": sample.fps,
            }

    t0 = time.perf_counter()
    n_frames_total = 0
    # write + flush each session's line the moment it retires (completion
    # order; consumers key on question_id). Each line reports the
    # run-aggregate per-frame wall over all frames served SO FAR (the
    # final line's value is the whole-run aggregate).
    with _output(args, mesh) as f_out:
        for idx, responses, debug in engine.serve(session_iter()):
            n_frames_total += len(debug)
            dt_ms = (time.perf_counter() - t0) * 1000
            per_frame = round(dt_ms / max(n_frames_total, 1), 2)
            qid, duration, _ = meta[idx]
            res = {
                "question_id": qid,
                "model_response_list": responses,
                "video_duration": duration,
                "debug_data": round_floats(debug, 3),
                "latency": {
                    "p50_ms": per_frame,
                    "p90_ms": per_frame,
                    "frames": len(debug),
                    "aggregate": True,
                },
            }
            f_out.write(json.dumps(res) + "\n")
            f_out.flush()
            n_done += 1
    dt = time.perf_counter() - t_start
    print(f"done (batched x{B}, continuous admission): {n_done} samples "
          f"in {dt:.1f}s -> {args.output_fname}")


def _run_offline_baseline(args) -> None:
    """Whole-video non-streaming baseline (reference
    `test/inference.py:382-423`): one greedy answer per sample; output
    schema {question_id, model_response, question, video_duration}."""
    from ..config import TestArgs
    from .offline_baseline import OfflineBaselineRunner

    mesh = _make_mesh(args)
    cfg, params, lora, tokenizer = _load_model(args, mesh)
    test_args = TestArgs(
        frame_fps=args.frame_fps,
        frame_resolution=args.frame_resolution or cfg.frame_resolution,
        max_num_frames=args.max_num_frames,
        repetition_penalty=args.repetition_penalty,
        max_new_tokens=args.max_new_tokens,
        stream_end_prob_threshold=1.0,
    )
    runner = OfflineBaselineRunner(
        params, cfg, tokenizer, test_args, lora=lora,
        lora_scale=1.0 if lora is not None else 0.0, mesh=mesh,
    )
    dataset = _make_dataset(args, cfg.frame_resolution)

    n_done = 0
    t_start = time.perf_counter()
    samples = _samples(args, dataset, mesh)
    with _output(args, mesh) as f_out:
        for i, sample in enumerate(samples):
            if sample.frames is None:
                print(f"skipping {sample.question_id}: {sample.error}", file=sys.stderr)
                continue
            runner.set_fps(fps=sample.fps)
            question = next(
                (t["content"] for t in sample.conversation if t["role"] == "user"), None)
            if question is None:
                print(f"skipping {sample.question_id}: no user turn", file=sys.stderr)
                continue
            text = runner.answer(sample.frames, question)
            res = {
                "question_id": sample.question_id,
                "model_response": [text],
                "question": question,
                "video_duration": sample.video_duration,
            }
            f_out.write(json.dumps(res) + "\n")
            n_done += 1
            if i % 10 == 0:
                f_out.flush()
    dt = time.perf_counter() - t_start
    print(f"baseline done: {n_done} samples in {dt:.1f}s -> {args.output_fname}")


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not args.profile_dir:
        return _main_inner(args)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _main_inner(args)
    os.makedirs(args.profile_dir, exist_ok=True)
    path = os.path.join(args.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", file=sys.stderr)


def _main_inner(args) -> None:
    from ..parallel.mesh import leave_group

    _run(args)
    leave_group()  # after a failure the process exits and its launcher ends the others


def _run(args) -> None:
    if args.mesh_data > 1 and args.batch_streams <= 1:
        # Data-parallel lane sharding only exists in batched serving;
        # silently ignoring the flag would let a user believe they
        # benchmarked a DP config they never ran.
        raise SystemExit(
            f"--mesh_data {args.mesh_data} requires --batch_streams > 1 "
            "(lanes shard over the data axis); single-stream and offline "
            "baseline runs take --mesh_model only"
        )
    if not args.is_online_model:
        return _run_offline_baseline(args)
    if args.batch_streams > 1:
        return _run_batched(args)
    engine = build_engine(args)
    _prewarm(args, engine)
    dataset = _make_dataset(args, engine.cfg.frame_resolution)

    n_done = 0
    t_start = time.perf_counter()
    samples = _samples(args, dataset, engine.mesh)
    with _output(args, engine.mesh) as f_out:
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
