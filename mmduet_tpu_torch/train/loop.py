"""Training CLI: LoRA fine-tuning of MMDuet on one device or on a process
mesh.

Port of `mmduet_tpu/train/loop.py` (same flags, plus ``--device`` and
``--dist_backend``):

    python -m mmduet_tpu_torch.train.loop --dataset_config configs/datasets/x.json \
        --checkpoint <base-ckpt-dir> --output_dir outputs/run1 ...

Smoke mode (no checkpoint / no videos; a tiny random-weight model with the
char tokenizer: 2 layers, hidden 512, head_dim 128; bf16 on a GPU, f32 on
the CPU):
    python -m mmduet_tpu_torch.train.loop --tiny_random --synthetic_steps 5 [--device cpu]

Per optimizer step the loop collates ``grad_accum_steps`` micro-batches
into one (A, B, T) array set, moves it (on a mesh, the rank's share) to
the device and calls the train step. Metrics stream to stdout and
``<output>/log.jsonl`` under the JAX CLI's keys. On a GPU the decoder's
attention is kernel C, which takes bf16 only, so ``--bf16 false`` runs on
the CPU alone. A batch whose step
raises is skipped, as in JAX, except when a kernel refused its operands or
failed to launch (`ops.attention.KernelError`): that ends the run.

A (data, model) mesh runs one process per rank, started as the reference
starts its training:

    python -m torch.distributed.run --nproc_per_node N -m mmduet_tpu_torch.train.loop \
        --mesh_data D --mesh_model M [--param_mode replicate|fsdp] \
        [--dist_backend nccl|gloo] [--device cuda|cuda:0|cpu] ...

``D`` defaults to N / M, and D x M must be N. ``--param_mode replicate``
is ZeRO-2 (optimizer state cut over ``data``), ``fsdp`` also cuts the
frozen base over ``data`` (gathered where it is used); ``M`` > 1 is tensor
parallelism. The global batch is ``--per_device_batch_size`` x D, and a
rank stages only its share on its device: its samples' rows and their
frames, as JAX's `batch_shardings` places a batch. On a dataset a rank
reads, decodes and collates only its own samples (`rank_real_batches`,
the ranks agreeing on the padded shapes through one sum over ``data`` a
micro-batch); a synthetic batch is made whole and cut
(`train.step.rank_batch`). ``nccl`` needs a card a
rank (``--device cuda`` is ``cuda:LOCAL_RANK``); ``gloo`` runs CPU ranks
(``--device cpu``) or ranks sharing one card (``--device cuda:0``).
Rank 0 alone prints, writes ``log.jsonl``, the checkpoints (the whole
state, `train.checkpoint`) and ``final/`` (the base gathered leaf by leaf
to the host). A step that raises on a mesh ends the run: a rank that
skipped a batch alone would leave the others' collectives waiting.

``parse_length_buckets``, ``synthetic_batches``, ``real_batches``,
``_prefetch_map`` and ``_accumulate`` are copies of the JAX module's host
code (its package imports jax), pinned equal by the tests;
``rank_real_batches`` is the port's own (the JAX loop is one process a
host, which collates once and places the shares), held bit for bit
against ``rank_batch(real_batches(...))``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import time
from typing import Iterator, Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MMDuet training on one GPU (PyTorch port)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="base model checkpoint dir (config.json + params)")
    p.add_argument("--tiny_random", action="store_true")
    p.add_argument("--dataset_config", type=str, default=None)
    p.add_argument("--synthetic_steps", type=int, default=0,
                   help="train on synthetic random batches (smoke mode)")
    p.add_argument("--output_dir", type=str, default="outputs/debug")
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--lr_schedule", type=str, default="cosine")
    p.add_argument("--warmup_ratio", type=float, default=0.05)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--per_device_batch_size", type=int, default=1)
    p.add_argument("--grad_accum_steps", type=int, default=16)
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32)
    p.add_argument("--frame_fps", type=float, default=2.0)
    p.add_argument("--max_num_frames", type=int, default=100)
    p.add_argument("--seq_len", type=int, default=None,
                   help="fixed padded seq len (default: derived)")
    p.add_argument("--length_buckets", type=str, default="auto",
                   help="static pad-length table: 'auto' (seq_len/4, "
                        "seq_len/2, seq_len — rounded to 128), 'none' "
                        "(always pad to seq_len, the r4 behavior), or a "
                        "comma list like '1536,2560,5924'. Micro-batches "
                        "pad to the smallest bucket that fits; one XLA "
                        "compile per bucket")
    p.add_argument("--frame_buckets", type=str, default="auto",
                   help="same for the FRAME axis ('auto' = quarter/half/"
                        "full of max frames): in pixel mode the tower "
                        "encodes every padded slot, so frame bucketing "
                        "cuts vision compute on short-video samples")
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--save_total_limit", type=int, default=5)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--param_mode", choices=["replicate", "fsdp"],
                   default="replicate",
                   help="base-param sharding over the data axis: "
                        "'replicate' = ZeRO-2 (opt state sharded, params "
                        "replicated — the reference's DeepSpeed mode), "
                        "'fsdp' = ZeRO-3 equivalent (params also sharded, "
                        "reference configs/deepspeed/zero3.json)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--bf16", type=lambda s: s.lower() == "true", default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu; on a mesh, "
                        "cuda is cuda:LOCAL_RANK)")
    p.add_argument("--dist_backend", type=str, default="nccl", choices=("nccl", "gloo"),
                   help="on a mesh: the torch.distributed backend (nccl: a card per rank; "
                        "gloo: CPU ranks, or ranks sharing one card)")
    return p


def parse_length_buckets(spec: str, cap: int, quantum: int = 128) -> Optional[tuple]:
    """--length_buckets / --frame_buckets → collator bucket table. 'auto'
    derives a 3-entry quarter/half/full table (the MMDuetIT mixture spans
    ~1k-token grounding to ~5k-token DVC samples), rounded to ``quantum``."""
    spec = (spec or "none").strip().lower()
    if spec == "none":
        return None
    if spec == "auto":
        rq = lambda x: max(quantum, int(round(x / quantum)) * quantum)  # noqa: E731
        table = sorted({min(rq(cap / 4), cap), min(rq(cap / 2), cap), cap})
        return tuple(table)
    return tuple(int(x) for x in spec.split(","))


def synthetic_batches(cfg, collator_seq_len, max_frames, B, A, steps, seed=0):
    """Random duet-shaped batches for smoke training."""
    r = np.random.RandomState(seed)
    ft = cfg.frame_num_tokens
    vid = cfg.v_placeholder_id
    T = collator_seq_len
    for _ in range(steps):
        ids = r.randint(0, min(200, cfg.text.vocab_size - 2), (A, B, T))
        ids[:, :, 2 : 2 + ft] = vid
        labels = np.full((A, B, T), -100)
        labels[:, :, 10:20] = ids[:, :, 10:20]
        inf = np.full((A, B, T), -100)
        inf[:, :, 2 + ft - 1] = r.randint(0, 2, (A, B))
        yield {
            "input_ids": ids.astype(np.int32),
            "attn_mask": np.ones((A, B, T), bool),
            "labels": labels.astype(np.int32),
            "informative_labels": inf.astype(np.int32),
            "relevance_labels": np.full((A, B, T), -100, np.int32),
            "vision_feats": r.randn(
                A, B, cfg.vision.num_patches, cfg.vision.hidden_size
            ).astype(np.float32),
        }


def real_batches(dataset, collator, B, A, epochs, seed, num_workers: int = 4,
                 skip_batches: int = 0):
    """Shuffled epoch iteration → accumulated batches.

    Samples are fetched by a background thread pool (``num_workers``,
    reference `train.sh:13` dataloader_num_workers) — cv2 decode releases
    the GIL, so the host overlaps video decode with the device step.

    ``skip_batches``: resume fast-forward. The shuffle order and per-item
    RNG are deterministic in (seed, epoch, index), so the first
    ``skip_batches * B * A`` samples are skipped at the INDEX level —
    identical data order to an uninterrupted run without re-decoding a
    single video."""
    from concurrent.futures import ThreadPoolExecutor

    from ..data.collator import stack_accum

    order = list(range(len(dataset)))
    rng = random.Random(seed)
    pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
    to_skip = [skip_batches * B * A]

    def samples():
        # set_epoch must not race with in-flight prefetch: each epoch's
        # _prefetch_map fully drains before the next epoch's set_epoch
        # runs (the generator below only advances after exhaustion)
        for epoch in range(epochs):
            if hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)  # vary per-item RNG across epochs
            rng.shuffle(order)  # always advances, even in skipped epochs
            idxs = list(order)
            if to_skip[0] >= len(idxs):
                to_skip[0] -= len(idxs)
                continue
            if to_skip[0]:
                idxs = idxs[to_skip[0]:]
                to_skip[0] = 0
            if pool is None:
                for i in idxs:
                    yield dataset[i]
            else:
                yield from _prefetch_map(
                    pool, dataset.__getitem__, idxs, depth=2 * num_workers
                )

    try:
        yield from _accumulate(samples(), collator, B, A, stack_accum)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def _prefetch_map(pool, fn, iterable, depth):
    """Like Executor.map but with a BOUNDED lookahead window — plain
    `pool.map` submits the whole epoch up front, which would decode and
    buffer every video in memory."""
    import collections as _collections
    import itertools

    it = iter(iterable)
    pending = _collections.deque(
        pool.submit(fn, x) for x in itertools.islice(it, depth)
    )
    while pending:
        fut = pending.popleft()
        for x in itertools.islice(it, 1):
            pending.append(pool.submit(fn, x))
        yield fut.result()


def _accumulate(samples, collator, B, A, stack_accum):
    """Micro-batch + grad-accum grouping, BUCKET-AWARE: the device scan
    needs all A micro-batches of one optimizer step at one shape, so
    micros are queued per padded length and a step is emitted the moment
    any bucket holds A of them. Micro COMPOSITION is untouched
    (consecutive B samples, same as the fixed path — a bucketless
    collator degenerates to exactly the old single-queue behavior); only
    the optimizer-step interleaving across buckets reorders. Per-bucket
    leftovers at stream end are dropped — the same tail policy as the
    fixed path's final partial group, at most (A-1) micros per bucket."""
    micro, by_shape = [], {}
    for sample in samples:
        micro.append(sample)
        if len(micro) == B:
            mb = collator(micro)
            micro = []
            # an accum group must stack at one shape, so key on the shape
            # of every array leaf — this covers both bucketed axes (seq
            # len via input_ids, frame count via frames/vision_feats)
            # without assuming which leaves a collator emits
            key = tuple(
                (name, v.shape) for name, v in sorted(mb.items())
                if hasattr(v, "shape")
            )
            q = by_shape.setdefault(key, [])
            q.append(mb)
            if len(q) == A:
                yield stack_accum(by_shape.pop(key))


def rank_real_batches(dataset, collator, B, A, epochs, seed, num_workers: int = 4,
                      skip_batches: int = 0, *, mesh=None, stats: Optional[dict] = None):
    """This rank's share of `real_batches`' optimizer steps, each sample
    read, decoded and collated once on the mesh: the same steps, in the
    same order, as ``rank_batch(real_batches(...), cfg, mesh)``, bit for
    bit.

    The ranks share the order (the same shuffle, `set_epoch` and index-level
    resume skip) and cut it into micro-batches of B consecutive positions,
    numbered from 0 after the skip, dropping a partial tail. Model rank
    ``m`` of ``M`` owns micro-batches ``i = m (mod M)``; data rank ``d`` of
    ``D`` takes positions ``[d * B / D, (d + 1) * B / D)`` of each. So rank
    (d, m) fetches, decodes and collates only those positions of its own
    micro-batches, its look-ahead window holding only them, with the
    unchanged ``collator``.

    With D > 1 the owners' column (the data group of model index m) runs
    one sum over ``data`` a micro-batch of a (D, 3) tensor on
    ``mesh.device`` (row d: the rank's length bucket, real tokens, frames),
    which gives what only the whole batch knows: the pad length L (the
    largest bucket), the frame bucket N (of the total frame count), the
    real-token count. The rank pads its rows to L with the collator's
    fills and keeps its own frames, one array a micro-batch (one zero slot
    where it holds none), and micro-batches queue by the global (L, N).
    With D = 1 the owner collates the whole micro-batch and micro-batches
    queue by `_accumulate`'s key, stacked by ``stack_accum``: `real_batches`'
    steps. With M > 1 the owner then sends its share (D = 1: its frames cut
    to the real ones, padded back on arrival) to the other model ranks
    (`collectives.share` over ``model``). Ownership and the end of the
    stream follow from ``len(dataset)``, B, A, the seed and the skip, so
    every rank issues the same collectives in the same order, and every
    rank emits the same steps and drops the same leftovers. A rank that
    fails to read or collate its micro-batch is announced in those sums:
    every rank of the mesh raises, none waits. ``sample_idxs`` holds the
    rank's rows, ``num_frames`` and ``n_real_tokens`` the whole batch's.
    ``stats`` counts the bytes this rank sent and received ("sent",
    "received"). With no mesh or a mesh of one rank: `real_batches`
    itself."""
    from concurrent.futures import ThreadPoolExecutor
    from itertools import islice

    from ..data.collator import stack_accum
    from ..parallel.collectives import share, sum_data
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
    from ..stream.labels import IGNORE_INDEX
    from .step import _FRAME_KEYS

    data_n, model_n = (1, 1) if mesh is None else (mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS])
    if data_n * model_n == 1:
        yield from real_batches(dataset, collator, B, A, epochs, seed, num_workers, skip_batches)
        return
    if B % data_n:
        raise ValueError(f"a micro-batch of {B} samples over a data axis of {data_n}")
    per, d, m = B // data_n, mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)
    tok = collator.tokenizer
    vid, ft = tok.v_placeholder_id, tok.template.frame_num_tokens
    fills = {"input_ids": tok.pad_token_id, "attn_mask": False, "labels": IGNORE_INDEX,
             "informative_labels": IGNORE_INDEX, "relevance_labels": IGNORE_INDEX}
    order = list(range(len(dataset)))
    rng = random.Random(seed)
    pool = ThreadPoolExecutor(num_workers) if num_workers > 0 else None
    micros = max(0, epochs * len(order) - skip_batches * B * A) // B  # whole ones after the skip

    def samples():
        skip, pos = skip_batches * B * A, 0  # pos: of the stream after the skip
        for epoch in range(epochs):
            if hasattr(dataset, "set_epoch"):  # after the last epoch's fetches drained
                dataset.set_epoch(epoch)
            rng.shuffle(order)
            cut = min(skip, len(order))
            skip -= cut
            idxs = [i for p, i in enumerate(order[cut:], pos)
                    if p < micros * B and p // B % model_n == m and p % B // per == d]
            pos += len(order) - cut
            if pool is None:
                yield from map(dataset.__getitem__, idxs)
            else:
                yield from _prefetch_map(pool, dataset.__getitem__, idxs, depth=2 * num_workers)

    def frame_bucket(n_frames):
        return collator.max_frames if collator.frame_buckets is None else next(
            b for b in collator.frame_buckets if b >= n_frames)

    def agree(mb):
        """D > 1: the column's sum of shapes (a failed rank's row says -1),
        then this rank's share padded to the whole micro-batch's L; the
        micro-batch, or the error that every rank of the column sees."""
        row = torch.zeros((data_n, 3), dtype=torch.int64, device=mesh.device)
        row[d] = torch.tensor([-1, 0, 0] if isinstance(mb, BaseException) else
                              [mb["input_ids"].shape[1], int(mb["n_real_tokens"]),
                               int(mb["num_frames"])])
        total = sum_data(row).cpu()
        failed = [j for j in range(data_n) if total[j, 0] < 0]
        if isinstance(mb, BaseException) or failed:
            return mb if isinstance(mb, BaseException) else RuntimeError(
                f"training data: data rank(s) {failed} of model index {m} failed to read "
                "their share of a micro-batch")
        L, n_frames = int(total[:, 0].max()), int(total[:, 2].sum())
        if n_frames > collator.max_frames:
            return ValueError(f"batch has {n_frames} frames > collator max_frames "
                              f"{collator.max_frames}")
        for k, fill in fills.items():
            mb[k] = np.pad(mb[k], ((0, 0), (0, L - mb[k].shape[1])), constant_values=fill)
        fk = next(k for k in _FRAME_KEYS if k in mb)
        n = int(((mb["input_ids"] == vid).sum(-1) // ft).sum())
        # a copy: a view would keep the rank's padded frame bucket alive
        mb[fk] = mb[fk][:n].copy() if n else np.zeros((1, *mb[fk].shape[1:]), mb[fk].dtype)
        mb["num_frames"] = np.asarray(n_frames, np.int32)
        mb["n_real_tokens"] = np.asarray(int(total[:, 1].sum()), np.int64)
        return mb

    def own(it):
        """The micro-batch this rank owns: its share, collated (and agreed
        over ``data``), or the error that stopped it."""
        try:
            part = list(islice(it, per))
            if len(part) != per:
                raise RuntimeError(f"training data: {len(part)} of {per} samples left for a "
                                   "micro-batch")
            mb = collator(part)
        except Exception as e:  # announced to the column and the model ranks
            mb = e
        return agree(mb) if data_n > 1 else mb

    def key(mb):
        if data_n > 1:
            return mb["input_ids"].shape[1], frame_bucket(int(mb["num_frames"]))
        return tuple((name, v.shape) for name, v in sorted(mb.items()) if hasattr(v, "shape"))

    def exchange(i, mb):
        """Micro-batch ``i`` from its owner (model index i mod M) on every
        model rank; D = 1 sends only the real frames."""
        if model_n == 1:
            return mb
        owner = i % model_n
        sent = mb
        if data_n == 1 and owner == m and not isinstance(mb, BaseException):
            fk = next(k for k in _FRAME_KEYS if k in mb)
            sent = dict(mb, **{fk: mb[fk][:int(mb["num_frames"])]})
        got = share("model", owner, sent, mesh.device, stats)
        if owner == m:
            return mb
        if data_n > 1:
            return got
        fk = next(k for k in _FRAME_KEYS if k in got)
        frames = np.zeros((frame_bucket(len(got[fk])), *got[fk].shape[1:]), got[fk].dtype)
        frames[:len(got[fk])] = got[fk]
        return dict(got, **{fk: frames})

    try:
        it, by_shape = samples(), {}
        for i in range(micros):
            mb = exchange(i, own(it) if i % model_n == m else None)
            if isinstance(mb, BaseException):
                raise mb
            shape = key(mb)
            q = by_shape.setdefault(shape, [])
            q.append(mb)
            if len(q) == A:
                group = by_shape.pop(shape)
                if data_n == 1:
                    yield stack_accum(group)
                else:
                    yield {k: tuple(x[k] for x in group) if k in _FRAME_KEYS
                           else np.stack([x[k] for x in group]) for k in group[0]}
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)


def _to_device(batch, device) -> dict:
    """Host arrays onto ``device``; a tuple (a rank's frames, one array a
    micro-batch) becomes a tuple of tensors."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return {k: tuple(map(put, v)) if isinstance(v, tuple) else put(v) for k, v in batch.items()}


def _make_mesh(args):
    """This rank's (data, model) process mesh under torch.distributed.run,
    or None for one process (where --mesh_data / --mesh_model > 1 say how
    to start it)."""
    if "WORLD_SIZE" not in os.environ:
        if (args.mesh_data or 1) > 1 or args.mesh_model > 1:
            n = (args.mesh_data or 1) * args.mesh_model
            raise SystemExit(
                f"--mesh_data {args.mesh_data or 1} --mesh_model {args.mesh_model} runs one "
                f"process per rank: start it with python -m torch.distributed.run "
                f"--nproc_per_node {n} -m mmduet_tpu_torch.train.loop ...")
        return None
    from ..parallel import initialize_distributed, make_mesh

    world = int(os.environ["WORLD_SIZE"])
    data_n = args.mesh_data or world // args.mesh_model
    if data_n * args.mesh_model != world:
        # strict, as make_mesh (the JAX CLI only warns and idles devices)
        raise SystemExit(f"mesh ({data_n} x {args.mesh_model}) != {world} ranks")
    initialize_distributed(args.dist_backend)
    device = torch.device(args.device)
    # a bare "cuda" is each rank's own card; "cuda:i" or "cpu" is named
    return make_mesh((data_n, args.mesh_model),
                     device=None if device == torch.device("cuda") else device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not args.bf16:
        raise SystemExit("--bf16 false: the GPU's training attention (kernel C) takes "
                         "bfloat16 only; f32 base params run with --device cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is false")
    from ..parallel.mesh import leave_group

    mesh = _make_mesh(args)
    _train(args, mesh)
    leave_group()  # after a failure the process exits and its launcher ends the others


def _train(args, mesh) -> None:
    device = torch.device(args.device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.coords == (0, 0)
    log = print if rank0 else (lambda *a, **k: None)

    from ..config import TrainArgs, tiny_config
    from ..stream import CharTokenizer, HFTokenizerAdapter

    from ..models import init_mmduet_params
    from ..models.io import load_checkpoint, save_checkpoint
    from ..models.lora import fold_lora_scale, init_lora, lora_scale
    from ..ops.attention import KernelError
    from ..parallel import DATA_AXIS, shard_params, shard_train_state
    from ..parallel.collectives import carry_spec
    from ..parallel.sharding import gather_params, gather_train_state
    from .checkpoint import latest_checkpoint, restore_train_state, save_train_state
    from .optimizer import FINETUNE_KEYS, make_optimizer, merge_trainable, tree_map
    from .step import init_train_state, make_train_step, rank_batch

    os.makedirs(args.output_dir, exist_ok=True)
    np.random.seed(args.seed)
    random.seed(args.seed)

    # --- model -----------------------------------------------------------
    if args.tiny_random:
        # head_dim 128 in bf16 on a GPU: the width and dtype kernel C takes
        cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        params = init_mmduet_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed), device, dtype)
        if mesh is not None:
            params = shard_params(params, mesh, mode=args.param_mode)
        tokenizer = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    elif args.checkpoint:
        cfg, params, _ = load_checkpoint(args.checkpoint, device, mesh=mesh,
                                         param_mode=args.param_mode)
        tokenizer = HFTokenizerAdapter.from_pretrained(
            args.checkpoint, frame_num_tokens=cfg.frame_num_tokens,
            v_placeholder=cfg.v_placeholder,
        )
        # the tokenizer owns the special-token ids
        cfg = cfg.replace(
            v_placeholder_id=tokenizer.v_placeholder_id,
            eos_token_id=tokenizer.eos_token_id,
        )
    else:
        raise SystemExit("one of --checkpoint or --tiny_random is required")

    # --bf16 false: full-f32 base params (precision-debug mode). Trainable
    # params and gradient accumulation are f32 either way.
    if not args.bf16:
        params = tree_map(lambda x: carry_spec(x.float(), x) if x.dtype == torch.bfloat16
                          else x, params)

    # --- data ------------------------------------------------------------
    train_args = TrainArgs(
        learning_rate=args.learning_rate,
        lr_schedule=args.lr_schedule,
        warmup_ratio=args.warmup_ratio,
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        grad_accum_steps=args.grad_accum_steps,
        per_device_batch_size=args.per_device_batch_size,
        frame_fps=args.frame_fps,
        max_num_frames=args.max_num_frames,
        output_dir=args.output_dir,
    )
    data_n = 1 if mesh is None else mesh.shape[DATA_AXIS]
    B = args.per_device_batch_size * data_n  # the global batch, as the JAX CLI
    A = args.grad_accum_steps
    seq_len = args.seq_len or (args.max_num_frames * cfg.frame_num_tokens + 1024)

    # resolve resume before building the data stream: checkpoint-<step>
    # says how many optimizer batches the interrupted run consumed
    resume = args.resume_from_checkpoint
    if resume == "auto":
        resume = latest_checkpoint(args.output_dir)
    resume_step = 0
    if resume:
        m = re.search(r"checkpoint-(\d+)$", os.path.basename(resume.rstrip("/")))
        resume_step = int(m.group(1)) if m else 0

    if args.synthetic_steps:
        total_steps = args.synthetic_steps
        batches: Iterator = synthetic_batches(
            cfg, min(seq_len, 64), args.max_num_frames, B, A, total_steps, args.seed,
        )
    else:
        from ..data.collator import Collator
        from ..data.stream_dataset import build_concat_train_dataset

        dataset = build_concat_train_dataset(
            args.dataset_config, tokenizer,
            frame_fps=args.frame_fps, max_num_frames=args.max_num_frames,
            frame_size=cfg.frame_resolution,  # decode at the model's size
        )
        collator = Collator(
            tokenizer, seq_len=seq_len,
            max_frames=args.max_num_frames * B, frame_size=cfg.frame_resolution,
            buckets=parse_length_buckets(args.length_buckets, seq_len),
            frame_buckets=parse_length_buckets(
                args.frame_buckets, args.max_num_frames * B, quantum=8
            ),
        )
        if collator.buckets and resume_step:
            log("WARNING: resume with length buckets: step grouping "
                  "near the interruption point is approximate "
                  "(bounded by one partial accum group per bucket)")
        steps_per_epoch = len(dataset) // (B * A)
        total_steps = steps_per_epoch * args.num_epochs
        batches = rank_real_batches(dataset, collator, B, A, args.num_epochs, args.seed,
                                    args.dataloader_num_workers, resume_step, mesh=mesh)

    # --- optimizer & state ----------------------------------------------
    tx, sched = make_optimizer(train_args, total_steps)
    lora = init_lora(torch.Generator(device=device).manual_seed(args.seed + 1), cfg.text,
                     rank=args.lora_r, device=device)
    if mesh is None:
        state = init_train_state(params, lora, tx)
    else:  # from the whole trainable leaves (the local base holds blocks of them)
        whole = gather_params({k: params[k] for k in FINETUNE_KEYS})
        state = shard_train_state(init_train_state(whole, lora, tx), mesh)
        del whole
    del lora  # the state holds the adapter: a second copy would stay for the whole run
    if resume:
        log(f"resuming from {resume}")
        state = restore_train_state(resume, state, mesh=mesh)
    step_fn = make_train_step(cfg, train_args, tx, sched, mesh=mesh)

    # --- loop ------------------------------------------------------------
    log_path = os.path.join(args.output_dir, "log.jsonl")
    log_f = open(log_path, "a") if rank0 else open(os.devnull, "w")
    t_last = time.perf_counter()
    done = state.step
    if done:
        # resume: fast-forward past the batches the interrupted run consumed
        log(f"resume: skipping {done} already-consumed optimizer batches")
        if args.synthetic_steps:
            for _ in range(done):
                if next(batches, None) is None:
                    break
        elif done != resume_step:
            log(f"WARNING: restored step {done} != checkpoint-name step "
                  f"{resume_step}; data order will not match the original run")
    real_toks = padded_toks = 0  # since the last log line
    for batch in batches:
        if done >= total_steps:
            break
        if "n_real_tokens" in batch:  # the whole batch's, also where a rank read its share
            real_toks += int(np.sum(batch["n_real_tokens"]))
            padded_toks += len(batch["input_ids"]) * B * batch["input_ids"].shape[-1]
        batch = {k: v for k, v in batch.items()
                 if k not in ("sample_idxs", "num_frames", "n_real_tokens")}
        if args.synthetic_steps:  # a real dataset's batch is the rank's share as read
            batch = rank_batch(batch, cfg, mesh)
        batch = _to_device(batch, device)
        try:
            state, metrics = step_fn(state, params, batch)
            done = state.step
        except KernelError:
            raise  # a fault of the run, not of this batch
        except Exception as e:  # fault tolerance: skip the batch
            if mesh is not None:
                raise  # the other ranks' collectives would wait for this one
            print(f"step {done} failed: {type(e).__name__}: {e}; skipping")
            continue
        if done % args.logging_steps == 0 or done == total_steps:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            rec = {"step": done, "total": total_steps,
                   "sec_per_step": round(dt / max(args.logging_steps, 1), 3), **metrics}
            if padded_toks:
                # real (non-pad) token throughput; pad_frac is what length
                # bucketing shrinks
                rec["real_tok_s"] = round(real_toks / dt, 1)
                rec["pad_frac"] = round(1.0 - real_toks / padded_toks, 3)
                real_toks = padded_toks = 0
            log(json.dumps(rec))
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
        if args.save_steps and done % args.save_steps == 0:
            path = save_train_state(args.output_dir, done, state, args.save_total_limit,
                                    mesh=mesh)
            log(f"saved {path}")
    log_f.close()

    # final model: the trainable leaves folded back into a full checkpoint,
    # alpha/r folded into b (the saved adapter serves at lora_scale=1.0);
    # on a mesh every rank gathers, rank 0 writes
    if mesh is not None:
        params = gather_params(params, to="cpu", keep=rank0)
        state = gather_train_state(state, mesh, to="cpu")
    if not rank0:
        return
    final_dir = os.path.join(args.output_dir, "final")
    save_checkpoint(
        final_dir, cfg, merge_trainable(params, state.trainable),
        lora=fold_lora_scale(state.trainable["lora"], lora_scale(args.lora_r, args.lora_alpha)),
    )
    if args.checkpoint:  # ship tokenizer files so eval consumes the dir directly
        import shutil

        for name in (
            "tokenizer.json", "tokenizer_config.json", "vocab.json",
            "merges.txt", "special_tokens_map.json", "added_tokens.json",
        ):
            src = os.path.join(args.checkpoint, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(final_dir, name))
    print(f"training done at step {done}; final model in {args.output_dir}/final")


if __name__ == "__main__":
    main()
