"""`scripts/memory_budget_torch.py`, the port's memory budget from shapes:

- at `tiny_config()`, its persistent bytes per rank equal exactly the bytes
  of the trees the port materializes on the CPU: `shard_params` (bf16, int8
  and int4 leaves, both parameter modes), `shard_train_state` (trainable
  leaves, f32 moments, f32 gradient accumulators), the rank's share of a
  batch that the training loop stages (`rank_batch`) and `serving_cache` over
  a rank's lanes (`lane_block`) and kv heads, bf16 and int8, on the (1, 1),
  (2, 1), (1, 2) and (2, 2) meshes, every rank; and the cache and frame
  terms equal the tensors the three engines allocate;
- the 7B reference recipe's rows against `docs/MEMORY_BUDGET.md` (the JAX
  package's XLA analysis): the base weights column to 0.01 GiB; the
  trainable and optimizer-state columns where the port's layout is the JAX
  one, and where it differs on purpose, the difference named;
- the CLI prints its table and one JSON object; the scripts import nothing
  of JAX or the JAX package."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import memory_budget_torch as mb  # noqa: E402
from mmduet_tpu_torch.config import MMDuetConfig, TrainArgs, tiny_config  # noqa: E402
from mmduet_tpu_torch.config import TestArgs as ServeArgs  # noqa: E402
from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer  # noqa: E402
from mmduet_tpu_torch.infer import LiveInferEngine  # noqa: E402
from mmduet_tpu_torch.infer.state import cache_slots, serving_cache  # noqa: E402
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, quant  # noqa: E402
from mmduet_tpu_torch.ops import attention  # noqa: E402
from mmduet_tpu_torch.parallel import ProcessMesh, lane_block, shard_params  # noqa: E402
from mmduet_tpu_torch.parallel.sharding import shard_train_state  # noqa: E402
from mmduet_tpu_torch.train import init_train_state, make_optimizer  # noqa: E402
from mmduet_tpu_torch.train.loop import _to_device  # noqa: E402
from mmduet_tpu_torch.train.optimizer import tree_map  # noqa: E402
from mmduet_tpu_torch.train.step import rank_batch  # noqa: E402

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
LANES, MAX_FRAMES = 4, 16


@pytest.fixture(scope="module")
def cpu_trees():
    """The tiny model's whole trees on the CPU: bf16, int8 and int4."""
    cfg = tiny_config()
    dense = init_mmduet_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    return cfg, {"bf16": dense, "int8": quant.quantize_params(dense, bits=8),
                 "int4": quant.quantize_params(dense, bits=4)}


def _ranks(shape):
    return [(d, m) for d in range(shape[0]) for m in range(shape[1])]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("weights, kv", [("bf16", None), ("int8", None), ("int4", "int8"),
                                         ("bf16", "int8")])
def test_serving_persistent_bytes_are_the_materialized_trees(cpu_trees, shape, weights, kv):
    """Every rank: the budget's weights and KV cache terms equal the bytes
    of its `shard_params` tree and of the cache an engine makes over its
    lanes (`lane_block`) with the kv heads of that tree."""
    cfg, trees = cpu_trees
    budget = mb.serving_budget(mb.Serving("tiny", cfg, weights=weights, mesh=shape,
                                          engine="batched", lanes=LANES, kv_cache_quant=kv,
                                          max_num_frames=MAX_FRAMES))
    terms = {n: b for n, b, _ in budget.persistent}
    slots = cache_slots(MAX_FRAMES, cfg.frame_num_tokens)
    for coords in _ranks(shape):
        mesh = ProcessMesh(shape, coords, torch.device("cpu"))
        local = shard_params(trees[weights], mesh)
        lo, hi = lane_block(mesh, LANES)
        cache = serving_cache(cfg.text, local["decoder"], hi - lo, slots, torch.bfloat16,
                              "cpu", quant=kv)
        assert terms["base weights"] == mb.tree_bytes(local), coords
        assert terms["KV cache"] == mb.tree_bytes(cache), coords
        assert terms["penalty rows"] == (hi - lo) * cfg.text.vocab_size


@pytest.mark.parametrize("kind", ["live", "batched", "scorer"])
def test_serving_terms_are_the_engines_own_tensors(cpu_trees, kind):
    """One engine of each kind on the CPU: the budget's KV cache and frame
    terms equal the bytes of the cache the engine made (its length by the
    engine's own rule) and of the frame embeddings it keeps: the live
    engine's and the scorer's session video, the batched engine's
    (lanes, max_num_frames, ft, H) buffer."""
    from mmduet_tpu_torch.stream import CharTokenizer

    cfg, trees = cpu_trees
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    args = ServeArgs(frame_fps=2.0, stream_end_prob_threshold=0.5, max_num_frames=MAX_FRAMES)
    rng = np.random.RandomState(0)
    px = cfg.frame_resolution
    videos = [rng.randint(0, 256, (n, px, px, 3), dtype=np.uint8) for n in (5, 7)]
    if kind == "live":
        engine = LiveInferEngine(trees["bf16"], cfg, tok, args)
        engine.input_video_stream(videos[1])
        cache, frames = engine.state.kv_cache, engine.frame_embeds
    else:
        cls = BatchedStreamEngine if kind == "batched" else BatchedStreamScorer
        kw = {"args": args} if kind == "batched" else {"max_num_frames": MAX_FRAMES}
        engine = cls(trees["bf16"], cfg, tok, n_streams=len(videos), **kw)
        engine.input_video_streams(videos)
        cache, frames = engine._cache, engine._frame_embeds
    budget = mb.serving_budget(mb.Serving("tiny", cfg, engine=kind, lanes=len(videos)
                                          if kind != "live" else 1, frames=7,
                                          max_num_frames=MAX_FRAMES))
    terms = {n: b for n, b, _ in budget.persistent}
    assert terms["KV cache"] == mb.tree_bytes(cache)
    frame_term = terms["frame buffer" if kind == "batched" else "frame embeddings"]
    assert frame_term == mb.tree_bytes(frames)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mode", ["replicate", "fsdp"])
def test_training_persistent_bytes_are_the_materialized_state(cpu_trees, shape, mode):
    """Every rank: the base weights (fsdp cuts them over data), the
    trainable leaves, the f32 moments and the f32 gradient accumulators
    equal the bytes of `shard_params` and `shard_train_state` on the CPU,
    and the staged batch the bytes the loop stages of a host batch whose
    sample 0 holds 3 frames and sample 1 one, in 4 slots: the rank's share
    (`rank_batch`: one sample and its 3 or 1 slots where data is 2, the
    whole batch where it is 1)."""
    cfg, trees = cpu_trees
    tx, _ = make_optimizer(TrainArgs(), 1)
    lora = init_lora(torch.Generator().manual_seed(1), cfg.text, rank=4, device="cpu")
    whole = init_train_state(trees["bf16"], lora, tx)
    ids = np.zeros((2, 2, 32), np.int32)
    ids[:, 0, 1:1 + 3 * cfg.frame_num_tokens] = cfg.v_placeholder_id
    ids[:, 1, 1:1 + cfg.frame_num_tokens] = cfg.v_placeholder_id
    px = cfg.frame_resolution
    batch = {"input_ids": ids, "attn_mask": np.ones(ids.shape, bool),
             **{k: np.full(ids.shape, -100, np.int32)
                for k in ("labels", "informative_labels", "relevance_labels")},
             "frames": np.zeros((2, 4, px, px, 3), np.uint8)}
    for coords in _ranks(shape):
        budget = mb.training_budget(mb.Training(
            "tiny", cfg, mesh=shape, param_mode=mode, accum=2, batch=2, seq=32, frames=4,
            rank_frames=(3, 1)[coords[0]] if shape[0] > 1 else None, lora_r=4))
        terms = {n: b for n, b, _ in budget.persistent}
        mesh = ProcessMesh(shape, coords, torch.device("cpu"))
        state = shard_train_state(whole, mesh)
        assert terms["base weights"] == mb.tree_bytes(shard_params(trees["bf16"], mesh, mode))
        assert terms["trainable"] == mb.tree_bytes(state.trainable)
        assert terms["Adam moments"] == (mb.tree_bytes(state.opt_state["mu"])
                                         + mb.tree_bytes(state.opt_state["nu"]))
        assert terms["gradients"] == mb.tree_bytes(tree_map(lambda p: p.float(),
                                                            state.trainable))
        staged = _to_device(rank_batch(batch, cfg, mesh), "cpu")
        assert terms["staged batch"] == mb.tree_bytes(staged), coords


def _doc_table() -> dict:
    """{config: [base, trainable, opt state] in GiB} of docs/MEMORY_BUDGET.md."""
    rows = {}
    with open(os.path.join(REPO, "docs", "MEMORY_BUDGET.md")) as f:
        for line in f:
            m = re.match(r"\| (\w+) \| \(\d,\d\) \| ([\d.]+) GB \| ([\d.]+) GB \| ([\d.]+) GB",
                         line)
            if m:
                rows[m.group(1)] = [float(x) for x in m.groups()[1:]]
    return rows


@pytest.fixture(scope="module")
def recipe():
    cfg = MMDuetConfig()
    params = mb.model_params(cfg)
    rows = {b.name: {n: x / mb.GIB for n, x, _ in b.persistent}
            for b in mb.recipe_budgets(params)}
    return cfg, params, rows


def test_recipe_base_weights_match_the_jax_analysis(recipe):
    """`docs/MEMORY_BUDGET.md`'s base params column, 14.99 / 1.87 / 1.87,
    from the port's `shard_params` on the meta 7B tree."""
    _, _, rows = recipe
    doc = _doc_table()
    assert set(doc) == {"zero2_8x1", "fsdp_8x1", "fsdp_tp_4x2"} == set(rows)
    for name, (base, _, _) in doc.items():
        assert abs(rows[name]["base weights"] - base) <= 0.01, name


def test_recipe_trainable_and_moments_against_the_jax_analysis(recipe):
    """Where the layout is the JAX one (zero2_8x1: the trainable leaves
    whole on every rank) the trainable column matches. Two differences are
    the port's on purpose and named here: (1) its trainable leaves stay
    whole over data also under fsdp (`shard_train_state`), so fsdp_8x1 holds
    8 x the JAX column's and fsdp_tp_4x2 4 x; (2) its Adam moments are f32
    for every leaf, where the JAX analysis reads the state optax
    initializes in the leaf's dtype (bf16 for the projector and heads;
    optax's first update makes them f32 too): the JAX column is the port's
    moments with the leaves' own dtypes, the port's the f32 bytes, both cut
    over data."""
    cfg, params, rows = recipe
    doc = _doc_table()
    assert abs(rows["zero2_8x1"]["trainable"] - doc["zero2_8x1"][1]) <= 0.001
    assert abs(rows["fsdp_8x1"]["trainable"] - 8 * doc["fsdp_8x1"][1]) <= 0.008
    assert abs(rows["fsdp_tp_4x2"]["trainable"] - 4 * doc["fsdp_tp_4x2"][1]) <= 0.004
    lora = init_lora(torch.Generator(), cfg.text, rank=16, device=mb.META)
    leaf_dtype = mb.tree_bytes(lora) + sum(mb.tree_bytes(params[k]) for k in
                                           ("projector", "informative_head", "relevance_head"))
    f32 = mb.tree_bytes(lora) + 2 * (leaf_dtype - mb.tree_bytes(lora))
    for name, (_, _, opt) in doc.items():
        data = 8 if name != "fsdp_tp_4x2" else 4
        assert abs(2 * leaf_dtype / data / mb.GIB - opt) <= 0.001, name
    assert rows["zero2_8x1"]["Adam moments"] == pytest.approx(2 * f32 / 8 / mb.GIB)
    assert rows["fsdp_8x1"]["Adam moments"] == pytest.approx(2 * f32 / 8 / mb.GIB)


def test_estimate_check_and_terms():
    """`check` holds the persistent part under the peak and the whole within
    max(10 %, 1 GiB); every term has a name, bytes and what it is."""
    cfg = tiny_config()
    b = mb.serving_budget(mb.Serving("tiny", cfg, engine="batched", lanes=2,
                                     max_num_frames=MAX_FRAMES))
    assert all(isinstance(n, str) and x >= 0 and w for n, x, w in b.persistent)
    assert b.total_bytes == b.persistent_bytes + b.peak_moment[1] > b.persistent_bytes
    assert mb.check(b, b.total_bytes)[0]
    assert mb.check(b, b.total_bytes + mb.GIB)[0]  # 1 GiB: the floor of the tolerance
    assert not mb.check(b, b.total_bytes + 2 * mb.GIB)[0]
    assert not mb.check(b, b.persistent_bytes - 1)[0]  # the persistent part above the peak
    ok, line = mb.check(b, b.total_bytes + mb.GIB // 2, mb.GIB // 2)
    assert ok and "less 0.50 resident" in line


# (lanes, kv heads, GQA group, tokens, slots): kernel A launches at the budget's
# shapes: a decode step and a frame step at a (1, 4) and a (1, 2) rank's kv
# heads and at 8 lanes of the whole model's, an 8-frame block (one span), and
# a cache whose one span needs no scratch
A_SCRATCH_CASES = [(1, 1, 7, 1, 24576), (1, 2, 7, 64, 24576), (8, 4, 7, 1, 24576),
                   (8, 4, 7, 64, 24576), (4, 2, 7, 64, 4096), (8, 4, 7, 392, 24576),
                   (2, 1, 7, 1, 64)]


@pytest.mark.parametrize("case", A_SCRATCH_CASES, ids=["-".join(map(str, c))
                                                       for c in A_SCRATCH_CASES])
def test_kernel_a_scratch_term_is_what_the_wrapper_allocates(case, monkeypatch):
    """The budget's kernel A scratch term is, to the byte, the partials and
    counters that `ops.attention._split_args` allocates for the launch."""
    lanes, kh, group, tokens, slots = case
    monkeypatch.setattr(attention, "_split_scratch", {})
    monkeypatch.setattr(attention, "_split_memo", {})
    cpu = torch.device("cpu")
    _, nsplit, part, _ = attention._split_args(cpu, lanes, kh, group * tokens, slots, 128)
    allocated = 0
    if part is not None:
        p_, c_ = attention._split_scratch[cpu]
        allocated = p_.numel() * p_.element_size() + c_.numel() * c_.element_size()
        assert int(c_.abs().sum()) == 0
    assert (part is None) == (nsplit == 1)
    assert mb.decode_scratch_bytes(lanes, kh, group, tokens, slots, 128) == allocated


def test_cli_prints_its_table_and_json(tmp_path):
    out = tmp_path / "budget.md"
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "memory_budget_torch.py"),
                           "--out", str(out)], capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["capacity_bytes"] == mb.H100_80GB_BYTES
    assert [e["name"] for e in result["estimates"]] == ["zero2_8x1", "fsdp_8x1", "fsdp_tp_4x2"]
    assert all(e["estimate_gib"] > e["persistent_gib"] > 0 and "fits" in e
               for e in result["estimates"])
    assert "not a measurement" in out.read_text()


def test_peak_replay_finds_the_blocks_live_at_the_peak():
    """`scripts/train_peak_tensors_torch.py`'s replay of an allocator
    history: allocations add, requested frees remove (a block allocated
    before the history too), and the peak keeps the blocks then live."""
    import train_peak_tensors_torch as peak

    f = [{"filename": os.path.join(REPO, "mmduet_tpu_torch", "x.py"), "line": 3, "name": "g"}]
    events = [{"action": "alloc", "addr": 1, "size": 100, "frames": f},
              {"action": "free_requested", "addr": 9, "size": 40},  # allocated before
              {"action": "alloc", "addr": 2, "size": 30},
              {"action": "segment_alloc", "addr": 5, "size": 1000},
              {"action": "free_requested", "addr": 1, "size": 100},
              {"action": "free_completed", "addr": 1, "size": 100},
              {"action": "alloc", "addr": 3, "size": 20}]
    got, blocks, before = peak.replay_peak(events, 50)
    assert (got, before) == (150, 50) and blocks == {1: (100, f)}
    assert peak._site(f) == ("mmduet_tpu_torch/x.py:3 g",)
    got, blocks, before = peak.replay_peak(events[1:3] + [dict(events[-1], size=80)], 50)
    assert (got, before) == (120, 10) and set(blocks) == {2, 3}


def test_new_scripts_import_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, 'scripts'); import memory_budget_torch, "
            "verify_checkpoint_parity_torch, train_peak_tensors_torch; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'mmduet_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    for name in ("memory_budget_torch.py", "verify_checkpoint_parity_torch.py",
                 "train_peak_tensors_torch.py", "train_torch.sh",
                 "eval_youcook2_torch.sh", "eval_magqa_torch.sh", "eval_charades_torch.sh",
                 "eval_qvh_torch.sh"):
        code_lines = [line for line in open(os.path.join(REPO, "scripts", name))
                      if not line.lstrip().startswith("#")]
        assert not any(re.search(r"(import|from|-m)\s+(jax|mmduet_tpu(?!_torch))", line)
                       for line in code_lines), name
