"""The port's streaming forwards on device cursors against the JAX package,
on `tiny_config()`: one numpy parameter tree and numpy inputs from a seed
feed both.

`step_forward`, `chunk_scores_forward` and `frames_block_forward` take
their cursors, real lengths, score positions and commit mask as device
tensors here (int32 / bool on the CPU), as the engines' graph route feeds
them. f32 activations on both sides, with a cache in the activation dtype (the
engines' cache; bf16 on the card) or an int8 cache: scores and LM logits
agree to 1e-4, committed rows to 1e-4, an int8 cache's up to one int8
step of the row's scale (as `test_torch_kv_quant.py` holds it: a value on
a rounding tie may fall either way after a different order of sums). A lane that ``commit`` leaves
out keeps every byte of its cache (the JAX package writes its rows past
its cursor, where nothing reads them).

Also here: each captured entry's body reads nothing back to the host and
makes nothing from host data (the tripwire of
`test_torch_decode_device.py`), the graph route refuses CPU tensors before
it captures anything, and the memory budget's price of the graphs' pool."""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models import mmduet as jmm
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu_torch.models import mmduet as tmm
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.ops import attention
from mmduet_tpu_torch.parallel import MODEL_AXIS, make_mesh

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PCFG = config_from_dict(dataclasses.asdict(CFG))
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)
TP = params_from_numpy(NP, "cpu")
S, T, K = 64, 12, 3  # cache slots, chunk width, frames of a block
FT, H = CFG.frame_num_tokens, CFG.text.hidden_size


@functools.lru_cache(maxsize=None)
def _lora():
    """A runtime adapter of rank 4 with nonzero ``b``, in both trees."""
    lora = jlora.init_lora(jax.random.PRNGKey(3), CFG.text, rank=4)
    r = np.random.RandomState(5)
    lora = {name: {"a": ab["a"], "b": jnp.asarray(r.randn(*ab["b"].shape) * 0.05, jnp.float32)}
            for name, ab in lora.items()}
    return lora, params_from_numpy(jax.tree.map(np.asarray, lora), "cpu")


# name: (lanes, cursors, commit mask, cache ("f32": the activation dtype; "int8"), LoRA,
# one-device mesh)
CASES = {
    "one_lane": (1, [9], None, "f32", False, False),
    "three_lanes_one_left_out": (3, [5, 30, 17], [True, False, True], "f32", False, False),
    "three_lanes_one_left_out_int8": (3, [5, 30, 17], [True, True, False], "int8", False, False),
    "one_lane_int8_lora": (1, [20], None, "int8", True, False),
    "three_lanes_lora_mesh": (3, [5, 30, 17], [False, True, True], "f32", True, True),
}
FRAME_CASES = ["one_lane", "one_lane_int8_lora", "three_lanes_lora_mesh"]


def _history(B, seed):
    r = np.random.RandomState(seed)
    t = CFG.text
    shape = (t.num_layers, B, t.num_kv_heads, S, t.head_dim)
    return (r.randn(*shape) * 0.5).astype(np.float32), (r.randn(*shape) * 0.5).astype(np.float32)


def _caches(B, kind, seed):
    """(JAX cache, port cache, the port cache's tensors before the call): a
    random history in every slot, stored as ``kind``."""
    k, v = _history(B, seed)
    if kind == "int8":
        (jkw, jks), (jvw, jvs) = jq.quantize_kv_rows(jnp.asarray(k)), jq.quantize_kv_rows(
            jnp.asarray(v))
        jc = jq.KVCache({"qw": jkw, "qs": jks}, {"qw": jvw, "qs": jvs})
        tc = tq.KVCache(*({"qw": torch.tensor(np.asarray(w)), "qs": torch.tensor(np.asarray(s))}
                          for w, s in ((jkw, jks), (jvw, jvs))))
    else:
        jc = jq.KVCache(jnp.asarray(k), jnp.asarray(v))
        tc = tq.KVCache(torch.tensor(k), torch.tensor(v))
    return jc, tc, [x.clone() for x in _leaves(tc)]


def _leaves(cache):
    return [t for leaf in cache for t in (leaf.values() if isinstance(leaf, dict) else (leaf,))]


def _dev(values, dtype=torch.int32):
    """Host values as the device tensors an entry's body takes."""
    return torch.tensor(values, dtype=dtype)


def _ctx(mesh):
    if not mesh:
        return None
    return attention.ShardCtx(make_mesh((1, 2), devices=["cpu"] * 2), head_axis=MODEL_AXIS)


def _rows_agree(got: tq.KVCache, want: jq.KVCache, before, lanes, rows):
    """The committed rows [cursor, cursor + rows) of ``lanes`` against the
    JAX cache, and every byte of the other lanes against ``before``."""
    for (g, w), b0 in zip(((got.k, want.k), (got.v, want.v)), (before[:len(before) // 2],
                                                                 before[len(before) // 2:])):
        gv = tq.dequantize_kv(g).numpy()
        wv = np.asarray(jq.dequantize_kv(w)).astype(np.float32)
        if isinstance(g, dict):  # one int8 step of the row's scale
            step = np.asarray(w["qs"])[..., None] + 1e-6
        else:
            step = ATOL
        for b, (on, c) in enumerate(lanes):
            sl = (slice(None), b, slice(None), slice(c, c + rows))
            if on:
                assert np.all(np.abs(gv[sl] - wv[sl]) <= np.broadcast_to(step, wv.shape)[sl])
            else:  # left out: every byte as before the call
                now = [g["qw"], g["qs"]] if isinstance(g, dict) else [g]
                for x, x0 in zip(now, b0):
                    assert torch.equal(x[:, b], x0[:, b])


def _chunk(B, seed):
    return (np.random.RandomState(seed).randn(B, T, H) * 0.5).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_step_forward_on_device_cursors_matches_jax(case):
    B, cl, commit, kind, lora, mesh = CASES[case]
    tr = [T, T - 4, 7][:B]
    jl, tl = _lora() if lora else (None, None)
    emb = _chunk(B, 1)
    jc, tc, before = _caches(B, kind, 2)
    jo = jmm.step_forward(JP, CFG, jnp.asarray(emb), jc, jnp.asarray(cl, jnp.int32),
                          jnp.asarray(tr, jnp.int32), lora=jl, lora_scale=0.5, use_flash=False)
    to = tmm.step_forward(TP, PCFG, torch.tensor(emb), tc, _dev(cl), _dev(tr), lora=tl,
                          lora_scale=0.5, shard_ctx=_ctx(mesh),
                          commit=None if commit is None else _dev(commit, torch.bool))
    for got, want in ((to.informative_prob, jo.informative_prob),
                      (to.relevance_prob, jo.relevance_prob)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to.last_logits.numpy(), np.asarray(jo.last_logits), rtol=0,
                               atol=ATOL)
    _rows_agree(to.kv_cache, jo.kv_cache, before, list(zip(commit or [True] * B, cl)), T)


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_scores_forward_on_device_cursors_matches_jax(case):
    B, cl, commit, kind, lora, mesh = CASES[case]
    tr = [T, T - 4, 7][:B]
    pos = np.array([[0, 5, T - 1], [2, 3, 7], [6, 6, 1]][:B], np.int32)
    jl, tl = _lora() if lora else (None, None)
    emb = _chunk(B, 3)
    jc, tc, before = _caches(B, kind, 4)
    jp, jcache = jmm.chunk_scores_forward(
        JP, CFG, jnp.asarray(emb), jc, jnp.asarray(cl, jnp.int32), jnp.asarray(tr, jnp.int32),
        jnp.asarray(pos), lora=jl, lora_scale=0.5, use_flash=False)
    tp, tcache = tmm.chunk_scores_forward(
        TP, PCFG, torch.tensor(emb), tc, _dev(cl), _dev(tr), torch.tensor(pos), lora=tl,
        lora_scale=0.5, shard_ctx=_ctx(mesh),
        commit=None if commit is None else _dev(commit, torch.bool))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    _rows_agree(tcache, jcache, before, list(zip(commit or [True] * B, cl)), T)


@pytest.mark.parametrize("case", FRAME_CASES)
def test_frames_block_forward_on_a_device_cursor_matches_jax(case):
    _, cl, _, kind, lora, mesh = CASES[case]
    jl, tl = _lora() if lora else (None, None)
    frames = (np.random.RandomState(5).randn(K, FT, H) * 0.5).astype(np.float32)
    jc, tc, before = _caches(1, kind, 6)
    ji, jr, jcache = jmm.frames_block_forward(JP, CFG, jnp.asarray(frames), jc,
                                              jnp.int32(cl[0]), lora=jl, lora_scale=0.5,
                                              use_flash=False)
    ti, tr, tcache = tmm.frames_block_forward(TP, PCFG, torch.tensor(frames), tc, _dev(cl[:1]),
                                              lora=tl, lora_scale=0.5, shard_ctx=_ctx(mesh))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
    _rows_agree(tcache, jcache, before, [(True, cl[0])], K * FT)


def _raise(*args, **kw):
    raise AssertionError("a forward's body read a tensor back to the host or made one from "
                         "host data")


def _entries(case):
    """Each captured entry's body as the graph route calls it: on its
    device operands, as a callable of nothing."""
    B, cl, commit, kind, lora, mesh = CASES[case]
    tl = _lora()[1] if lora else None
    ctx = _ctx(mesh)
    _, cache, _ = _caches(B, kind, 7)
    _, one, _ = _caches(1, kind, 12)  # the frame block's lane
    x = dict(embeds=torch.tensor(_chunk(B, 8)), cache_len=_dev(cl), t_real=_dev([T, 5, 9][:B]))
    if commit is not None:
        x["commit"] = _dev(commit, torch.bool)
    sp = dict(x, score_pos=torch.tensor([[0, 4, 11]] * B, dtype=torch.int64))
    fb = dict(frames=torch.tensor(_chunk(1, 9)[0, :K * FT].reshape(K, FT, H)),
              cache_len=_dev(cl[:1]))
    kw = dict(lora=tl, lora_scale=0.5, shard_ctx=ctx)
    return {
        "step": lambda: tmm.step_body(TP, PCFG, cache, x, compute_lm_logits=True, **kw),
        "chunk_scores": lambda: tmm.chunk_scores_body(TP, PCFG, cache, sp, **kw),
        "frames_block": lambda: tmm.frames_block_body(TP, PCFG, one, fb, **kw),
        # the public entries pass device operands through untouched
        "step_forward": lambda: tmm.step_forward(TP, PCFG, x["embeds"], cache, x["cache_len"],
                                                 x["t_real"], commit=x.get("commit"), **kw),
    }, _leaves(cache) + _leaves(one)


@pytest.mark.parametrize("case", ["one_lane", "three_lanes_one_left_out_int8",
                                  "three_lanes_lora_mesh"])
def test_captured_bodies_make_no_host_read(case, monkeypatch):
    tripped, tripped_cache = _entries(case)
    free, free_cache = _entries(case)
    outs = {}
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "cpu", "numpy", "pin_memory", "__int__",
                     "__float__", "__index__"):
            m.setattr(torch.Tensor, name, _raise)
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, _raise)
        m.setattr(tq, "ints_to", _raise)
        m.setattr(tq, "lane_list", _raise)
        for name, fn in tripped.items():
            outs[name] = fn()
    for name, fn in free.items():
        want = fn()
        got = outs[name]
        if isinstance(want, tmm.StepOutput):
            got, want = got[:3], want[:3]
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert (g is None and w is None) or torch.equal(g, w), name
    assert all(torch.equal(a, b) for a, b in zip(tripped_cache, free_cache))


def test_graph_route_refuses_cpu_tensors_before_it_captures():
    graphs = tmm.EngineGraphs()
    _, cache, before = _caches(1, "f32", 10)
    emb = torch.tensor(_chunk(1, 11))
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.step_forward(TP, PCFG, emb, cache, [3], [T], graphs=graphs)
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.chunk_scores_forward(TP, PCFG, emb, cache, [3], [T], [0, 1], graphs=graphs)
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.frames_block_forward(TP, PCFG, emb[0, :K * FT].reshape(K, FT, H), cache, 3,
                                 graphs=graphs)
    assert len(graphs) == 0 and graphs.pool is None and graphs.kinds() == {}
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cache), before))  # nothing ran


@pytest.mark.parametrize("engine, mesh", [("live", (1, 1)), ("batched", (1, 1)),
                                          ("scorer", (1, 1)), ("live", (1, 2)),
                                          ("batched", (2, 1))])
def test_memory_budget_prices_the_graph_pool(engine, mesh):
    """`scripts/memory_budget_torch.py` prices the engine's graph pool once,
    as a persistent term on the graph route (one process): the captures'
    largest moment, the decoder's widest chunk or a decode step, and the
    static inputs and outputs of each captured shape. A rank of a process
    mesh runs eagerly and has no pool."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import memory_budget_torch as mb

    lanes = 1 if engine == "live" else 4
    est = mb.serving_budget(mb.Serving("tiny", PCFG, engine=engine, lanes=lanes, mesh=mesh,
                                       max_new=6))
    persistent = {n: b for n, b, _ in est.persistent}
    if mesh != (1, 1):
        assert "graph pool" not in persistent
        return
    captured = [m for m in mb.CAPTURED if m in est.moments]
    assert captured and ("decode step" in captured) == (engine != "scorer")
    largest = max(sum(b for _, b, _ in est.moments[m]) for m in captured)
    io = mb.graph_io_bytes(mb.Serving("tiny", PCFG, engine=engine, lanes=lanes, mesh=mesh))
    assert persistent["graph pool"] == largest + io and largest > 0 and io > 0
