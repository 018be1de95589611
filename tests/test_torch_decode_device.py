"""The port's device-side generation (`mmduet.decode_loop` with its loop
state on the device, `decode_step`, `EngineGraphs`) against the JAX
package's `decode_loop`, on `tiny_config()`: one numpy parameter tree and
numpy inputs from a seed feed both.

f32 on both sides: ``packed`` (tokens, n, cursors) and the penalty mask
are equal exactly, the active lanes' caches agree to atol=1e-4 (summation
order only; the tolerance of `test_torch_model.py::test_decode_loop`) and
a frozen lane's cache is untouched (the JAX package writes its rows past
the frozen cursor, where nothing reads them). Also here: `decode_step`
makes no host read and no copy to the device, the engines' decode route,
and `reset` zeroing the engines' one cache in place."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import TestArgs as InferArgs
from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import mmduet as jmm
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import BatchedStreamEngine, LiveInferEngine
from mmduet_tpu_torch.infer.state import decode_route
from mmduet_tpu_torch.models import init_lora, params_from_numpy, quant
from mmduet_tpu_torch.models import mmduet as tmm
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.ops import attention
from mmduet_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, ProcessMesh, make_mesh

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PCFG = config_from_dict(dataclasses.asdict(CFG))
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)
TP = params_from_numpy(NP, "cpu")
S, T_PROMPT = 64, 3  # cache slots, prompt tokens
LANES = {1: ([12], [True]),
         # a lane that runs, one that ends at its second token, a frozen one
         3: ([12, 5, 20], [True, True, False])}
STOPS = 1  # the lane of B = 3 that ends at its second token


def _inputs(B):
    r = np.random.RandomState(40 + B)
    t = CFG.text
    shape = (t.num_layers, B, t.num_kv_heads, S, t.head_dim)
    k = (r.randn(*shape) * 0.5).astype(np.float32)
    v = (r.randn(*shape) * 0.5).astype(np.float32)
    emb = r.randn(B, T_PROMPT, t.hidden_size).astype(np.float32)
    pen = np.zeros((B, t.vocab_size), bool)
    pen[:, [3, 70, 300]] = True
    return k, v, emb, pen


def _port(B, rep, max_new, eos, graphs=None):
    k, v, emb, pen = _inputs(B)
    cl, active = LANES[B]
    cache = tq.KVCache(torch.tensor(k), torch.tensor(v))
    packed, cache, mask = tmm.decode_loop(
        TP, PCFG, torch.tensor(emb), cache, cl, T_PROMPT, torch.tensor(pen), active,
        max_new=max_new, eos_id=eos, rep=rep, graphs=graphs)
    return packed.numpy(), cache, mask.numpy()


@functools.lru_cache(maxsize=None)
def _eos(B, rep):
    """An end-of-sequence id that lane `STOPS` samples as its second token
    (the port's dry run with none), or the config's for one lane."""
    if B == 1:
        return CFG.eos_token_id
    packed, _, _ = _port(B, rep, 6, -1)
    first, second = packed[STOPS, :2]
    assert first != second  # the case must end the lane at its second token
    return int(second)


@pytest.mark.parametrize("max_new", [1, 2, 6])
@pytest.mark.parametrize("rep", [None, 1.3], ids=["no_penalty", "penalty"])
@pytest.mark.parametrize("B", [1, 3], ids=["one_lane", "three_lanes"])
def test_device_decode_loop_matches_jax(B, rep, max_new):
    eos = _eos(B, rep)
    k, v, emb, pen = _inputs(B)
    cl, active = LANES[B]
    want, jcache, jmask = jmm.decode_loop(
        JP, CFG, jnp.asarray(emb), jq.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(cl, jnp.int32), jnp.int32(T_PROMPT), jnp.asarray(pen),
        jnp.asarray(active), max_new=max_new, eos_id=eos, rep=rep, use_flash=False)
    got, cache, mask = _port(B, rep, max_new, eos)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    if B == 3 and max_new > 1:
        assert got[STOPS, -2] == 2 and got[STOPS, 1] == eos  # it stopped at its second token
    for b, on in enumerate(active):
        for got_kv, want_kv, before in ((cache.k, jcache.k, k), (cache.v, jcache.v, v)):
            if on:
                np.testing.assert_allclose(got_kv[:, b].numpy(), np.asarray(want_kv)[:, b],
                                           atol=ATOL, rtol=0)
            else:  # a frozen lane commits nothing
                np.testing.assert_array_equal(got_kv[:, b].numpy(), before[:, b])


def _tripwire_case(kind):
    """(params, cache, lora, shard_ctx, B) of a tripwire case."""
    B = 2
    k, v, _, _ = _inputs(B)
    cache = tq.KVCache(torch.tensor(k), torch.tensor(v))
    params, lora, ctx = TP, None, None
    if kind == "int4_int8_lora":
        params = quant.quantize_params(params_from_numpy(NP, "cpu"), bits=4)
        cache = tq.init_kv_cache(PCFG.text, B, S, torch.float32, quant="int8")
        tq.commit_lanes(cache, torch.tensor(k[:, :, :, :20]), torch.tensor(v[:, :, :, :20]), 0)
        lora = init_lora(torch.Generator().manual_seed(3), PCFG.text, rank=4)
    elif kind == "one_device_mesh":
        mesh = make_mesh((2, 2), devices=["cpu"] * 4)
        ctx = attention.ShardCtx(mesh, lane_axis=DATA_AXIS, head_axis=MODEL_AXIS)
    return params, cache, lora, ctx, B


def _started_state(params, cache, lora, ctx, B, rep):
    """A `DecodeState` after a prompt's prefill and `start_decode`."""
    _, _, emb, pen = _inputs(B)
    out = tmm.step_forward(params, PCFG, torch.tensor(emb), cache, [12, 30], T_PROMPT,
                           lora=lora, lora_scale=0.5, shard_ctx=ctx)
    L, _, kh, _, hd = tq.kv_arr(cache.k).shape
    s = tmm.decode_state(B, 6, PCFG.text.vocab_size, (L, kh, hd), torch.float32, "cpu")
    s.base.copy_(torch.tensor([12 + T_PROMPT, 30 + T_PROMPT], dtype=torch.int32))
    s.active.fill_(True)
    s.eos.fill_(-1)
    s.pen_mask.copy_(torch.tensor(pen))
    tmm.start_decode(s, out.last_logits, rep)
    return s


def _raise(*args, **kw):
    raise AssertionError("decode_step read a tensor back to the host or made one from host data")


@pytest.mark.parametrize("kind", ["plain", "int4_int8_lora", "one_device_mesh"])
def test_decode_step_makes_no_host_read(kind, monkeypatch):
    params, cache, lora, ctx, B = _tripwire_case(kind)
    rep = 1.3
    tripped = _started_state(params, cache, lora, ctx, B, rep)
    free = tmm.DecodeState(*(x.clone() if torch.is_tensor(x) else
                             tq.KVCache(x.k.clone(), x.v.clone()) for x in tripped))

    def steps(s):
        for _ in range(3):
            tmm.decode_step(s, params, PCFG, cache, rep=rep, lora=lora, lora_scale=0.5,
                            shard_ctx=ctx)

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "cpu", "numpy", "pin_memory", "__int__",
                     "__float__", "__index__"):
            m.setattr(torch.Tensor, name, _raise)
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, _raise)
        m.setattr(tq, "ints_to", _raise)
        m.setattr(tq, "lane_list", _raise)
        steps(tripped)
    steps(free)
    for got, want in zip(tripped, free):
        for g, w in ((got.k, want.k), (got.v, want.v)) if isinstance(got, tq.KVCache) \
                else ((got, want),):
            assert torch.equal(g, w)
    assert int(tripped.i) == 4 and (tripped.n == 4).all()


def test_graph_route_needs_a_cuda_device():
    k, v, emb, pen = _inputs(1)
    cache = tq.KVCache(torch.tensor(k), torch.tensor(v))
    graphs = tmm.EngineGraphs()
    with pytest.raises(ValueError, match="CUDA device"):
        tmm.decode_loop(TP, PCFG, torch.tensor(emb), cache, 12, T_PROMPT, torch.tensor(pen),
                        max_new=4, eos_id=-1, graphs=graphs)
    assert len(graphs) == 0


@pytest.mark.parametrize("device, mesh, route", [
    ("cpu", None, "eager"),
    ("cuda", None, "graph"),
    ("cuda", "one_device", "graph"),
    ("cuda", "process", "eager"),
])
def test_decode_route(device, mesh, route):
    dev = torch.device(device)
    if mesh == "one_device":
        mesh = make_mesh((2, 2), devices=[dev] * 4)
    elif mesh == "process":
        mesh = ProcessMesh((1, 2), (0, 0), dev)
    assert decode_route(dev, mesh) == route


def _args(**kw):
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=4,
                repetition_penalty=1.05, max_num_frames=12, stream_end_prob_threshold=0.5,
                stream_end_score_sum_threshold=None, threshold_z=None)
    base.update(kw)
    return PortInferArgs(**dataclasses.asdict(InferArgs(**base)))


FRAMES = np.random.RandomState(0).randint(0, 256, (5, 32, 32, 3), dtype=np.uint8)
QUERY = [{"role": "user", "content": "what now?", "time": 1.0}]


def _cache_tensors(cache):
    return [t for leaf in cache for t in (leaf.values() if isinstance(leaf, dict) else (leaf,))]


def _live_session(engine):
    engine.input_video_stream(FRAMES)
    engine.input_query_stream(QUERY)
    resp = engine.inference()
    return resp, [d["informative_score"] for d in engine.debug_data_list], engine.state.cursor


EMBEDS = (np.random.RandomState(1).randn(2, 5, CFG.frame_num_tokens, CFG.text.hidden_size)
          * 0.05).astype(np.float32)


def _batched_session(engine):
    engine.input_frame_embeds(EMBEDS, lengths=np.array([5, 3]))
    engine.input_query_streams([QUERY, QUERY])
    return engine.stream_all(), engine.debug_data_lists, engine._cur.tolist()


@pytest.mark.parametrize("kv_cache_quant", [None, "int8"], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("which", ["live", "batched"])
def test_reset_zeros_the_engines_one_cache_in_place(which, kv_cache_quant):
    if which == "live":
        make = functools.partial(LiveInferEngine, TP, PCFG, TOK, _args(), kv_cache_size=512,
                                 kv_cache_quant=kv_cache_quant)
        session, cache_of = _live_session, (lambda e: e.state.kv_cache)
    else:
        make = functools.partial(BatchedStreamEngine, TP, PCFG, TOK, _args(), n_streams=2,
                                 block_frames=4, kv_cache_size=512, kv_cache_quant=kv_cache_quant)
        session, cache_of = _batched_session, (lambda e: e._cache)
    engine = make()
    assert engine.decode_route == "eager"
    first = session(engine)
    assert "'role': 'assistant'" in repr(first[0])  # the sessions generate
    before = _cache_tensors(cache_of(engine))
    assert any(bool(t.any()) for t in before)
    ptrs = [t.data_ptr() for t in before]
    engine.reset()
    after = _cache_tensors(cache_of(engine))
    assert [t.data_ptr() for t in after] == ptrs
    assert not any(bool(t.any()) for t in after)
    again = session(engine)
    assert again == first == session(make())


@pytest.mark.parametrize("engine, mesh", [("live", (1, 1)), ("batched", (1, 1)),
                                          ("batched", (2, 1))])
def test_memory_budget_prices_the_decode_state(engine, mesh):
    """`scripts/memory_budget_torch.py`'s decode state term is the bytes of
    the `decode_state` a decode makes: persistent on the graph route (one
    process), inside the decode step's moment on a rank of a process mesh."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import memory_budget_torch as mb

    lanes, max_new = (1 if engine == "live" else 4), 6
    est = mb.serving_budget(mb.Serving("tiny", PCFG, engine=engine, lanes=lanes, mesh=mesh,
                                       max_new=max_new))
    t = CFG.text
    state = tmm.decode_state(lanes // mesh[0], max_new, t.vocab_size,
                             (t.num_layers, t.num_kv_heads, t.head_dim), torch.bfloat16, "cpu")
    nbytes = sum(x.numel() * x.element_size() for f in state
                 for x in ((f.k, f.v) if isinstance(f, tq.KVCache) else (f,)))
    persistent = {n: b for n, b, _ in est.persistent}
    step = {n: b for n, b, _ in est.moments["decode step"]}
    held, other = (persistent, step) if mesh == (1, 1) else (step, persistent)
    assert held["decode state"] == nbytes and "decode state" not in other
