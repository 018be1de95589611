"""Kernel A' of the port on the CPU: `flash_decode_attention_sharded` runs
the plain version per (lane shard, head shard) and equals the unsharded
call exactly; `ShardCtx` / `shard_ctx_ok` / `make_mesh` behave as the JAX
package's; and the model-level forwards with ``shard_ctx`` agree with the
JAX functions (the Pallas kernel under `shard_map` in interpret mode, or
the jnp attention) on the same numpy inputs, f32, atol 1e-4 (summation
order only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmduet_tpu.ops.attention as jatt
from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import mmduet as jmmduet
from mmduet_tpu.models import qwen2 as jqwen2
from mmduet_tpu.parallel import make_mesh as jax_make_mesh
from mmduet_tpu_torch.models import mmduet, params_from_numpy, qwen2
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.ops import attention
from mmduet_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh, serving_shard_ctx

ATOL = 1e-4
MESHES = [(2, 2), (1, 4), (4, 1), (8, 1), (2, 1), (1, 2)]


def port_ctx(shape):
    mesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
    return attention.ShardCtx(mesh, lane_axis=DATA_AXIS if shape[0] > 1 else None,
                              head_axis=MODEL_AXIS if shape[1] > 1 else None)


def _operands(seed, B=8, T=5, nh=8, kh=4, hd=16, L=2, S=48, Tc=9, dtype=torch.float32):
    r = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)

    q, kc, vc = t(B, T, nh, hd), t(L, B, kh, S, hd), t(L, B, kh, S, hd)
    ck, cv = t(B, kh, Tc, hd), t(B, kh, Tc, hd)
    cl = torch.from_numpy(r.randint(0, S + 1, B).astype(np.int32))
    tr = torch.from_numpy(r.randint(1, T + 1, B).astype(np.int32))
    return q, kc, vc, ck, cv, cl, tr


@pytest.mark.parametrize("quantized", [False, True], ids=["dense_cache", "int8_cache"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_sharded_equals_unsharded_exactly(shape, quantized):
    q, kc, vc, ck, cv, cl, tr = _operands(sum(shape))
    scales = {}
    if quantized:
        (kc, ks), (vc, vs) = qwen2.quantize_kv_rows(kc), qwen2.quantize_kv_rows(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    qo = torch.full((8,), 3, dtype=torch.int32)
    tr = tr + 3  # the chunk holds 3 earlier tokens before the queries
    one = attention.flash_decode_attention(q, kc, vc, ck, cv, cl, tr, 1, q_offset=qo, **scales)
    got = attention.flash_decode_attention_sharded(q, kc, vc, ck, cv, cl, tr, 1, port_ctx(shape),
                                                   q_offset=qo, **scales)
    assert torch.equal(got, one)
    # lanes fed another shard's cursors do not pass
    if shape[0] > 1:
        wrong = attention.flash_decode_attention_sharded(
            q, kc, vc, ck, cv, cl.roll(8 // shape[0]), tr, 1, port_ctx(shape), q_offset=qo,
            **scales)
        assert not torch.equal(wrong, one)


def test_sharded_refuses_a_mesh_that_does_not_divide():
    q, kc, vc, ck, cv, cl, tr = _operands(0, B=3, nh=6, kh=3)
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="do not divide"):
            attention.flash_decode_attention_sharded(q, kc, vc, ck, cv, cl, tr, 0,
                                                     port_ctx(shape))
    ctx = port_ctx((3, 3))
    assert torch.equal(
        attention.flash_decode_attention_sharded(q, kc, vc, ck, cv, cl, tr, 0, ctx),
        attention.flash_decode_attention(q, kc, vc, ck, cv, cl, tr, 0))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 4), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_ctx_ok_and_mesh_equal_the_jax_package(shape):
    n = shape[0] * shape[1]
    jmesh = jax_make_mesh(shape, devices=jax.devices()[:n])
    tmesh = make_mesh(shape, devices=["cpu"] * n)
    assert dict(tmesh.shape) == dict(jmesh.shape) and tmesh.size == jmesh.size
    for lane_axis in (None, "data"):
        for head_axis in (None, "model"):
            jctx = jatt.ShardCtx(jmesh, lane_axis, head_axis)
            tctx = attention.ShardCtx(tmesh, lane_axis, head_axis)
            for nh, kh, lanes in ((28, 4, 8), (28, 4, 3), (4, 2, 4), (6, 3, 2), (8, 8, 1),
                                  (28, 4, 1), (12, 2, 6)):
                assert (attention.shard_ctx_ok(tctx, nh, kh, lanes)
                        == jatt.shard_ctx_ok(jctx, nh, kh, lanes)), (lane_axis, head_axis, nh, kh)
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 2), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh shape"):
        jax_make_mesh((2, 2), devices=jax.devices()[:3])
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """With no ``devices`` the mesh is the current CUDA device's; without
    one it raises, and the CPU is taken only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1))
    mesh = make_mesh(devices=["cpu"])
    assert mesh.device == torch.device("cpu") and mesh.shape == {"data": 1, "model": 1}


def test_serving_shard_ctx_follows_the_engines_rule():
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    ctx = serving_shard_ctx(mesh, 28, 4, 8, "cpu")
    assert (ctx.lane_axis, ctx.head_axis) == ("data", "model")
    # lanes the data axis does not divide stay whole; a single stream cuts heads only
    assert serving_shard_ctx(mesh, 28, 4, 3, "cpu").lane_axis is None
    assert serving_shard_ctx(mesh, 28, 4, 1, "cpu") == attention.ShardCtx(mesh, None, "model")
    assert serving_shard_ctx(None, 28, 4, 8, "cpu") is None
    assert serving_shard_ctx(make_mesh((1, 1), devices=["cpu"]), 28, 4, 8, "cpu") is None
    with pytest.raises(ValueError, match="do not divide"):
        serving_shard_ctx(make_mesh((1, 8), devices=["cpu"] * 8), 28, 4, 8, "cpu")
    with pytest.raises(ValueError, match="mesh on"):
        serving_shard_ctx(mesh, 28, 4, 8, "meta")


# ---------------------------------------------------------------------------
# model-level forwards with shard_ctx against the JAX functions
# ---------------------------------------------------------------------------

# head_dim 128: the width the Pallas kernel takes
FCFG = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
FJP = jax_init(jax.random.PRNGKey(1), FCFG)
FTP = params_from_numpy(jax.tree.map(np.asarray, FJP), "cpu")
FPCFG = config_from_dict(dataclasses.asdict(FCFG))


@pytest.mark.parametrize("jax_route", ["pallas_interpret_under_shard_map", "jnp"])
def test_chunk_scores_forward_sharded_matches_jax(jax_route, monkeypatch):
    B, T, S = 4, 12, 1024
    r = np.random.RandomState(31)
    embeds = (r.randn(B, T, FCFG.text.hidden_size) * 0.05).astype(np.float32)
    cl, tr = [0, 37, 256, 700], [12, 7, 1, 12]
    pos = [[3, 7], [5, 6], [0, 0], [2, 11]]
    jcache = jqwen2.init_kv_cache(FCFG.text, B, S, dtype=jnp.float32)
    if jax_route == "jnp":
        jkw = dict(use_flash=False)
    else:
        monkeypatch.setattr(jatt, "_FORCE_INTERPRET", True)
        jmesh = jax_make_mesh((2, 2), devices=jax.devices()[:4])
        jkw = dict(use_flash=True, shard_ctx=jatt.ShardCtx(jmesh, "data", "model"))
    want, want_cache = jmmduet.chunk_scores_forward(
        FJP, FCFG, jnp.asarray(embeds), jcache, jnp.asarray(cl, jnp.int32),
        jnp.asarray(tr, jnp.int32), jnp.asarray(pos, jnp.int32), **jkw)
    cache = qwen2.init_kv_cache(FPCFG.text, B, S, dtype=torch.float32)
    plain, _ = mmduet.chunk_scores_forward(
        FTP, FPCFG, torch.from_numpy(embeds), cache, cl, tr, pos)
    cache = qwen2.init_kv_cache(FPCFG.text, B, S, dtype=torch.float32)
    got, cache = mmduet.chunk_scores_forward(
        FTP, FPCFG, torch.from_numpy(embeds), cache, cl, tr, pos, shard_ctx=port_ctx((2, 2)))
    assert got.shape == (B, 2, 2) and torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for b in range(B):
        np.testing.assert_allclose(
            cache.k[:, b, :, cl[b]:cl[b] + tr[b]].numpy(),
            np.asarray(want_cache.k)[:, b, :, cl[b]:cl[b] + tr[b]], atol=ATOL, rtol=0)
    # a 1-D score_pos is shared by the lanes, as in the JAX function
    cache = qwen2.init_kv_cache(FPCFG.text, B, S, dtype=torch.float32)
    shared, _ = mmduet.chunk_scores_forward(
        FTP, FPCFG, torch.from_numpy(embeds), cache, cl, T, [0, 5, 11])
    assert shared.shape == (B, 2, 3)


def test_chunk_scores_forward_commits_only_the_lanes_asked():
    B, T, S = 4, 6, 64
    r = np.random.RandomState(2)
    embeds = torch.from_numpy((r.randn(B, T, FCFG.text.hidden_size) * 0.05).astype(np.float32))
    cache = qwen2.init_kv_cache(FPCFG.text, B, S, dtype=torch.float32)
    # lane 2 sits at the end of its cache: a write would not fit, none is made
    mmduet.chunk_scores_forward(FTP, FPCFG, embeds, cache, [0, 5, S - 1, 9], T, [T - 1],
                                commit=[True, False, False, True])
    written = cache.k.abs().amax(dim=(0, 2, 4)) > 0  # (B, S)
    assert written[0, :T].all() and written[3, 9:9 + T].all()
    assert not written[1].any() and not written[2].any()
    with pytest.raises(RuntimeError, match="outside the cache"):
        mmduet.chunk_scores_forward(FTP, FPCFG, embeds, cache, [0, 5, S - 1, 9], T, [T - 1])


def test_decode_loop_sharded_matches_jax():
    B, t, S = 2, 4, 1024
    r = np.random.RandomState(33)
    embeds = (r.randn(B, t, FCFG.text.hidden_size) * 0.05).astype(np.float32)
    cl = [11, 96]
    jcache = jqwen2.init_kv_cache(FCFG.text, B, S, dtype=jnp.float32)
    want, _, _ = jmmduet.decode_loop(
        FJP, FCFG, jnp.asarray(embeds), jcache, jnp.asarray(cl, jnp.int32), jnp.int32(t),
        jnp.zeros((B, FCFG.text.vocab_size), bool), jnp.ones((B,), bool),
        max_new=5, eos_id=-1, rep=1.1, use_flash=False)
    outs = []
    for ctx in (None, port_ctx((2, 2))):
        cache = qwen2.init_kv_cache(FPCFG.text, B, S, dtype=torch.float32)
        got, cache, _ = mmduet.decode_loop(
            FTP, FPCFG, torch.from_numpy(embeds), cache, cl, t,
            torch.zeros((B, FCFG.text.vocab_size), dtype=torch.bool), [True, True],
            max_new=5, eos_id=-1, rep=1.1, shard_ctx=ctx)
        outs.append((got, cache.k))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[1][0].numpy(), np.asarray(want))
