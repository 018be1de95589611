"""The port's model functions (`mmduet_tpu_torch.models`) against the JAX
package on `tiny_config()`: one numpy parameter tree and numpy inputs
from a seed feed both.

f32 on both sides, so hidden states and probabilities agree to
atol=1e-4 (summation order only); greedy token ids must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import mmduet as jmm
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu.models import siglip as jsig
from mmduet_tpu_torch.models import init_mmduet_params, params_from_numpy
from mmduet_tpu_torch.models import mmduet as tmm
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.models import siglip as tsig

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)
TP = params_from_numpy(NP, "cpu")
S = 64  # cache slots


def _rng(seed):
    return np.random.RandomState(seed)


def _cache(seed, B=1):
    """A cache whose first slots hold history and the rest zeros."""
    t = CFG.text
    shape = (t.num_layers, B, t.num_kv_heads, S, t.head_dim)
    k = (_rng(seed).randn(*shape) * 0.5).astype(np.float32)
    v = (_rng(seed + 1).randn(*shape) * 0.5).astype(np.float32)
    return k, v


def _jcache(k, v):
    return jq.KVCache(jnp.asarray(k), jnp.asarray(v))


def _tcache(k, v):
    return tq.KVCache(torch.tensor(k), torch.tensor(v))


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# qwen2
# ---------------------------------------------------------------------------


def test_qwen2_streaming_forward_and_commit():
    B, T = 2, 8
    cl, tr = np.array([5, 20], np.int32), np.array([8, 3], np.int32)
    emb = _rng(1).randn(B, T, CFG.text.hidden_size).astype(np.float32)
    pos = cl[:, None] + np.arange(T)[None]
    k, v = _cache(2, B)
    jh, jc = jq.qwen2_forward(
        JP["decoder"], CFG.text, jnp.asarray(emb), jnp.asarray(pos),
        kv_cache=_jcache(k, v), cache_len=jnp.asarray(cl), t_real=jnp.asarray(tr),
        use_flash=False,
    )
    th, tc = tq.qwen2_forward(
        TP["decoder"], CFG.text, torch.tensor(emb), torch.tensor(pos),
        kv_cache=_tcache(k, v), cache_len=cl.tolist(), t_real=tr.tolist(),
    )
    for b in range(B):
        _close(th[b, : tr[b]], jh[b, : tr[b]])
    # the whole bucket-wide chunk is committed at each lane's cursor
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def test_qwen2_scratch_decode_mode():
    B, s_len, W = 1, 2, 5
    k, v = _cache(3, B)
    sk, sv = (x[:, :, :, :W].copy() for x in _cache(4, B))
    emb = _rng(5).randn(B, 1, CFG.text.hidden_size).astype(np.float32)
    base = 30
    pos = np.array([[base + s_len]])
    jh, js = jq.qwen2_forward(
        JP["decoder"], CFG.text, jnp.asarray(emb), jnp.asarray(pos),
        kv_cache=_jcache(k, v), cache_len=jnp.asarray([base], jnp.int32),
        t_real=jnp.int32(1), use_flash=False, scratch=_jcache(sk, sv),
        scratch_len=jnp.int32(s_len),
    )
    th, ts = tq.qwen2_forward(
        TP["decoder"], CFG.text, torch.tensor(emb), torch.tensor(pos),
        kv_cache=_tcache(k, v), cache_len=[base], t_real=1,
        scratch=_tcache(sk, sv), scratch_len=s_len,
    )
    _close(th, jh)
    _close(ts.k, js.k)
    _close(ts.v, js.v)


def test_commit_lanes_per_lane_starts():
    k, v = _cache(6, B=3)
    t = CFG.text
    new = _rng(7).randn(t.num_layers, 3, t.num_kv_heads, 4, t.head_dim).astype(np.float32)
    starts = np.array([0, 17, 60], np.int32)
    jc = jq.commit_lanes(_jcache(k, v), jnp.asarray(new), jnp.asarray(-new),
                         jnp.asarray(starts))
    tc = tq.commit_lanes(_tcache(k, v), torch.tensor(new), torch.tensor(-new),
                         starts.tolist())
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    with pytest.raises(RuntimeError, match="outside the cache"):
        tq.commit_lanes(tc, torch.tensor(new), torch.tensor(new), [0, 0, 61])


def test_qwen2_unported_modes_raise():
    emb = torch.zeros((1, 4, CFG.text.hidden_size))
    pos = torch.arange(4)[None]
    k, v = _cache(8)
    # quantized leaves and the int8 cache are ported (tests/test_torch_quant.py,
    # tests/test_torch_kv_quant.py); what still raises:
    with pytest.raises(ValueError, match="attn_mask"):
        tq.qwen2_forward(TP["decoder"], CFG.text, emb, pos, kv_cache=_tcache(k, v),
                         cache_len=0, attn_mask=torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown KV cache quant"):
        tq.init_kv_cache(CFG.text, 1, 8, quant="int4")
    with pytest.raises(NotImplementedError, match="CLIP"):
        init_mmduet_params(CFG.replace(vision_arch="clip"), torch.Generator(), "cpu")


def test_embed_tokens_clamps_placeholder_and_lm_logits():
    ids = np.array([[0, 5, 511, 600]], np.int32)  # 600 >= vocab: clamped
    _close(tq.embed_tokens(TP["decoder"], torch.tensor(ids), 512),
           jq.embed_tokens(JP["decoder"], jnp.asarray(ids), 512))
    hid = _rng(9).randn(1, 2, CFG.text.hidden_size).astype(np.float32)
    got = tq.lm_logits(TP["lm_head"], torch.tensor(hid))
    assert got.dtype == torch.float32
    _close(got, jq.lm_logits(JP["lm_head"], jnp.asarray(hid)))


# ---------------------------------------------------------------------------
# vision path
# ---------------------------------------------------------------------------


def test_siglip_encode_and_project():
    px = _rng(10).uniform(-1, 1, (3, 33, 35, 3)).astype(np.float32)  # cropped
    jf = jsig.siglip_encode(JP["vision"], CFG.vision, jnp.asarray(px))
    tf = tsig.siglip_encode(TP["vision"], CFG.vision, torch.tensor(px))
    _close(tf, jf)
    _close(tmm.project(TP, tf), jmm.project(JP, jf))


def test_normalize_pixels():
    u8 = _rng(11).randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    _close(tmm.normalize_pixels(CFG, torch.tensor(u8)),
           jmm.normalize_pixels(CFG, jnp.asarray(u8)), atol=0)


# (mode, patch grid side, stride, frame_num_tokens): the tiny grid, the
# so400m 27x27 grid at its stride 4 (bilinear ceils to 7x7, the pools
# floor to 6x6), and an odd grid
POOL_CASES = [
    ("bilinear", 4, 2, 4), ("average", 4, 2, 4), ("max", 4, 2, 4),
    ("bilinear", 27, 4, 49), ("average", 27, 4, 36), ("max", 27, 4, 36),
    ("bilinear", 9, 2, 25),
]


@pytest.mark.parametrize("mode,side,stride,ft", POOL_CASES)
def test_spatial_pool_modes(mode, side, stride, ft):
    cfg = CFG.replace(spatial_pool_mode=mode, video_pooling_stride=stride,
                      frame_num_tokens=ft)
    feats = _rng(side).randn(2, side * side, 6).astype(np.float32)
    _close(tmm.spatial_pool(torch.tensor(feats), cfg),
           jmm.spatial_pool(jnp.asarray(feats), cfg), atol=1e-5)


def test_spatial_pool_bilinear_is_jax_image_resize():
    feats = _rng(12).randn(1, 27 * 27, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(feats).reshape(1, 27, 27, 3), (1, 7, 7, 3),
                            method="bilinear", antialias=False)
    cfg = CFG.replace(video_pooling_stride=4, frame_num_tokens=49)
    _close(tmm.spatial_pool(torch.tensor(feats), cfg), np.asarray(want).reshape(1, 49, 3),
           atol=1e-5)


def test_visual_embed():
    px = _rng(13).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    _close(tmm.visual_embed(TP, CFG, torch.tensor(px)),
           jmm.visual_embed(JP, CFG, jnp.asarray(px)))
    with pytest.raises(NotImplementedError):
        tmm.visual_embed(TP, CFG.replace(vision_arch="clip"), torch.tensor(px))


def test_joint_embed():
    ids = np.array([[1, 511, 511, 2, 3], [511, 4, 511, 5, 6]], np.int32)
    frames = _rng(14).randn(1, 4, CFG.text.hidden_size).astype(np.float32)
    _close(tmm.joint_embed(TP, CFG, torch.tensor(ids), torch.tensor(frames)),
           jmm.joint_embed(JP, CFG, jnp.asarray(ids), jnp.asarray(frames)), atol=0)
    _close(tmm.joint_embed(TP, CFG, torch.tensor(ids), None),
           jmm.joint_embed(JP, CFG, jnp.asarray(ids), None), atol=0)


# ---------------------------------------------------------------------------
# streaming forwards
# ---------------------------------------------------------------------------


def test_step_forward_scores_and_logits():
    emb = _rng(15).randn(1, 16, CFG.text.hidden_size).astype(np.float32)
    k, v = _cache(16)
    jo = jmm.step_forward(JP, CFG, jnp.asarray(emb), _jcache(k, v), jnp.int32(9),
                          jnp.int32(11), use_flash=False)
    to = tmm.step_forward(TP, CFG, torch.tensor(emb), _tcache(k, v), 9, 11)
    _close(to.informative_prob, jo.informative_prob)
    _close(to.relevance_prob, jo.relevance_prob)
    _close(to.last_logits, jo.last_logits)
    _close(to.kv_cache.k, jo.kv_cache.k)


def test_frames_block_forward_equals_jax():
    frames = _rng(17).randn(3, CFG.frame_num_tokens, CFG.text.hidden_size).astype(np.float32)
    k, v = _cache(18)
    ji, jr, jc = jmm.frames_block_forward(JP, CFG, jnp.asarray(frames), _jcache(k, v),
                                          jnp.int32(20), use_flash=False)
    ti, tr, tc = tmm.frames_block_forward(TP, CFG, torch.tensor(frames), _tcache(k, v), 20)
    _close(ti, ji)
    _close(tr, jr)
    _close(tc.v, jc.v)


@pytest.mark.parametrize("rep", [None, 1.3])
def test_decode_loop(rep):
    max_new, eos = 6, CFG.eos_token_id
    emb = _rng(19).randn(1, 4, CFG.text.hidden_size).astype(np.float32)
    k, v = _cache(20)
    pen = np.zeros((1, CFG.text.vocab_size), bool)
    pen[0, [3, 70, 300]] = True
    jp_, jc, jm = jmm.decode_loop(
        JP, CFG, jnp.asarray(emb), _jcache(k, v), jnp.int32(12), jnp.int32(3),
        jnp.asarray(pen), max_new=max_new, eos_id=eos, rep=rep, use_flash=False)
    tp_, tc, tm = tmm.decode_loop(
        TP, CFG, torch.tensor(emb), _tcache(k, v), 12, 3, torch.tensor(pen),
        max_new=max_new, eos_id=eos, rep=rep)
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def test_init_mmduet_params_matches_jax_tree():
    tp = init_mmduet_params(CFG, torch.Generator().manual_seed(0), "cpu")
    j_leaves = jax.tree_util.tree_flatten_with_path(NP)[0]
    t_flat = {}

    def walk(tree, prefix=()):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, prefix + (name,))
            else:
                t_flat[prefix + (name,)] = leaf

    walk(tp)
    j_flat = {tuple(p.key for p in path): leaf for path, leaf in j_leaves}
    assert set(t_flat) == set(j_flat)
    for key, leaf in j_flat.items():
        assert tuple(t_flat[key].shape) == leaf.shape, key
        # same init family: norms/biases exact, random leaves at the same scale
        np.testing.assert_allclose(t_flat[key].std().item(), leaf.std(), rtol=0.25,
                                   err_msg=str(key))
