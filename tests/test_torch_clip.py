"""The port's CLIP tower (`mmduet_tpu_torch.models.clip`) and the CLIP arch
end to end, against the JAX package and HF `CLIPVisionModel` on a tiny
tower (32 wide, 2 layers, 32 px in patches of 8: a 4 x 4 grid).

f32 everywhere. Tolerances: the tower against HF and against the JAX
tower 2e-5 absolute / 1e-4 relative (`tests/test_hf_parity.py`'s; the
two frameworks sum in other orders); the pooling 1e-6 (cell means of
O(1) values); `visual_embed` and the engine's scores 1e-4 (the other port
tests' tolerance); converted leaves, responses, times and cursors exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmduet_tpu.config import ClipConfig as JaxClipConfig
from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import clip as jclip
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import mmduet as jmm
from mmduet_tpu.models.convert import convert_clip as jax_convert_clip
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import ClipConfig
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import clip as tclip
from mmduet_tpu_torch.models import init_clip_params, init_mmduet_params, params_from_numpy
from mmduet_tpu_torch.models import mmduet as tmm
from mmduet_tpu_torch.models.convert import convert_clip
from mmduet_tpu_torch.models.io import config_from_dict

TOWER = dict(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=2)
JCFG_V, TCFG_V = JaxClipConfig(**TOWER), ClipConfig(**TOWER)
ENC_TOL = dict(atol=2e-5, rtol=1e-4)
ATOL = 1e-4


def _hf_model():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8, layer_norm_eps=1e-5,
    )
    torch.manual_seed(3)
    return CLIPVisionModel(hf_cfg).eval()


MODEL = _hf_model()
SD = MODEL.state_dict()
JV = jax.tree.map(jnp.asarray, jax_convert_clip(SD, JCFG_V, prefix="vision_model."))
TV = convert_clip(SD, TCFG_V, prefix="vision_model.")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _pixels(seed, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3), np.uint8)


def test_convert_clip_leaves_equal_the_jax_converter():
    got, want = dict(_flat(TV)), dict(_flat(jax.tree.map(np.asarray, JV)))
    assert sorted(got) == sorted(want)
    assert "patch_bias" not in got and "post_ln_scale" in got  # kept, unused
    for name, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)


def test_normalize_pixels_is_the_jax_function():
    u8 = _pixels(0, 3)
    np.testing.assert_array_equal(tclip.normalize_pixels(torch.tensor(u8)).numpy(),
                                  np.asarray(jclip.normalize_pixels(jnp.asarray(u8))))


def test_quick_gelu_is_the_jax_function():
    x = np.random.RandomState(1).randn(64).astype(np.float32) * 4
    np.testing.assert_allclose(tclip.quick_gelu(torch.tensor(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))), atol=1e-6)


def test_clip_encode_matches_jax_and_hf():
    px = tclip.normalize_pixels(torch.tensor(_pixels(0)))
    got = tclip.clip_encode(TV, TCFG_V, px).numpy()
    with torch.no_grad():
        hf = MODEL(px.permute(0, 3, 1, 2)).last_hidden_state.numpy()
    jx = np.asarray(jclip.clip_encode(JV, JCFG_V, jnp.asarray(px.numpy())))
    assert got.shape == (2, 1 + TCFG_V.num_patches, 32)
    np.testing.assert_allclose(got, hf, **ENC_TOL)
    np.testing.assert_allclose(got, jx, **ENC_TOL)


@pytest.mark.parametrize("s,out", [(4, 3), (27, 7), (24, 7), (5, 5)])
def test_adaptive_pool_matches_jax_and_torch(s, out):
    x = np.random.RandomState(s).randn(2, s, s, 3).astype(np.float32)
    got = tclip.adaptive_avg_pool_grid(torch.tensor(x), (out, out)).numpy()
    want = F.adaptive_avg_pool2d(torch.tensor(x).permute(0, 3, 1, 2), (out, out))
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 1).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jclip.adaptive_avg_pool_grid(jnp.asarray(x), (out, out))), atol=1e-6)
    bf = tclip.adaptive_avg_pool_grid(torch.tensor(x).to(torch.bfloat16), (out, out))
    assert bf.dtype == torch.bfloat16


# (frame_token_cls, frame_token_pooled): both, the list config.json gives
# back, pooled only, CLS only
STANDALONE = [(True, (2, 2)), (True, [3, 3]), (False, (2, 2)), (True, None)]


@pytest.mark.parametrize("cls,pooled", STANDALONE, ids=str)
def test_standalone_encode_matches_jax(cls, pooled):
    px = tclip.normalize_pixels(torch.tensor(_pixels(1)))
    got = tclip.standalone_encode(TV, TCFG_V, px, cls, pooled).numpy()
    want = np.asarray(jclip.standalone_encode(JV, JCFG_V, jnp.asarray(px.numpy()), cls,
                                              tuple(pooled) if pooled else None))
    n_tok = int(cls) + (int(np.prod(pooled)) if pooled else 0)
    assert got.shape == (2, n_tok, 32)
    np.testing.assert_allclose(got, want, **ENC_TOL)
    with pytest.raises(ValueError, match="frame_token_cls"):
        tclip.standalone_encode(TV, TCFG_V, px, False, None)


def _clip_cfg(jax_side: bool = True):
    cfg = tiny_config(frame_num_tokens=5).replace(
        vision_arch="clip", frame_token_cls=True, frame_token_pooled=(2, 2),
        v_placeholder_id=511, eos_token_id=257, vision=JCFG_V)
    return cfg if jax_side else config_from_dict(dataclasses.asdict(cfg))


JCFG = _clip_cfg()
JP = dict(jax_init(jax.random.PRNGKey(0), JCFG), vision=JV)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")


def test_visual_embed_clip_arch_matches_jax_in_values():
    tcfg = _clip_cfg(jax_side=False)
    u8 = _pixels(2, 3)
    tpx = tmm.normalize_pixels(tcfg, torch.tensor(u8))
    jpx = jmm.normalize_pixels(JCFG, jnp.asarray(u8))
    np.testing.assert_array_equal(tpx.numpy(), np.asarray(jpx))
    got = tmm.visual_embed(TP, tcfg, tpx).numpy()
    want = np.asarray(jmm.visual_embed(JP, JCFG, jpx))
    assert got.shape == (3, 5, JCFG.text.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="tokens/frame"):
        tmm.visual_embed(TP, tcfg.replace(frame_num_tokens=4), tpx)


def test_init_clip_params_has_the_jax_structure():
    want = dict(_flat(jax.tree.map(np.asarray, jclip.init_clip_params(
        jax.random.PRNGKey(0), JCFG_V))))
    got = dict(_flat(init_clip_params(TCFG_V, torch.Generator().manual_seed(0), "cpu")))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert leaf.dtype == torch.float32
    for name in ("pre_ln_scale", "post_ln_scale"):
        assert bool((got[name] == 1).all())
    # the scales of the JAX init: dense N(0, 1/fan_in), embeddings N(0, 0.02^2)
    assert abs(got["layers/fc1"].std().item() - 32 ** -0.5) < 0.03
    assert abs(got["pos_embed"].std().item() - 0.02) < 0.01


def test_init_mmduet_params_builds_a_clip_tower_where_the_jax_tree_cannot_run():
    """A deliberate difference: the JAX `init_mmduet_params` builds a
    SigLIP-shaped tower whatever the arch, and its own CLIP `visual_embed`
    then fails on it; the port builds the CLIP tree, which runs."""
    tcfg = _clip_cfg(jax_side=False)
    tp = init_mmduet_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    structure = {k: tuple(v.shape) for k, v in _flat(tp["vision"])}
    assert structure == {k: tuple(v.shape) for k, v in _flat(TV)}
    u8 = torch.tensor(_pixels(3))
    out = tmm.visual_embed(tp, tcfg, tmm.normalize_pixels(tcfg, u8))
    assert out.shape == (2, 5, tcfg.text.hidden_size) and bool(torch.isfinite(out).all())

    jp = jax_init(jax.random.PRNGKey(0), JCFG)
    assert "class_embed" not in jp["vision"] and "patch_bias" in jp["vision"]
    with pytest.raises(KeyError, match="class_embed"):
        jmm.visual_embed(jp, JCFG, jmm.normalize_pixels(JCFG, jnp.asarray(u8.numpy())))


TOK = CharTokenizer(frame_num_tokens=5)
FRAMES = np.random.RandomState(4).randint(0, 256, (8, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("grounding", [False, True], ids=["generation", "grounding"])
def test_clip_arch_engine_matches_jax(grounding):
    """The slice as a whole: the CLIP-arch model streams 8 frames with two
    queries through both packages' `LiveInferEngine` (the port's after
    `prewarm(vision=True)`, which encodes at the model's frame size)."""
    args = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=6, max_num_frames=16,
                stream_end_prob_threshold=0.5, grounding_mode=grounding)
    je = JaxEngine(JP, JCFG, TOK, InferArgs(**args), kv_cache_size=512, block_frames=4)
    te = LiveInferEngine(TP, _clip_cfg(jax_side=False), TOK, PortInferArgs(**args),
                         kv_cache_size=512, block_frames=4)
    te.prewarm(vision=True)
    out = []
    for engine in (je, te):
        engine.input_video_stream(FRAMES)
        engine.input_query_stream([{"role": "user", "content": q, "time": t}
                                   for t, q in ((0.0, "what?"), (1.6, "now?"))])
        out.append(engine.inference())
    assert out[1] == out[0]
    assert any(r["role"] == "assistant" for r in out[1]) != grounding
    assert [d["time"] for d in te.debug_data_list] == [d["time"] for d in je.debug_data_list]
    for key in ("informative_score", "relevance_score"):
        np.testing.assert_allclose([d[key] for d in te.debug_data_list],
                                   [d[key] for d in je.debug_data_list], atol=ATOL, rtol=0)
    assert te.state.cursor == je.state.cursor
    assert te._next_frame == je._next_frame == len(FRAMES)
