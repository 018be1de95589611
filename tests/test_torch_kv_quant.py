"""The port's int8 KV cache and quantized serving against the JAX package
on the CPU: one numpy tree and numpy inputs from a seed feed both.

- `quantize_kv_rows` and the quantizing `commit_lanes` give the JAX
  package's bits;
- `flash_decode_attention_ref` with scales is held against the Pallas
  kernel in interpret mode on f32 inputs to atol 1e-4 (both scale the
  int8 values' f32 products by columns; only the order of sums differs).
  The JAX package's own tests compare that kernel with a dequantized
  cache at 4e-3 / 2e-2; that looser bound is not needed here;
- the engine with ``kv_cache_quant="int8"``, with int8 / int4 weights and
  with a runtime LoRA adapter matches the JAX `LiveInferEngine`: scores to
  1e-4, equal responses, times and cursors;
- the CLI serves a quantized checkpoint directory of the port
  (``--checkpoint``, ``--kv_cache_quant int8``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import TestArgs as InferArgs, tiny_config
from mmduet_tpu.infer import LiveInferEngine as JaxEngine
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models import quant as jquant
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu.ops.attention import flash_decode_attention as pallas_flash_decode
from mmduet_tpu.stream import CharTokenizer
from mmduet_tpu_torch.config import TestArgs as PortInferArgs
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import io as tio
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models import quant as tquant
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.ops import attention as tatt
from test_bpe_tokenizer import build_qwen2_style_tokenizer

ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TOK = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)
FRAMES = np.random.RandomState(0).randint(0, 256, (10, 32, 32, 3), dtype=np.uint8)


def _rng(seed):
    return np.random.RandomState(seed)


def port_cfg(cfg):
    return tio.config_from_dict(dataclasses.asdict(cfg))


def _rows(shape, seed):
    x = (_rng(seed).randn(*shape) * 0.7).astype(np.float32)
    x[..., 1, :] = 0.0  # a zero row
    x[..., 2, :] = np.round(x[..., 2, :] * 8) / 8  # ties
    return x


# ---------------------------------------------------------------------------
# quantize at commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bit_equal(dtype):
    x = _rows((2, 3, 2, 5, 16), 1)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    (tqw, tqs), (jqw, jqs) = tq.quantize_kv_rows(tx), jq.quantize_kv_rows(jx)
    assert tqw.dtype == torch.int8 and tqs.dtype == torch.float32
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))
    assert np.all(tqw.numpy()[..., 1, :] == 0) and np.all(np.isfinite(tqs.numpy()))
    leaf = {"qw": tqw, "qs": tqs}
    np.testing.assert_array_equal(
        tq.dequantize_kv(leaf).numpy(), np.asarray(jq.dequantize_kv({"qw": jqw, "qs": jqs})))
    assert tq.dequantize_kv(tx, torch.float32).dtype == torch.float32


def test_init_kv_cache_int8_and_commit_lanes_bit_equal():
    t = CFG.text
    tc = tq.init_kv_cache(port_cfg(CFG).text, 3, 64, quant="int8")
    jc = jq.init_kv_cache(t, 3, 64, quant="int8")
    assert tq.kv_quantized(tc) and tc.max_len == 64
    for leaf, jleaf in ((tc.k, jc.k), (tc.v, jc.v)):
        assert leaf["qw"].dtype == torch.int8 and leaf["qs"].dtype == torch.float32
        assert tuple(leaf["qw"].shape) == tuple(jleaf["qw"].shape)
        assert tuple(leaf["qs"].shape) == tuple(jleaf["qs"].shape)
    assert tq.kv_arr(tc.k) is tc.k["qw"]
    dense = tq.init_kv_cache(port_cfg(CFG).text, 1, 8, torch.float32)
    assert not tq.kv_quantized(dense) and tq.kv_arr(dense.k) is dense.k
    new_k = _rows((t.num_layers, 3, t.num_kv_heads, 4, t.head_dim), 7)
    new_v = -0.5 * new_k[::-1].copy()
    starts = np.array([0, 17, 60], np.int32)
    for _ in range(2):  # a second commit overwrites in place
        jc = jq.commit_lanes(jc, jnp.asarray(new_k), jnp.asarray(new_v), jnp.asarray(starts))
        out = tq.commit_lanes(tc, torch.tensor(new_k), torch.tensor(new_v), starts.tolist())
        assert out.k["qw"] is tc.k["qw"]  # in place
        for leaf, jleaf in ((out.k, jc.k), (out.v, jc.v)):
            np.testing.assert_array_equal(leaf["qw"].numpy(), np.asarray(jleaf["qw"]))
            np.testing.assert_array_equal(leaf["qs"].numpy(), np.asarray(jleaf["qs"]))
        starts = starts - np.array([0, 2, 1], np.int32)
    with pytest.raises(RuntimeError, match="outside the cache"):
        tq.commit_lanes(tc, torch.tensor(new_k), torch.tensor(new_v), [0, 0, 61])


# ---------------------------------------------------------------------------
# the plain int8 attention against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _attn_inputs(T, nh, kh, hd, S, L=1, B=1, seed=0, Tc=None):
    r = _rng(seed)
    q = (r.randn(B, T, nh, hd) * 0.1).astype(np.float32)
    k = (r.randn(L, B, kh, S, hd) * 0.1).astype(np.float32)
    v = (r.randn(L, B, kh, S, hd) * 0.1).astype(np.float32)
    ck = (r.randn(B, kh, Tc or T, hd) * 0.1).astype(np.float32)
    cv = (r.randn(B, kh, Tc or T, hd) * 0.1).astype(np.float32)
    return q, k, v, ck, cv


def _both(q, k, v, ck, cv, cl, tr, layer, q_off=None):
    """(port plain version, Pallas interpret) on the same int8 cache."""
    (kq, ks), (vq, vs) = tq.quantize_kv_rows(torch.tensor(k)), tq.quantize_kv_rows(torch.tensor(v))
    ints = lambda x: None if x is None else torch.tensor(x, dtype=torch.int32)  # noqa: E731
    before = tatt.LAUNCHES, tatt.INT8_LAUNCHES
    got = tatt.flash_decode_attention(
        torch.tensor(q), kq, vq, torch.tensor(ck), torch.tensor(cv), ints(cl), ints(tr), layer,
        q_offset=ints(q_off), k_scale=ks, v_scale=vs)
    assert (tatt.LAUNCHES, tatt.INT8_LAUNCHES) == before  # CPU tensors: the plain version
    jint = lambda x: None if x is None else jnp.asarray(x, jnp.int32)  # noqa: E731
    want = pallas_flash_decode(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(ck),
        jnp.asarray(cv), jint(cl), jint(tr), jnp.int32(layer), q_offset=jint(q_off),
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()), interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cache_len,t_real", [(0, 8), (700, 8), (2047, 3)])
def test_int8_plain_attention_matches_pallas_interpret(cache_len, t_real):
    got, want = _both(*_attn_inputs(8, 4, 2, 128, 2048), [cache_len], [t_real], 0)
    np.testing.assert_allclose(got[0, :t_real], want[0, :t_real], atol=ATOL, rtol=0)


def test_int8_plain_attention_per_lane_cursors_and_layers():
    inputs = _attn_inputs(4, 4, 2, 128, 2048, L=3, B=3, seed=7)
    cl, tr = [0, 512, 1999], [4, 2, 4]
    for layer in (0, 2):
        got, want = _both(*inputs, cl, tr, layer)
        for b in range(3):
            np.testing.assert_allclose(got[b, : tr[b]], want[b, : tr[b]], atol=ATOL, rtol=0,
                                       err_msg=f"layer {layer} lane {b}")


def test_int8_plain_attention_scratch_decode_q_offset():
    # the chunk operand is a scratch of 7 generated tokens + the query token
    got, want = _both(*_attn_inputs(1, 4, 2, 128, 1024, seed=9, Tc=8), [600], [8], 0, q_off=[7])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_int8_plain_attention_is_the_column_scaled_softmax():
    """Against the definition in f64: softmax over [k_int . q * scale * ks]
    with the values v_int * vs."""
    q, k, v, ck, cv = _attn_inputs(2, 4, 2, 16, 32, seed=3)
    (kq, ks), (vq, vs) = tq.quantize_kv_rows(torch.tensor(k)), tq.quantize_kv_rows(torch.tensor(v))
    cl, tr = torch.tensor([20], dtype=torch.int32), torch.tensor([2], dtype=torch.int32)
    got = tatt.flash_decode_attention_ref(
        torch.tensor(q), kq, vq, torch.tensor(ck), torch.tensor(cv), cl, tr, 0,
        k_scale=ks, v_scale=vs)
    want = tatt.flash_decode_attention_ref(
        torch.tensor(q).double(), tq.dequantize_kv({"qw": kq, "qs": ks}, torch.float64),
        tq.dequantize_kv({"qw": vq, "qs": vs}, torch.float64), torch.tensor(ck).double(),
        torch.tensor(cv).double(), cl, tr, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="go together"):
        tatt.flash_decode_attention_ref(torch.tensor(q), kq, vq, torch.tensor(ck),
                                        torch.tensor(cv), cl, tr, 0, k_scale=ks)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def make_args(**kw) -> InferArgs:
    base = dict(system_prompt="sys", frame_fps=2.0, max_new_tokens=6,
                max_num_frames=16, stream_end_prob_threshold=None,
                stream_end_score_sum_threshold=None, threshold_z=None)
    base.update(kw)
    return InferArgs(**base)


def run(engine, frames=FRAMES, queries=((1.0, "what now?"),)):
    engine.input_video_stream(frames)
    engine.input_query_stream(
        [{"role": "user", "content": q, "time": t} for t, q in queries])
    return engine.inference()


def assert_same_run(jp, args, engine_kw, j_kw=None, t_kw=None):
    """The port's engine on the numpy copy of the JAX tree ``jp``."""
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    engine_kw = dict(kv_cache_size=512, block_frames=4, **engine_kw)
    je = JaxEngine(jp, CFG, TOK, args, **engine_kw, **(j_kw or {}))
    te = LiveInferEngine(tp, port_cfg(CFG), TOK, PortInferArgs(**dataclasses.asdict(args)),
                         **engine_kw, **(t_kw or {}))
    j_resp, t_resp = run(je), run(te)
    assert t_resp == j_resp
    assert [d["time"] for d in te.debug_data_list] == [d["time"] for d in je.debug_data_list]
    for key in ("informative_score", "relevance_score"):
        np.testing.assert_allclose(
            [d[key] for d in te.debug_data_list],
            [d[key] for d in je.debug_data_list], atol=ATOL, rtol=0)
    assert te.state.cursor == je.state.cursor
    assert te._next_frame == je._next_frame == len(FRAMES)
    return te, je, t_resp


def _trees():
    return {"dense": JP, "int8": jquant.quantize_params(NP, bits=8),
            "int4": jquant.quantize_params(NP, bits=4),
            "int8+vision": jquant.quantize_params(NP, ("decoder", "lm_head", "vision"), bits=8)}


@pytest.mark.parametrize("weights,kv", [
    ("dense", "int8"), ("int8", None), ("int4", None), ("int8", "int8"), ("int4", "int8"),
    ("int8+vision", "int8"),
])
def test_quantized_engine_matches_jax(weights, kv):
    te, je, resp = assert_same_run(
        _trees()[weights], make_args(stream_end_prob_threshold=0.5, repetition_penalty=1.2),
        dict(kv_cache_quant=kv))
    assert any(r["role"] == "assistant" for r in resp)
    assert tq.kv_quantized(te.state.kv_cache) == (kv == "int8")
    if kv == "int8":  # the committed rows carry the JAX engine's bits up to summation order
        n = te.state.cursor
        got = tq.dequantize_kv(te.state.kv_cache.k)[:, 0, :, :n].numpy()
        want = np.asarray(jq.dequantize_kv(je.state.kv_cache.k))[:, 0, :, :n]
        # a row whose value sits on a rounding tie may fall either way: one
        # int8 step of its scale at most
        step = np.asarray(je.state.kv_cache.k["qs"])[:, 0, :, :n, None]
        assert np.all(np.abs(got - want) <= step + 1e-6)


def test_quantized_engine_grounding_mode_matches_jax():
    _, _, resp = assert_same_run(
        _trees()["int4"], make_args(stream_end_prob_threshold=0.5, grounding_mode=True),
        dict(kv_cache_quant="int8"))
    assert [r["role"] for r in resp] == ["user"]


@pytest.mark.parametrize("weights,kv", [("dense", None), ("int4", "int8")])
def test_engine_with_lora_matches_jax(weights, kv):
    """A runtime adapter at scale 1.0 (saved adapters are scale-folded),
    passed to every forward of both engines."""
    lora = jlora.init_lora(jax.random.PRNGKey(3), CFG.text, rank=4)
    r = _rng(5)
    lora = {name: {"a": ab["a"], "b": jnp.asarray(r.randn(*ab["b"].shape) * 0.05, jnp.float32)}
            for name, ab in lora.items()}
    folded = jlora.fold_lora_scale(lora, 2.0)
    t_lora = params_from_numpy(jax.tree.map(np.asarray, folded), "cpu")
    kw = dict(kv_cache_quant=kv, lora_scale=1.0)
    args = make_args(stream_end_prob_threshold=0.5)
    te, _, _ = assert_same_run(_trees()[weights], args, kw, dict(lora=folded), dict(lora=t_lora))
    # the adapter changes the scores: it is not silently dropped
    plain = LiveInferEngine(te.params, port_cfg(CFG), TOK,
                            PortInferArgs(**dataclasses.asdict(args)), kv_cache_size=512,
                            block_frames=4, kv_cache_quant=kv)
    run(plain)
    assert (np.abs(np.array([d["informative_score"] for d in plain.debug_data_list[:3]])
                   - np.array([d["informative_score"] for d in te.debug_data_list[:3]])).max()
            > 1e-5)


def test_engine_dtype_comes_from_a_norm_leaf():
    tp = tquant.quantize_params(params_from_numpy(NP, "cpu", torch.bfloat16), bits=4)
    engine = LiveInferEngine(tp, port_cfg(CFG), TOK,
                             PortInferArgs(**dataclasses.asdict(
                                 make_args(stream_end_prob_threshold=0.5))),
                             kv_cache_size=64, kv_cache_quant="int8")
    assert engine.dtype == torch.bfloat16
    assert engine.state.kv_cache.k["qw"].dtype == torch.int8


# ---------------------------------------------------------------------------
# the CLI on a quantized checkpoint directory
# ---------------------------------------------------------------------------


def _video_fixture(tmp_path):
    import cv2

    vids = tmp_path / "videos"
    vids.mkdir()
    w = cv2.VideoWriter(str(vids / "a.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
    r = np.random.RandomState(0)
    for _ in range(30):
        w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
    w.release()
    anno = [{"question_id": "q0", "video": "a.mp4",
             "conversation": [{"role": "user", "content": "What is happening?", "time": 0}]}]
    test_f = tmp_path / "eval.json"
    test_f.write_text(json.dumps(anno))
    return ["--no_prefetch", "--input_dir", str(vids), "--test_fname", str(test_f),
            "--frame_fps", "2", "--max_num_frames", "6", "--stream_end_prob_threshold", "0.5",
            "--max_new_tokens", "4", "--device", "cpu"]


@pytest.mark.parametrize("bits,with_lora", [(4, False), (8, True)])
def test_cli_serves_a_quantized_checkpoint(tmp_path, bits, with_lora):
    from mmduet_tpu_torch.eval import inference as tcli
    from mmduet_tpu_torch.models import init_lora, init_mmduet_params
    from mmduet_tpu_torch.models.lora import fold_lora_scale

    ckpt = tmp_path / "ckpt"
    hf = build_qwen2_style_tokenizer()
    hf.save_pretrained(str(ckpt))
    cfg = port_cfg(tiny_config(vocab_size=len(hf) + 8))  # ids are the tokenizer's, set at load
    gen = torch.Generator().manual_seed(0)
    params = tquant.quantize_params(init_mmduet_params(cfg, gen, "cpu"), bits=bits)
    lora = None
    if with_lora:
        lora = init_lora(gen, cfg.text, rank=4)
        lora = fold_lora_scale(
            {n: {"a": ab["a"], "b": torch.randn(ab["b"].shape, generator=gen) * 0.05}
             for n, ab in lora.items()}, 2.0)
    tio.save_checkpoint(str(ckpt), cfg, params, lora)

    seen = {}
    real_build = tcli.build_engine

    def spy(args):
        seen["engine"] = real_build(args)
        return seen["engine"]

    out = tmp_path / "out.jsonl"
    argv = _video_fixture(tmp_path) + ["--checkpoint", str(ckpt), "--kv_cache_quant", "int8",
                                       "--output_fname", str(out)]
    tcli.build_engine = spy
    try:
        tcli.main(argv)
    finally:
        tcli.build_engine = real_build
    engine = seen["engine"]
    key = "qw4" if bits == 4 else "qw"
    assert key in engine.params["decoder"]["layers"]["q_proj"] and key in engine.params["lm_head"]
    assert tq.kv_quantized(engine.state.kv_cache)
    assert (engine.lora is not None) == with_lora
    assert engine.lora_scale == (1.0 if with_lora else 0.0)
    # the special-token ids are the tokenizer's, not the checkpoint's guess
    assert engine.cfg.v_placeholder_id == engine.tokenizer.v_placeholder_id != -1
    assert engine.cfg.eos_token_id == engine.tokenizer.eos_token_id != -1
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 1 and len(rows[0]["debug_data"]) == 6
    scores = [d[k] for d in rows[0]["debug_data"] for k in ("informative_score", "relevance_score")]
    assert all(0.0 <= s <= 1.0 for s in scores)


def test_cli_needs_a_model(tmp_path):
    from mmduet_tpu_torch.eval.inference import main

    with pytest.raises(SystemExit, match="--checkpoint or --tiny_random"):
        main(["--test_fname", "x", "--input_dir", "x", "--output_fname",
              str(tmp_path / "o.jsonl"), "--device", "cpu"])
