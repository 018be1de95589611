"""The port's CUDA kernels on the card: `flash_decode_attention` (kernel A,
with a bf16 and with an int8 cache), `flash_decode_attention_sharded`
(kernel A', A per mesh shard), `int4_matmul` (kernel B),
`flash_full_attention` (kernel C, forward and backward) and
`flash_vision_attention` (kernel D) against their plain PyTorch versions,
their refusals, and the CLIs' use of them.

Every test needs an NVIDIA GPU (`cuda` marker) and skips without one. The
file imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mmduet_tpu_torch.eval.inference as cli
from mmduet_tpu_torch.config import TestArgs, tiny_config
from mmduet_tpu_torch.eval.inference import main as cli_main
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, mmduet, quant, qwen2
from mmduet_tpu_torch.ops import attention, bounds, quant_matmul
from mmduet_tpu_torch.parallel import make_mesh
from mmduet_tpu_torch.stream import CharTokenizer
from mmduet_tpu_torch.train.loop import main as train_cli_main

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (name, B, T, Tc, nh, kh, S, L, layer, cache_len, t_real, q_offset)
CASES = [
    ("first_chunk", 1, 64, 64, 28, 4, 2048, 1, 0, (0,), (49,), (0,)),
    ("per_lane_cursors", 3, 16, 16, 8, 2, 2048, 1, 0, (0, 513, 1900), (16, 7, 1), (0, 0, 0)),
    ("decode_q_offset", 2, 1, 31, 28, 4, 4096, 2, 1, (700, 4095), (11, 4), (10, 3)),
    ("chunk_padding", 1, 64, 64, 8, 2, 2048, 1, 0, (256,), (10,), (0,)),
    ("layer_indexing", 1, 8, 8, 4, 2, 2048, 3, 2, (2047,), (8,), (0,)),
    ("8_frame_block", 1, 392, 392, 28, 4, 4096, 2, 1, (3000,), (392,), (0,)),
]


def _decode_inputs(case, dev):
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    gen = torch.Generator(device=dev).manual_seed(len(name))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, k, v = randn(B, T, nh, 128), randn(L, B, kh, S, 128), randn(L, B, kh, S, 128)
    ck, cv = randn(B, kh, Tc, 128), randn(B, kh, Tc, 128)
    if name == "chunk_padding":  # poison the padded chunk columns
        ck[:, :, tr[0]:] = 1e3
        cv[:, :, tr[0]:] = 1e3
    lanes = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (cl, tr, qo)]
    return q, k, v, ck, cv, lanes


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(case, dev):
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    q, k, v, ck, cv, lanes = _decode_inputs(case, dev)
    before = attention.LAUNCHES
    got = attention.flash_decode_attention(q, k, v, ck, cv, lanes[0], lanes[1], layer,
                                           q_offset=lanes[2])
    assert attention.LAUNCHES == before + 1
    up = (q.float(), k.float(), v.float(), ck.float(), cv.float(),
          lanes[0], lanes[1], layer, lanes[2])
    want = attention.flash_decode_attention_ref(*up)
    rms = bounds.decode_attention_rms(*up)  # the kernel rounds p to bf16
    torch.cuda.synchronize()
    for b, n in enumerate(tr):
        worst = bounds.row_ratio(got[b, :n], want[b, :n], rms[b, :n])
        assert worst <= 1.0, (name, b, worst)


# (name, T, Tc, t_real, q_offset, cache_len, cache slots a lost split or
# key tile): the main path's shapes, nh 28 / kh 4, cache of 24576 slots
A_TIMED = [
    ("decode_step", 1, 31, 11, 10, 2048, slice(256, 512)),
    ("decode_step_long", 1, 31, 11, 10, 24000, slice(256, 512)),
    ("frame_step", 64, 64, 53, 0, 2048, slice(640, 704)),
    ("8_frame_block", 392, 392, 392, 0, 2048, slice(640, 704)),
    ("32_frame_block", 1568, 1568, 1568, 0, 2048, slice(640, 704)),
]


def _device_ms(fn, iters=20):
    """Device ms of one call: ``iters`` calls replayed from a CUDA graph."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@pytest.mark.parametrize("case", A_TIMED, ids=[c[0] for c in A_TIMED])
def test_kernel_at_main_path_shapes_is_timed_and_its_bound_is_tight(case, dev):
    """Kernel A (bf16 cache) at the main path's shapes: within its bound, a
    plain version that lost one split (decode) or one key tile (blocks)
    fails it, and the kernel's time stands beside its roofline bound; the
    int8 variant is timed at the same shape."""
    name, T, Tc, t_real, q_off, cache_len, drop = case
    nh, kh, hd, S = 28, 4, 128, 24576
    gen = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
               for s in ((1, T, nh, hd), (1, 1, kh, S, hd), (1, 1, kh, S, hd)))
    ck, cv = (torch.randn((1, kh, Tc, hd), generator=gen, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    cl, tr, qo = (torch.tensor([x], dtype=torch.int32, device=dev)
                  for x in (cache_len, t_real, q_off))
    call = lambda: attention.flash_decode_attention(q, k, v, ck, cv, cl, tr, 0,  # noqa: E731
                                                    q_offset=qo)
    got = call()
    live = slice(0, cache_len)
    up = (q.float(), k[..., live, :].float(), v[..., live, :].float(), ck.float(), cv.float(),
          cl, tr, 0, qo)
    rms = bounds.decode_attention_rms(*up)[:, :t_real]
    want = attention.flash_decode_attention_ref(*up)[:, :t_real]
    assert bounds.row_ratio(got[:, :t_real], want, rms) <= 1.0
    dropped = bounds.decode_attention_dropped(*up, drop=drop)[:, :t_real]
    assert bounds.row_ratio(got[:, :t_real], dropped, rms) > 3.0
    del want, dropped, rms
    ms = _device_ms(call)
    bound_ms, bound_by = bounds.decode_attention_bound(1, T, nh, kh, hd, cache_len, t_real, q_off)
    (kq, ks), (vq, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
    int8_ms = _device_ms(lambda: attention.flash_decode_attention(
        q, kq, vq, ck, cv, cl, tr, 0, q_offset=qo, k_scale=ks, v_scale=vs))
    print(f"kernel A {name} (cache_len {cache_len}): {ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}); int8 cache {int8_ms:.4f} ms")
    assert math.isfinite(ms) and ms > 0.0 and bound_ms > 0.0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_int8_cache_kernel_matches_plain_version(case, dev):
    """Kernel A's int8 variant on the cache that `quantize_kv_rows` makes of
    random bf16 rows, against the plain version's f32 column scalings on
    the same int8 values: the kernel's only rounding is its bf16 output, so
    the bf16 kernel's row bound holds. Slots past each lane's cursor hold
    poisoned scales that must never be read into a result."""
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    q, k, v, ck, cv, lanes = _decode_inputs(case, dev)
    (kq, ks), (vq, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
    for b, n in enumerate(cl):
        ks[:, b, :, n:] = float("inf")
        vs[:, b, :, n:] = float("nan")
    before = attention.LAUNCHES, attention.INT8_LAUNCHES
    got = attention.flash_decode_attention(q, kq, vq, ck, cv, lanes[0], lanes[1], layer,
                                           q_offset=lanes[2], k_scale=ks, v_scale=vs)
    assert (attention.LAUNCHES, attention.INT8_LAUNCHES) == (before[0] + 1, before[1] + 1)
    clean = [torch.nan_to_num(x, nan=0.0, posinf=0.0) for x in (ks, vs)]
    want = attention.flash_decode_attention_ref(
        q.float(), kq, vq, ck.float(), cv.float(), lanes[0], lanes[1], layer,
        q_offset=lanes[2], k_scale=clean[0], v_scale=clean[1])
    torch.cuda.synchronize()
    for b, n in enumerate(tr):
        assert torch.isfinite(got[b, :n]).all(), (name, b)
        worst = bounds.row_ratio(got[b, :n], want[b, :n])
        assert worst <= 1.0, (name, b, worst)


def test_int8_cache_bound_catches_a_lost_scale(dev):
    """Plain versions with one fault, K's scales taken as 1 or V's scales
    of one key tile left out, miss the kernel by more than the row bound."""
    case = CASES[5]  # the 8-frame block over 3000 cache slots
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    q, k, v, ck, cv, lanes = _decode_inputs(case, dev)
    (kq, ks), (vq, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
    got = attention.flash_decode_attention(q, kq, vq, ck, cv, lanes[0], lanes[1], layer,
                                           q_offset=lanes[2], k_scale=ks, v_scale=vs)
    vs_lost = vs.clone()
    vs_lost[:, :, :, 640:704] = 0.0
    for k_scale, v_scale in ((torch.ones_like(ks), vs), (ks, vs_lost)):
        wrong = attention.flash_decode_attention_ref(
            q.float(), kq, vq, ck.float(), cv.float(), lanes[0], lanes[1], layer,
            q_offset=lanes[2], k_scale=k_scale, v_scale=v_scale)
        assert bounds.row_ratio(got, wrong) > 1.0


def test_int8_cache_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((1, 1, 4, 128), device=dev, dtype=torch.bfloat16)
    ck = torch.zeros((1, 2, 1, 128), device=dev, dtype=torch.bfloat16)
    c8 = torch.zeros((1, 1, 2, 2048, 128), device=dev, dtype=torch.int8)
    sc = torch.ones((1, 1, 2, 2048), device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    call = lambda c, **kw: attention.flash_decode_attention(  # noqa: E731
        q, c, c, ck, ck, zero, zero + 1, 0, **kw)
    call(c8, k_scale=sc, v_scale=sc)  # what it does take
    with pytest.raises(attention.KernelRefused, match="no scales"):
        call(c8)
    with pytest.raises(attention.KernelRefused, match="go together"):
        call(c8, k_scale=sc)
    with pytest.raises(attention.KernelRefused, match="int8 cache"):
        call(c8.to(torch.bfloat16), k_scale=sc, v_scale=sc)
    with pytest.raises(attention.KernelRefused, match="k_scale"):
        call(c8, k_scale=sc.to(torch.bfloat16), v_scale=sc)
    with pytest.raises(attention.KernelRefused, match="v_scale"):
        call(c8, k_scale=sc, v_scale=sc[..., :1024])
    q64 = torch.zeros((1, 1, 4, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_decode_attention(
            q64, c8[..., :64].contiguous(), c8[..., :64].contiguous(), ck[..., :64].contiguous(),
            ck[..., :64].contiguous(), zero, zero + 1, 0, k_scale=sc, v_scale=sc)


# kernel B: (name, leading dims of y, H, O, group); 3584 / 18944 / 512 are
# the 7B decoder's widths (down_proj has 148 groups)
INT4_CASES = [
    ("one_row", (1,), 512, 256, 128),
    ("three_rows", (3,), 512, 1024, 128),
    ("four_rows_narrow", (4,), 256, 48, 64),
    ("five_rows_first_mma", (5,), 256, 48, 32),
    ("group_16", (7,), 1024, 512, 16),
    ("lead_dims", (2, 5), 512, 272, 128),
    ("ragged_row_tile", (65,), 1024, 400, 128),
    ("decode_7b_qkv", (1,), 3584, 512, 128),
    ("frame_step_7b", (53,), 3584, 3584, 128),
    ("block_7b_gate", (392,), 3584, 18944, 128),
    ("block_7b_down", (200,), 18944, 3584, 128),
    ("decode_7b_down", (2,), 18944, 3584, 128),
    ("row_tile_128", (128,), 512, 272, 64),
    ("row_tile_129", (129,), 1024, 48, 32),
    ("split_7b_kv", (392,), 3584, 512, 128),
    ("rows_2049_one_call", (2049,), 3584, 512, 128),
]


def _int4_inputs(case, dev):
    name, lead, H, O, group = case
    gen = torch.Generator(device=dev).manual_seed(len(name))
    w = torch.randn((H, O), generator=gen, device=dev) / H ** 0.5
    leaf = quant.quantize_weight_int4(w, 0, group=group)
    y = torch.randn((*lead, H), generator=gen, device=dev).to(torch.bfloat16)
    return y, leaf["qw4"], leaf["qs"]


@pytest.mark.parametrize("case", INT4_CASES, ids=[c[0] for c in INT4_CASES])
def test_int4_kernel_matches_plain_version(case, dev):
    """Kernel B against `int4_matmul_ref`: both multiply the same values
    exactly in f32 and differ in the order of their f32 sums, so each
    element agrees within 2^-18 sum|y||w| + 1e-6 (`ops.bounds`)."""
    y, qw4, qs = _int4_inputs(case, dev)
    assert qw4.shape == (y.shape[-1] // case[4], case[4] // 2, case[3])
    before = quant_matmul.B_LAUNCHES
    got = quant_matmul.int4_matmul(y, qw4, qs)
    assert quant_matmul.B_LAUNCHES == before + 1
    want = quant_matmul.int4_matmul_ref(y, qw4, qs)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (*case[1], case[3]) and got.dtype == torch.float32
    mag = bounds.int4_matmul_magnitude(y, qw4, qs)
    flat = got.reshape(-1, case[3]), want.reshape(-1, case[3])
    assert torch.isfinite(got).all()
    assert bounds.int4_matmul_ratio(*flat, mag) <= 1.0
    # and the grouped form is the dequantized weight's product, to f32 sums
    dense = torch.matmul(y.float(), quant.dequantize_weight({"qw4": qw4, "qs": qs},
                                                            torch.float32))
    assert bounds.int4_matmul_ratio(flat[0], dense.reshape(-1, case[3]), 4 * mag) <= 1.0


@pytest.mark.parametrize("case", [INT4_CASES[1], INT4_CASES[9]], ids=["gemv", "mma"])
@pytest.mark.parametrize("kind", ["scale", "halves"])
def test_int4_bound_catches_a_wrong_decode(case, kind, dev):
    """A plain version that drops one group's scale, or reads the nibble
    halves in the wrong order, misses the kernel by more than the bound."""
    y, qw4, qs = _int4_inputs(case, dev)
    got = quant_matmul.int4_matmul(y, qw4, qs)
    mag = bounds.int4_matmul_magnitude(y, qw4, qs)
    wrong = bounds.int4_matmul_mutated(y, qw4, qs, kind)
    assert bounds.int4_matmul_ratio(got, wrong, mag) > 1.0


@pytest.mark.parametrize("case", [INT4_CASES[7], INT4_CASES[14]], ids=["gemv", "wgmma"])
def test_int4_split_call_is_one_launch_and_bit_equal(case, dev):
    """A call whose k-steps are split over blocks (`int4_plan`'s ks > 1) is
    one launch, the same in two runs bit for bit: the last block of a tile
    adds the partials in split order."""
    y, qw4, qs = _int4_inputs(case, dev)
    R, H, O = y.numel() // y.shape[-1], y.shape[-1], qw4.shape[-1]
    assert quant_matmul.int4_plan(R, H, O, case[4]).ks > 1
    before = quant_matmul.B_LAUNCHES
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        first = quant_matmul.int4_matmul(y, qw4, qs)
        torch.cuda.synchronize()
    assert quant_matmul.B_LAUNCHES == before + 1
    kernels = [e.key for e in prof.key_averages() if "int4" in e.key]
    assert len(kernels) == 1 and "reduce" not in kernels[0], kernels
    second = quant_matmul.int4_matmul(y, qw4, qs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    mag = bounds.int4_matmul_magnitude(y, qw4, qs)
    assert bounds.int4_matmul_ratio(first, quant_matmul.int4_matmul_ref(y, qw4, qs), mag) <= 1.0


def test_int4_kernel_refuses_what_it_does_not_take(dev):
    y, qw4, qs = _int4_inputs(INT4_CASES[0], dev)
    refused = pytest.raises(attention.KernelRefused)
    with refused as e:
        quant_matmul.int4_matmul(y.float(), qw4, qs)
    assert "bfloat16" in str(e.value)
    with refused as e:
        quant_matmul.int4_matmul(y, qw4, qs.float())
    assert "qs" in str(e.value)
    with refused as e:
        quant_matmul.int4_matmul(y, qw4.to(torch.int16), qs)
    assert "qw4" in str(e.value)
    with refused as e:  # a view that starts 2 bytes into a buffer
        shifted = torch.zeros(y.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(y.shape)
        quant_matmul.int4_matmul(shifted, qw4, qs)
    assert "aligned" in str(e.value)
    with refused as e:
        quant_matmul.int4_matmul(y, qw4.transpose(0, 1), qs)
    assert "inconsistent" in str(e.value) or "contiguous" in str(e.value)
    with refused as e:
        quant_matmul.int4_matmul(y[..., :256], qw4, qs)
    assert "inconsistent" in str(e.value)
    # 24 output columns; a group of 24 (the gcd of 48 and 120)
    w = torch.randn((512, 24), device=dev)
    leaf = quant.quantize_weight_int4(w, 0)
    with refused as e:
        quant_matmul.int4_matmul(y, leaf["qw4"], leaf["qs"])
    assert "multiple of 16" in str(e.value)
    leaf = quant.quantize_weight_int4(torch.randn((48, 32), device=dev), 0, group=120)
    with refused as e:
        quant_matmul.int4_matmul(y[..., :48].contiguous(), leaf["qw4"], leaf["qs"])
    assert "group size 24" in str(e.value)
    with pytest.raises(ValueError, match="even group"):
        quant.quantize_weight_int4(torch.randn((50, 32), device=dev), 0, group=25)
    # the kernel has no backward
    with refused as e:
        quant_matmul.int4_matmul(y.clone().requires_grad_(True), qw4, qs)
    assert "backward" in str(e.value)
    with torch.no_grad():  # outside grad mode the flag does not matter
        quant_matmul.int4_matmul(y.clone().requires_grad_(True), qw4, qs)
    before = quant_matmul.B_LAUNCHES
    assert quant_matmul.int4_matmul(y[:0], qw4, qs).shape == (0, 256)
    assert quant_matmul.B_LAUNCHES == before  # nothing to launch for no rows


def test_quantized_engine_on_the_card_goes_through_both_kernels(dev):
    """int4 weights, an int8 cache and a LoRA adapter in `LiveInferEngine`
    on the card (kernel B and kernel A's int8 variant, bf16 activations)
    against the same quantized tree on the CPU (plain versions, f32):
    grounding scores agree to the 3e-2 of bf16 activations through two
    layers, every attention launch is of the int8 variant, and kernel B
    runs seven times per attention launch (no LM head in grounding mode)."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    tok = CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)
    params = init_mmduet_params(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    params = quant.quantize_params(_map(lambda t: t.to(torch.bfloat16).float(), params), bits=4)
    gen = torch.Generator().manual_seed(4)
    lora = _map(lambda t: (0.02 * torch.randn(t.shape, generator=gen)).to(torch.bfloat16).float(),
                init_lora(torch.Generator().manual_seed(3), cfg.text, rank=8))
    frames = np.random.RandomState(1).randint(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    args = TestArgs(frame_fps=2.0, stream_end_prob_threshold=1.0, grounding_mode=True,
                    max_num_frames=16)

    def scores(p, lo):
        engine = LiveInferEngine(p, cfg, tok, args, lora=lo, lora_scale=1.0,
                                 kv_cache_quant="int8")
        engine.input_video_stream(frames)
        engine.input_query_stream([{"role": "user", "content": "Q?", "time": 0.0}])
        engine.inference()
        return np.array([d["informative_score"] for d in engine.debug_data_list])

    want = scores(params, lora)
    to_card = lambda t: (t.to(dev, torch.bfloat16) if t.dtype == torch.float32  # noqa: E731
                         else t.to(dev))
    before = attention.LAUNCHES, attention.INT8_LAUNCHES, quant_matmul.B_LAUNCHES
    got = scores(_map(to_card, params), _map(to_card, lora))
    launched = (attention.LAUNCHES - before[0], attention.INT8_LAUNCHES - before[1],
                quant_matmul.B_LAUNCHES - before[2])
    assert launched[0] == launched[1] > 0 and launched[2] == 7 * launched[0]
    assert np.abs(got - want).max() <= 3e-2


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_int4_leaf_refuses_a_gradient_on_the_card(dev):
    """Full mode with int4 leaves and an input that requires a gradient:
    kernel B has no backward, so the decoder raises instead of returning a
    result that cannot be differentiated."""
    cfg, dec = _small_decoder(dev)
    dec = quant.quantize_decoder(dec, bits=4)
    emb = (torch.randn(1, 64, 512, device=dev) * 0.1).to(torch.bfloat16)
    pos = torch.arange(64, device=dev)[None]
    hidden, _ = qwen2.qwen2_forward(dec, cfg.text, emb, pos)  # no gradient asked: runs
    assert torch.isfinite(hidden).all()
    with pytest.raises(attention.KernelRefused, match="backward"):
        qwen2.qwen2_forward(dec, cfg.text, emb.clone().requires_grad_(True), pos)


def test_kernel_refuses_what_it_does_not_take(dev):
    def mk(hd, dtype):
        return (torch.zeros((1, 1, 4, hd), device=dev, dtype=dtype),
                torch.zeros((1, 1, 2, 2048, hd), device=dev, dtype=dtype),
                torch.zeros((1, 2, 1, hd), device=dev, dtype=dtype))

    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    q, c, ck = mk(128, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.flash_decode_attention(q, c, c, ck, ck, zero, zero + 1, 0)
    q, c, ck = mk(64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention.flash_decode_attention(q, c, c, ck, ck, zero, zero + 1, 0)
    q, c, ck = mk(128, torch.bfloat16)
    strided_q = torch.zeros((1, 1, 4, 256), device=dev, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_decode_attention(strided_q, c, c, ck, ck, zero, zero + 1, 0)
    with pytest.raises(ValueError, match="layer"):
        attention.flash_decode_attention(q, c, c, ck, ck, zero, zero + 1, 1)
    with pytest.raises(ValueError, match="cache_len"):
        attention.flash_decode_attention(q, c, c, ck, ck, zero.cpu(), zero + 1, 0)


@pytest.mark.parametrize("kv_flags", [[], ["--kv_cache_quant", "int8"]], ids=["bf16", "int8"])
def test_cli_tiny_random_runs_on_the_card_through_the_kernel(dev, tmp_path, monkeypatch,
                                                             kv_flags):
    """`--tiny_random` with the default ``--device cuda``: the JSONL row has
    the keys of the CPU run's (which tests/test_torch_engine.py holds equal
    to the JAX CLI's), and the attention went through the kernel. Frames
    come from a stub dataset, so no video decoder is needed."""
    frames = np.random.RandomState(0).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    sample = SimpleNamespace(
        question_id="q0", frames=frames, fps=2.0, video_duration=3.0, error=None,
        conversation=[{"role": "user", "content": "query?", "time": 0}])
    monkeypatch.setattr(cli, "_make_dataset", lambda args, resolution: [sample])
    argv = ["--tiny_random", "--no_prefetch", "--test_fname", "x", "--input_dir", "x",
            "--frame_fps", "2", "--stream_end_prob_threshold", "0.5",
            "--max_new_tokens", "4"] + kv_flags
    before = attention.LAUNCHES, attention.INT8_LAUNCHES
    cli_main(argv + ["--output_fname", str(tmp_path / "cuda.jsonl")])
    launched = attention.LAUNCHES - before[0]
    cli_main(argv + ["--output_fname", str(tmp_path / "cpu.jsonl"), "--device", "cpu"])
    assert attention.LAUNCHES - before[0] == launched > 0
    # with --kv_cache_quant int8 every launch is of the int8 variant
    assert attention.INT8_LAUNCHES - before[1] == (launched if kv_flags else 0)
    (row,), (cpu_row,) = ([json.loads(line) for line in open(tmp_path / f)]
                          for f in ("cuda.jsonl", "cpu.jsonl"))
    assert set(row) == set(cpu_row)
    assert set(row["latency"]) == set(cpu_row["latency"])
    assert len(row["debug_data"]) == len(cpu_row["debug_data"]) == 6
    assert {k for d in row["debug_data"] for k in d} == {
        k for d in cpu_row["debug_data"] for k in d}
    assert all(np.isfinite(d["informative_score"]) for d in row["debug_data"])


# kernel C: (name, B, T, nh, kh, padding side, real tokens per lane)
FULL_CASES = [
    ("one_token", 1, 1, 28, 4, "none", (1,)),
    ("ragged_tile", 2, 65, 4, 2, "right", (65, 40)),
    ("left_pad_first_row", 1, 200, 28, 4, "left", (130,)),
    ("right_pad_segment", 2, 300, 28, 4, "right", (300, 1)),
    ("long", 1, 700, 28, 4, "right", (650,)),
    ("two_pad_lengths", 2, 777, 28, 4, "right", (700, 333)),
    ("two_left_pad_lengths", 2, 400, 28, 4, "left", (290, 64)),
    ("one_past_a_tile", 1, 65, 28, 4, "none", (65,)),
    ("one_past_a_block", 1, 129, 28, 4, "right", (100,)),
    ("longest_bucket_left_pad", 1, 5924, 28, 4, "left", (5000,)),
]
N_BWD = len(attention.FULL_BWD_KERNELS)  # launches of one backward


@pytest.mark.parametrize("case", FULL_CASES, ids=[c[0] for c in FULL_CASES])
def test_flash_full_kernel_matches_plain_version(case, dev):
    """Forward and the three input gradients, every row (pad rows too), each
    element within `ops.bounds`' bound: 2^-8 |plain| + 2^-9 8 rms + 1e-5,
    rms the root of the summed squared terms (bf16 rounding of one factor
    a term, independent between terms, and of the O behind D). A backward
    is `FULL_BWD_KERNELS`' four launches."""
    name, B, T, nh, kh, side, n_real = case
    gen = torch.Generator(device=dev).manual_seed(len(name))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, k, v, dout = randn(B, T, nh, 128), randn(B, T, kh, 128), randn(B, T, kh, 128), randn(B, T, nh, 128)
    mask = None
    if side != "none":
        mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
        for b, n in enumerate(n_real):
            if side == "left":
                mask[b, T - n:] = True
            else:
                mask[b, :n] = True
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES)
    got = attention.flash_full_attention(*leaves, mask)
    got.backward(dout)
    assert (attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + N_BWD)
    ref = [x.float().requires_grad_(True) for x in (q, k, v)]
    want = attention.flash_full_attention_ref(*ref, mask)
    want.backward(dout.float())
    torch.cuda.synchronize()
    seg = torch.ones((B, T), dtype=torch.bool, device=dev) if mask is None else mask
    rms = bounds.full_attention_rms(q, k, v, seg, dout, got.detach())
    for what, g, w, r in zip(("o", "dq", "dk", "dv"), [got.detach()] + [x.grad for x in leaves],
                             [want.detach()] + [x.grad for x in ref], rms):
        assert torch.isfinite(g).all(), (name, what)
        assert bounds.full_attention_ratio(g, w, r) <= 1.0, (name, what)


def _full_case_on_card(dev, B=2, T=333, nh=28, kh=4, n_real=(300, 90), side="left", seed=11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, h, 128), generator=gen, device=dev, dtype=torch.bfloat16)
                     for h in (nh, kh, kh, nh))
    mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for b, n in enumerate(n_real):
        if side == "left":
            mask[b, T - n:] = True
        else:
            mask[b, :n] = True
    return q, k, v, dout, mask


@pytest.mark.parametrize("side", ["left", "right"])
def test_flash_full_kernel_lse_matches_plain_lse(side, dev):
    """The row log-sum-exp that the forward saves for the backward, natural
    log, (B, nh, T) f32: within 1e-3 of the plain one on every row (the
    kernel sums exp2 of f32 scores of the same bf16 values)."""
    q, k, v, _, mask = _full_case_on_card(dev, side=side)
    B, T = mask.shape
    _, lse = attention._full_forward(q, k, v, attention._kernel_segments(mask, B, T, dev))
    want = attention.flash_full_lse_ref(q, k, attention._segments(mask, B, T, dev))
    torch.cuda.synchronize()
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert (lse - want).abs().max().item() <= 1e-3


def test_flash_full_kernel_backward_is_deterministic(dev):
    """No atomics and a fixed order of the GQA sum: two backward runs on the
    same inputs give the same bits; so do two forward runs."""
    q, k, v, dout, mask = _full_case_on_card(dev, T=700, n_real=(650, 200), side="right")
    B, T = mask.shape
    seg = attention._kernel_segments(mask, B, T, dev)
    out, lse = attention._full_forward(q, k, v, seg)
    out2, lse2 = attention._full_forward(q, k, v, seg)
    first = attention._full_backward(q, k, v, seg, out, lse, dout)
    second = attention._full_backward(q, k, v, seg, out, lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_full_kernel_matches_the_plain_backward_algebra(dev):
    """`flash_full_backward_ref` (the kernels' algebra, tile-free, in f32) on
    the kernel's own O and LSE: dq, dk, dv within the bound."""
    q, k, v, dout, mask = _full_case_on_card(dev)
    B, T = mask.shape
    seg = attention._kernel_segments(mask, B, T, dev)
    out, lse = attention._full_forward(q, k, v, seg)
    got = attention._full_backward(q, k, v, seg, out, lse, dout)
    want = attention.flash_full_backward_ref(q, k, v, seg[:, :T], out, lse, dout)
    torch.cuda.synchronize()
    rms = bounds.full_attention_rms(q, k, v, mask, dout, out)
    for what, g, w, r in zip(("dq", "dk", "dv"), got, want, rms[1:]):
        assert bounds.full_attention_ratio(g, w, r) <= 1.0, what


def test_flash_full_kernel_refuses_what_it_does_not_take(dev):
    def mk(hd, dtype, T=8):
        return (torch.zeros((1, T, 4, hd), device=dev, dtype=dtype),
                torch.zeros((1, T, 2, hd), device=dev, dtype=dtype))

    q, k = mk(128, torch.float32)
    with pytest.raises(attention.KernelRefused, match="bfloat16"):
        attention.flash_full_attention(q, k, k)
    q, k = mk(64, torch.bfloat16)
    with pytest.raises(attention.KernelRefused, match="head_dim"):
        attention.flash_full_attention(q, k, k)
    q, k = mk(128, torch.bfloat16)
    strided = torch.zeros((1, 8, 4, 256), device=dev, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(attention.KernelRefused, match="contiguous"):
        attention.flash_full_attention(strided, k, k)
    with pytest.raises(attention.KernelRefused, match="inconsistent"):
        attention.flash_full_attention(q, k[:, :4], k)
    assert issubclass(attention.KernelRefused, ValueError)


def _small_decoder(dev):
    cfg = tiny_config(hidden_size=512)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    return cfg, params["decoder"]


def test_remat_runs_kernel_c_forward_again_in_the_backward(dev):
    """Full mode under auto on the card: kernel C, one forward per layer,
    one more per layer under remat, a backward's four kernels per layer."""
    cfg, dec = _small_decoder(dev)
    T, L = 120, cfg.text.num_layers
    mask = torch.ones((1, T), dtype=torch.bool, device=dev)
    mask[:, 100:] = False
    pos = torch.cumsum(mask.int(), 1) - 1
    for remat in (False, True):
        emb = (torch.randn(1, T, 512, device=dev) * 0.1).to(torch.bfloat16).requires_grad_(True)
        before = (attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES)
        hidden, _ = qwen2.qwen2_forward(dec, cfg.text, emb, pos, attn_mask=mask, remat=remat)
        hidden[mask].float().sum().backward()
        fwd = attention.FULL_FWD_LAUNCHES - before[0]
        bwd = attention.FULL_BWD_LAUNCHES - before[1]
        assert (fwd, bwd) == ((2 if remat else 1) * L, N_BWD * L), remat
        assert torch.isfinite(emb.grad).all()


def test_auto_flash_poisons_non_increasing_real_positions(dev):
    """The index-causal kernel equals position-causality only while real
    positions increase; under auto a violation turns the hidden states to
    NaN instead of a silently different attention. On the card the plain
    attention is refused and ``use_flash=True`` is kernel C unguarded."""
    cfg, dec = _small_decoder(dev)
    T = 96
    emb = (torch.randn(1, T, 512, device=dev) * 0.1).to(torch.bfloat16)
    good = torch.arange(T, device=dev)[None]
    bad = good.clone()
    bad[0, 7] = 6  # a repeated real position
    h_good, _ = qwen2.qwen2_forward(dec, cfg.text, emb, good)
    h_bad, _ = qwen2.qwen2_forward(dec, cfg.text, emb, bad)
    assert torch.isfinite(h_good).all()
    assert torch.isnan(h_bad).all()
    before = attention.FULL_FWD_LAUNCHES
    h_forced, _ = qwen2.qwen2_forward(dec, cfg.text, emb, bad, use_flash=True)
    assert torch.isfinite(h_forced).all()
    assert attention.FULL_FWD_LAUNCHES == before + cfg.text.num_layers
    with pytest.raises(attention.KernelRefused, match="CPU"):
        qwen2.qwen2_forward(dec, cfg.text, emb, bad, use_flash=False)


def test_train_cli_tiny_random_runs_on_the_card(dev, tmp_path):
    """`python -m mmduet_tpu_torch.train.loop --tiny_random --synthetic_steps
    2` with the default ``--device cuda``: the attention went through kernel
    C (2 steps x 2 micro-batches x 2 layers, forward twice under remat,
    a backward's four kernels), two log rows with finite losses, and a final
    checkpoint whose tensors came from the card."""
    out = tmp_path / "run"
    before = attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES
    train_cli_main(["--tiny_random", "--synthetic_steps", "2", "--grad_accum_steps", "2",
                    "--logging_steps", "1", "--output_dir", str(out)])
    calls = 2 * 2 * 2
    assert (attention.FULL_FWD_LAUNCHES - before[0],
            attention.FULL_BWD_LAUNCHES - before[1]) == (2 * calls, N_BWD * calls)
    rows = [json.loads(line) for line in open(out / "log.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
    saved = torch.load(out / "final" / "params.pt", weights_only=True)
    assert saved["params"]["projector"]["fc1"].is_cuda


def test_train_cli_refuses_f32_on_the_card(dev, tmp_path):
    """Kernel C takes bf16 only: ``--bf16 false`` on the card ends the run
    before a step, instead of every step failing and being skipped."""
    with pytest.raises(SystemExit, match="bf16"):
        train_cli_main(["--tiny_random", "--synthetic_steps", "1", "--bf16", "false",
                        "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run" / "final").exists()


def test_train_cli_lets_a_failed_launch_through(dev, tmp_path, monkeypatch):
    """A kernel launch that fails on the card ends the training run; the
    loop's skip-a-bad-batch guard does not hide it."""
    real = attention._full_kernel_lib()

    class Failing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def flash_full_fwd_bf16(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(attention, "_full_kernel_lib", lambda: Failing())
    with pytest.raises(attention.KernelLaunchFailed, match="fwd launch failed"):
        train_cli_main(["--tiny_random", "--synthetic_steps", "1", "--grad_accum_steps", "1",
                        "--output_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run" / "final").exists()


def test_matmul_f32_gradients_match_the_upcast_product(dev):
    """bf16 x bf16 -> f32 on cuBLAS with its own backward: the output equals
    the f32 product of the same values (f32 accumulation on both sides),
    and the gradients equal the upcast product's to the bf16 rounding of
    the cotangent and of the result (2^-8 relative, with an rms term for
    the sum over the inner axis: with random operands the root of the
    summed squared terms is the rms of the result)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(3, 70, 256, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(256, 1000, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(3, 70, 1000, generator=gen, device=dev)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = quant.matmul_f32(xs, ws)
    assert out.dtype == torch.float32
    out.backward(g)
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    want = torch.matmul(xf, wf)
    want.backward(g)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    for got, ref in ((xs.grad, xf.grad), (ws.grad, wf.grad)):
        assert got.dtype == torch.bfloat16
        bound = 2.0**-8 * ref.abs() + 2.0**-9 * 8 * ref.square().mean().sqrt() + 1e-5
        assert ((got.float() - ref).abs() <= bound).all()


# ---------------------------------------------------------------------------
# kernel A': kernel A per shard of a one-device mesh
# ---------------------------------------------------------------------------

# (name, B, T, Tc, nh, kh, S, L, layer, cache_len, t_real, q_offset)
SHARD_CASE = ("sharded", 8, 64, 64, 28, 4, 4096, 2, 1,
              (0, 1, 63, 700, 2047, 2048, 3000, 4095), (64, 53, 1, 64, 17, 64, 49, 60), (0,) * 8)


def _ctx(shape, dev):
    mesh = make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    return attention.ShardCtx(mesh, "data" if shape[0] > 1 else None,
                              "model" if shape[1] > 1 else None)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (8, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_kernel_is_bit_equal_to_one_launch(shape, quantized, dev):
    """The shards are strided views of the operands; a (lane, head) program
    computes the same in any launch. Shards fed another shard's cursors or
    their neighbour's kv heads do not pass."""
    layer = SHARD_CASE[8]
    q, k, v, ck, cv, (cl, tr, qo) = _decode_inputs(SHARD_CASE, dev)
    scales = {}
    if quantized:
        (k, ks), (v, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
        scales = dict(k_scale=ks, v_scale=vs)
    one = attention.flash_decode_attention(q, k, v, ck, cv, cl, tr, layer, q_offset=qo, **scales)
    before = attention.LAUNCHES, attention.SHARDED_LAUNCHES, attention.INT8_LAUNCHES
    ctx = _ctx(shape, dev)
    got = attention.flash_decode_attention_sharded(q, k, v, ck, cv, cl, tr, layer, ctx,
                                                   q_offset=qo, **scales)
    torch.cuda.synchronize()
    n = shape[0] * shape[1]
    assert (attention.LAUNCHES - before[0], attention.SHARDED_LAUNCHES - before[1],
            attention.INT8_LAUNCHES - before[2]) == (n, n, n if quantized else 0)
    assert torch.equal(got, one)
    if shape[0] > 1:
        wrong = attention.flash_decode_attention_sharded(
            q, k, v, ck, cv, cl.roll(8 // shape[0]), tr, layer, ctx, q_offset=qo, **scales)
        assert not torch.equal(wrong, one)
    if shape[1] > 1:
        rolled = {name: t.roll(4 // shape[1], dims=2) for name, t in scales.items()}
        wrong = attention.flash_decode_attention_sharded(
            q, k.roll(4 // shape[1], dims=2), v.roll(4 // shape[1], dims=2), ck, cv, cl, tr,
            layer, ctx, q_offset=qo, **rolled)
        assert bounds.row_ratio(wrong[:, :1], one[:, :1].float()) > 1.0


def test_kernel_takes_strided_views_and_refuses_broken_rows(dev):
    """A view cut along lanes and heads launches as it is (no copy); rows
    that are not contiguous, or K and V laid out differently, are refused."""
    layer = SHARD_CASE[8]
    q, k, v, ck, cv, (cl, tr, qo) = _decode_inputs(SHARD_CASE, dev)
    one = attention.flash_decode_attention(q, k, v, ck, cv, cl, tr, layer, q_offset=qo)
    lanes, qh, kvh = slice(2, 6), slice(14, 28), slice(2, 4)
    part = attention.flash_decode_attention(
        q[lanes, :, qh], k[:, lanes, kvh], v[:, lanes, kvh], ck[lanes, kvh], cv[lanes, kvh],
        cl[lanes], tr[lanes], layer, q_offset=qo[lanes])
    assert torch.equal(part, one[lanes, :, qh])
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_decode_attention(q, k[..., ::2, :], v[..., ::2, :], ck, cv, cl, tr, layer)
    with pytest.raises(ValueError, match="laid out alike"):
        # K a view of two of the four heads, V a compact copy of two
        attention.flash_decode_attention(q[:, :, :14], k[:, :, :2], v[:, :, 2:].contiguous(),
                                         ck[:, :2], cv[:, :2], cl, tr, layer)
    with pytest.raises(ValueError, match="do not divide"):
        attention.flash_decode_attention_sharded(q, k, v, ck, cv, cl, tr, layer,
                                                 _ctx((1, 8), dev))


# ---------------------------------------------------------------------------
# kernel D: the ViT tower's attention
# ---------------------------------------------------------------------------

# (N, T, nh, hd): SigLIP-so400m's heads of 72 with ragged T, CLIP-L's 64,
# one token, a full-width head, the narrowest head
VISION_CASES = [(4, 729, 16, 72), (1, 50, 16, 64), (2, 1, 3, 72), (2, 129, 2, 128),
                (3, 64, 2, 8), (1, 200, 4, 40)]


@pytest.mark.parametrize("shape", VISION_CASES, ids=lambda s: "x".join(map(str, s)))
def test_flash_vision_kernel_matches_plain_version(shape, dev):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    before = attention.VISION_LAUNCHES
    got = attention.flash_vision_attention(q, k, v)
    assert attention.VISION_LAUNCHES == before + 1
    want = attention.flash_vision_attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    rms = bounds.vision_attention_rms(q, k, v)
    assert bounds.full_attention_ratio(got, want, rms) <= 1.0
    if shape[1] > 128:  # the bound is tight: a plain version without one key tile fails it
        dropped = bounds.vision_attention_dropped(q, k, v, slice(64, 128))
        assert bounds.full_attention_ratio(got, dropped, rms) > 1.0


def test_flash_vision_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros((2, 10, 4, 72), device=dev, dtype=torch.bfloat16)
    attention.flash_vision_attention(q, q, q)  # what it does take
    with pytest.raises(attention.KernelRefused, match="bfloat16"):
        attention.flash_vision_attention(q.float(), q.float(), q.float())
    q70 = torch.zeros((2, 10, 4, 70), device=dev, dtype=torch.bfloat16)
    with pytest.raises(attention.KernelRefused, match="head_dim 70"):
        attention.flash_vision_attention(q70, q70, q70)
    q136 = torch.zeros((2, 10, 4, 136), device=dev, dtype=torch.bfloat16)
    with pytest.raises(attention.KernelRefused, match="head_dim 136"):
        attention.flash_vision_attention(q136, q136, q136)
    strided = torch.zeros((2, 10, 4, 144), device=dev, dtype=torch.bfloat16)[..., :72]
    with pytest.raises(attention.KernelRefused, match="contiguous"):
        attention.flash_vision_attention(strided, q, q)
    with pytest.raises(attention.KernelRefused, match="one .* shape"):
        attention.flash_vision_attention(q, q[:, :5], q)
    with pytest.raises(attention.KernelRefused, match="on cpu"):
        attention.flash_vision_attention(q, q.cpu(), q)


def test_auto_vision_use_flash_launches_kernel_d_on_the_card(dev):
    """``vision_use_flash=None`` on CUDA tensors is kernel D (the JAX
    package's auto is its jnp route everywhere), as True is; False, the
    matmul route, is for CPU tensors and is refused on the card. Kernel D's
    embeddings agree with the plain version's (f32 on the CPU) within bf16."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    px = torch.rand((3, 32, 32, 3), device=dev).mul(2).sub(1).to(torch.bfloat16)
    layers = cfg.vision.num_layers - 1
    outs = {}
    for use_flash in (None, True):
        before = attention.VISION_LAUNCHES
        outs[use_flash] = mmduet.visual_embed(params, cfg, px, vision_use_flash=use_flash)
        assert attention.VISION_LAUNCHES - before == layers, use_flash
    assert torch.equal(outs[None], outs[True])
    before = attention.VISION_LAUNCHES
    with pytest.raises(attention.KernelRefused, match="matmul route is for CPU"):
        mmduet.visual_embed(params, cfg, px, vision_use_flash=False)
    assert attention.VISION_LAUNCHES == before
    plain = mmduet.visual_embed(_map(lambda t: t.float().cpu(), params), cfg, px.float().cpu(),
                                vision_use_flash=False)
    scale = plain.abs().max().item()
    assert (outs[True].float().cpu() - plain).abs().max().item() <= 0.05 * scale


def test_flash_vision_kernel_refuses_a_gradient(dev):
    """Kernel D is forward only: under grad mode an operand that requires a
    gradient is refused (a result without a graph would train an unfrozen
    tower on zero gradients); under ``no_grad`` the flag does not matter."""
    q, k, v = (torch.randn((1, 20, 2, 72), device=dev, dtype=torch.bfloat16) for _ in range(3))
    for i in range(3):
        ops = [q, k, v]
        ops[i] = ops[i].clone().requires_grad_(True)
        before = attention.VISION_LAUNCHES
        with pytest.raises(attention.KernelRefused, match="backward"):
            attention.flash_vision_attention(*ops)
        assert attention.VISION_LAUNCHES == before
        with torch.no_grad():
            assert torch.equal(attention.flash_vision_attention(*ops),
                               attention.flash_vision_attention(q, k, v))


def test_cli_batch_streams_runs_on_the_card_through_the_kernels(dev, tmp_path, monkeypatch):
    """`--tiny_random --batch_streams 2` with the default ``--device cuda``:
    three samples through two lanes; kernels A and D launched, the rows
    carry the CPU run's keys and finite scores."""
    r = np.random.RandomState(0)
    samples = [SimpleNamespace(
        question_id=f"q{i}", frames=r.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8), fps=2.0,
        video_duration=n / 2, error=None,
        conversation=[{"role": "user", "content": f"query {i}?", "time": 0}])
        for i, n in enumerate((6, 4, 5))]
    monkeypatch.setattr(cli, "_make_dataset", lambda args, resolution: samples)
    argv = ["--tiny_random", "--no_prefetch", "--test_fname", "x", "--input_dir", "x",
            "--frame_fps", "2", "--stream_end_score_sum_threshold", "0.3",
            "--max_new_tokens", "4", "--batch_streams", "2", "--gen_coalesce_rounds", "1"]
    before = attention.LAUNCHES, attention.VISION_LAUNCHES
    cli_main(argv + ["--output_fname", str(tmp_path / "cuda.jsonl")])
    launched = attention.LAUNCHES - before[0], attention.VISION_LAUNCHES - before[1]
    cli_main(argv + ["--output_fname", str(tmp_path / "cpu.jsonl"), "--device", "cpu"])
    assert (attention.LAUNCHES - before[0], attention.VISION_LAUNCHES - before[1]) == launched
    assert launched[0] > 0 and launched[0] % 2 == 0  # two decoder layers a forward
    assert launched[1] == 3  # one tower layer, one encode per admitted sample
    rows, cpu_rows = ({json.loads(line)["question_id"]: json.loads(line)
                       for line in open(tmp_path / f)} for f in ("cuda.jsonl", "cpu.jsonl"))
    assert set(rows) == set(cpu_rows) == {"q0", "q1", "q2"}
    for qid, row in rows.items():
        assert set(row) == set(cpu_rows[qid]) and row["latency"]["aggregate"] is True
        assert len(row["debug_data"]) == len(cpu_rows[qid]["debug_data"])
        assert all(np.isfinite(d["informative_score"]) for d in row["debug_data"])
