"""The port's CUDA kernels on the card: `flash_decode_attention` (kernel A,
with a bf16 and with an int8 cache), `flash_decode_attention_sharded`
(kernel A', A per mesh shard), `int4_matmul` (kernel B),
`flash_full_attention` (kernel C, forward and backward),
`flash_vision_attention` (kernel D) and the tower's fused passes
(`ops.vision_fused`) against their plain PyTorch versions, their
refusals, and the CLIs' use of them.

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
from mmduet_tpu_torch.config import ClipConfig, TestArgs, tiny_config
from mmduet_tpu_torch.eval.inference import main as cli_main
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.infer.state import DEFAULT_BUCKETS
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, mmduet, quant, qwen2
from mmduet_tpu_torch.ops import attention, bounds, quant_matmul, vision_fused
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
    """Kernel A at the main path's shapes, with a bf16 and with an int8
    cache: within its bound, a plain version that lost one split (decode)
    or one key tile (blocks) fails it, and the kernel's time stands beside
    its roofline bound."""
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
    call8 = lambda: attention.flash_decode_attention(  # noqa: E731
        q, kq, vq, ck, cv, cl, tr, 0, q_offset=qo, k_scale=ks, v_scale=vs)
    got = call8()
    up8 = (q.float(), kq[..., live, :], vq[..., live, :], ck.float(), cv.float(), cl, tr, 0, qo)
    scales = dict(k_scale=ks[..., live], v_scale=vs[..., live])
    rms = bounds.decode_attention_rms(*up8, **scales)[:, :t_real]
    want = attention.flash_decode_attention_ref(*up8, **scales)[:, :t_real]
    assert bounds.row_ratio(got[:, :t_real], want, rms) <= 1.0
    dropped = bounds.decode_attention_dropped(*up8, drop=drop, **scales)[:, :t_real]
    assert bounds.row_ratio(got[:, :t_real], dropped, rms) > 3.0
    del want, dropped, rms
    int8_ms = _device_ms(call8)
    int8_bound_ms, _ = bounds.decode_attention_bound(1, T, nh, kh, hd, cache_len, t_real, q_off,
                                                     int8=True)
    print(f"kernel A {name} (cache_len {cache_len}): {ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}); int8 cache {int8_ms:.4f} ms, bound {int8_bound_ms:.5f} ms")
    assert math.isfinite(ms) and ms > 0.0 and bound_ms > 0.0
    assert math.isfinite(int8_ms) and int8_ms > 0.0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_int8_cache_kernel_matches_plain_version(case, dev):
    """Kernel A's int8 variant on the cache that `quantize_kv_rows` makes of
    random bf16 rows, against the plain version's f32 column scalings on
    the same int8 values: the kernel rounds p * v_scale to bf16 and its
    output, so the bf16 kernel's row bound holds with the scaled values in
    its rms term. Slots past each lane's cursor hold poisoned scales that
    must never be read into a result."""
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
    up = (q.float(), kq, vq, ck.float(), cv.float(), lanes[0], lanes[1], layer, lanes[2])
    want = attention.flash_decode_attention_ref(*up, k_scale=clean[0], v_scale=clean[1])
    rms = bounds.decode_attention_rms(*up, k_scale=clean[0], v_scale=clean[1])
    torch.cuda.synchronize()
    for b, n in enumerate(tr):
        assert torch.isfinite(got[b, :n]).all(), (name, b)
        worst = bounds.row_ratio(got[b, :n], want[b, :n], rms[b, :n])
        assert worst <= 1.0, (name, b, worst)


def test_int8_cache_bound_catches_a_lost_scale(dev):
    """Plain versions with one fault, K's scales taken as 1 or V's scales
    of one key tile left out, miss the kernel by more than the row bound
    with its rms term."""
    case = CASES[5]  # the 8-frame block over 3000 cache slots
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    q, k, v, ck, cv, lanes = _decode_inputs(case, dev)
    (kq, ks), (vq, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
    got = attention.flash_decode_attention(q, kq, vq, ck, cv, lanes[0], lanes[1], layer,
                                           q_offset=lanes[2], k_scale=ks, v_scale=vs)
    up = (q.float(), kq, vq, ck.float(), cv.float(), lanes[0], lanes[1], layer, lanes[2])
    rms = bounds.decode_attention_rms(*up, k_scale=ks, v_scale=vs)
    assert bounds.row_ratio(got, attention.flash_decode_attention_ref(
        *up, k_scale=ks, v_scale=vs), rms) <= 1.0
    vs_lost = vs.clone()
    vs_lost[:, :, :, 640:704] = 0.0
    for k_scale, v_scale in ((torch.ones_like(ks), vs), (ks, vs_lost)):
        wrong = attention.flash_decode_attention_ref(*up, k_scale=k_scale, v_scale=v_scale)
        assert bounds.row_ratio(got, wrong, rms) > 1.0


# (name, T, S, cache_len, `decode_split`, `lane_spans` at cache_len): one row
# tile (7 rows: 24 live spans of 128 slots), a few (448 rows: 12 of 256),
# some (2744 rows: 2 of 3008 past 4096 slots), many (10976 rows: one span)
SPLIT_REGIMES = [("one_tile", 1, 4096, 3001, (128, 32), (128, 24)),
                 ("few_tiles", 64, 4096, 3001, (256, 16), (256, 12)),
                 ("some_tiles", 392, 8192, 6001, (4096, 2), (3008, 2)),
                 ("many_tiles", 1568, 4096, 3001, (4096, 1), (3008, 1))]


def _int8_case(T, S, cache_len, dev, seed=7):
    nh, kh = 28, 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=dev, dtype=torch.bfloat16)
               for s in ((1, T, nh, 128), (1, 1, kh, S, 128), (1, 1, kh, S, 128)))
    ck, cv = (torch.randn((1, kh, T, 128), generator=gen, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    (kq, ks), (vq, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
    cl, tr = (torch.tensor([x], dtype=torch.int32, device=dev) for x in (cache_len, T))
    return (q, kq, vq, ck, cv, cl, tr, 0), dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("regime", SPLIT_REGIMES, ids=[r[0] for r in SPLIT_REGIMES])
def test_int8_cache_at_each_split_regime(regime, dev):
    """The int8 cache splits as the bf16 one does (`decode_split`,
    `lane_spans`), and is within its bound in each regime."""
    name, T, S, cache_len, split, spans = regime
    args, scales = _int8_case(T, S, cache_len, dev)
    assert attention.decode_split(7 * T, S) == split
    assert attention.lane_spans(cache_len, *split) == spans
    got = attention.flash_decode_attention(*args, **scales)
    up = (args[0].float(),) + args[1:3] + (args[3].float(), args[4].float()) + args[5:]
    want = attention.flash_decode_attention_ref(*up, **scales)
    rms = bounds.decode_attention_rms(*up, **scales)
    assert bounds.row_ratio(got, want, rms) <= 1.0, name


def test_int8_split_call_is_bit_equal_and_leaves_the_counters_zero(dev):
    """A decode step over 24 live spans of 128 slots: the last block of
    each (lane, head) combines the partials in span order, so two calls are
    bit-equal, and it resets its counter, so the scratch's counters are all
    zero after the calls."""
    args, scales = _int8_case(1, 4096, 3001, dev, seed=11)
    one = attention.flash_decode_attention(*args, **scales)
    two = attention.flash_decode_attention(*args, **scales)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    _, counters = attention._split_scratch[args[0].device]
    assert int(counters.abs().sum()) == 0


def test_int8_call_captures_in_a_cuda_graph(dev):
    """The wrapper reads no cursor and allocates no scratch per call: a
    call captured in a CUDA graph, replayed after the cursors changed in
    place, gives what an eager call with those cursors gives."""
    args, scales = _int8_case(1, 4096, 3001, dev, seed=13)
    q, kq, vq, ck, cv, cl, tr, layer = args
    call = lambda: attention.flash_decode_attention(  # noqa: E731
        q, kq, vq, ck, cv, cl, tr, layer, **scales)
    call()  # the split's scratch is allocated here, outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = attention.INT8_LAUNCHES
    with torch.cuda.graph(graph):
        captured = call()
    assert attention.INT8_LAUNCHES == before + 1
    for cursor in (3001, 700, 2049):
        cl.fill_(cursor)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, call()), cursor


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

# (N, T, nh, hd): SigLIP-so400m's heads of 72 with ragged T, CLIP-L's 64
# (ViT-L/14 at 224 px and at 336 px: 1 + 24 x 24 tokens), one token, a full-width head, the narrowest head
VISION_CASES = [(4, 729, 16, 72), (1, 50, 16, 64), (2, 577, 16, 64), (2, 1, 3, 72),
                (2, 129, 2, 128), (3, 64, 2, 8), (1, 200, 4, 40)]


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


def test_clip_tower_on_the_card_launches_kernel_d_and_matches_its_plain_version(dev):
    """The CLIP arch's tower (heads of 64, CLS + 16 patches) on the card:
    one launch of kernel D a layer, embeddings within bf16 of the plain
    version's (f32, on the CPU)."""
    cfg = tiny_config(hidden_size=512, frame_num_tokens=5).replace(
        vision_arch="clip", frame_token_cls=True, frame_token_pooled=(2, 2),
        v_placeholder_id=511, eos_token_id=257,
        vision=ClipConfig(image_size=32, patch_size=8, hidden_size=128,
                          intermediate_size=256, num_layers=2, num_heads=2))
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    u8 = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8, device=dev)
    px = mmduet.normalize_pixels(cfg, u8)
    before = attention.VISION_LAUNCHES
    got = mmduet.visual_embed(params, cfg, px.to(torch.bfloat16))
    assert attention.VISION_LAUNCHES - before == cfg.vision.num_layers
    assert got.shape == (3, 5, 512) and got.dtype == torch.bfloat16
    plain = mmduet.visual_embed(_map(lambda t: t.float().cpu(), params), cfg, px.cpu(),
                                vision_use_flash=False)
    scale = plain.abs().max().item()
    assert (got.float().cpu() - plain).abs().max().item() <= 0.05 * scale


def test_encode_frames_on_the_card_runs_the_tower_in_bf16(dev):
    """Feature extraction on the card: an f32 tower is run in bf16 (kernel
    D takes bf16 only), each batch padded to the batch size, and the
    features come back to the host as f32, equal to the bf16 tower's."""
    from mmduet_tpu_torch.data.preprocess import _encode_frames
    from mmduet_tpu_torch.models import siglip

    cfg = tiny_config()
    vision = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)["vision"]
    frames = np.random.RandomState(0).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    before = attention.VISION_LAUNCHES
    got = _encode_frames(frames, vision, cfg.vision, batch_size=4)
    assert attention.VISION_LAUNCHES - before == 2 * (cfg.vision.num_layers - 1)
    assert got.dtype == np.float32 and got.shape == (6, 16, 32)
    bf16 = _map(lambda t: t.to(torch.bfloat16), vision)
    padded = np.concatenate([frames, np.zeros_like(frames[:2])])
    px = siglip.normalize_pixels(torch.from_numpy(padded).to(dev)).to(torch.bfloat16)
    with torch.inference_mode():
        want = torch.cat([siglip.siglip_encode(bf16, cfg.vision, px[i:i + 4]) for i in (0, 4)])
    np.testing.assert_array_equal(got, want[:6].float().cpu().numpy())


# The tower's fused passes: (hidden, MLP) widths of SigLIP-so400m, CLIP-L, a
# (1, 2) rank's halves, and a tiny tower; rows of a 32-frame SigLIP batch, a
# 4-frame tail and one frame
FUSED_WIDTHS = [(1152, 4304), (1024, 4096), (576, 2152), (64, 128)]
FUSED_ROWS = [32 * 729, 4 * 729, 729]


def _fused_operands(rows, width, dev, seed, n_rows=3, n_vectors=3):
    """``n_rows`` (rows, width) operands, then ``n_vectors`` (width,) ones."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
            for shape in ((rows, width),) * n_rows + ((width,),) * n_vectors]


@pytest.mark.parametrize("rows", FUSED_ROWS)
@pytest.mark.parametrize("widths", FUSED_WIDTHS, ids=lambda w: f"{w[0]}_{w[1]}")
def test_vision_fused_passes_match_their_plain_versions(widths, rows, dev):
    """`bias_add3` and `bias_act` (both activations) bit-equal to their
    eager chains on the same CUDA tensors; the LayerNorm pass in each of its
    forms with h_new bit-equal and y within one bf16 ulp, or the f32 error
    of a sum that cancels (`bounds.layernorm_ratio`); one launch a call."""
    C, inter = widths
    q, k, v, bq, bk, bv = _fused_operands(rows, C, dev, rows + C)
    before = vision_fused.LAUNCHES
    got = vision_fused.bias_add3(q, k, v, bq, bk, bv)
    assert vision_fused.LAUNCHES == before + 1
    assert all(g.is_contiguous() for g in got)
    for g, w in zip(got, vision_fused.bias_add3_ref(q, k, v, bq, bk, bv)):
        assert torch.equal(g, w)
    scale = 1 + 0.1 * bk
    for args in ((q, bq, k, scale, bv), (q, None, None, scale, bv), (q, bq, k, None, None),
                 (q, None, k, scale, bv)):
        before = vision_fused.LAUNCHES
        h_new, y = vision_fused.bias_residual_layernorm(*args, 1e-6)
        assert vision_fused.LAUNCHES == before + 1
        want_h, want_y = vision_fused.bias_residual_layernorm_ref(*args, 1e-6)
        assert torch.equal(h_new, want_h)
        assert (y is None) == (want_y is None)
        if y is not None:
            terms = bounds.layernorm_terms(want_h, args[3], args[4], 1e-6)
            assert bounds.layernorm_ratio(y, want_y, terms) <= 1.0
    fc1, b1 = _fused_operands(rows, inter, dev, inter, n_rows=1, n_vectors=1)
    for act in (vision_fused.gelu_tanh, vision_fused.quick_gelu):
        before = vision_fused.LAUNCHES
        out = vision_fused.bias_act(fc1, b1, act)
        assert vision_fused.LAUNCHES == before + 1
        assert torch.equal(out, vision_fused.bias_act_ref(fc1, b1, act)), act.__name__


def test_vision_fused_ln_bound_is_tight(dev):
    """A plain LayerNorm pass that lost its shift or its scale, or normed
    without the residual, misses the bound by far."""
    q, k, _, bq, bk, bv = _fused_operands(729, 1152, dev, 3)
    h, y = vision_fused.bias_residual_layernorm(q, bq, k, 1 + 0.1 * bk, bv, 1e-6)
    terms = bounds.layernorm_terms(h, 1 + 0.1 * bk, bv, 1e-6)
    for args in ((q, bq, k, 1 + 0.1 * bk, torch.zeros_like(bv)),
                 (q, bq, k, torch.ones_like(bk), bv), (q, bq, None, 1 + 0.1 * bk, bv)):
        wrong = vision_fused.bias_residual_layernorm_ref(*args, 1e-6)[1]
        assert bounds.layernorm_ratio(y, wrong, terms) > 10.0


def test_vision_fused_passes_refuse_what_they_do_not_take(dev):
    q, k, v, bq, bk, bv = _fused_operands(10, 64, dev, 0)
    passes = {
        "bias_add3": lambda p, b: vision_fused.bias_add3(p, k, v, b, bk, bv),
        "bias_residual_layernorm": lambda p, b: vision_fused.bias_residual_layernorm(
            p, b, k, bk, bv, 1e-6),
        "bias_act": lambda p, b: vision_fused.bias_act(p, b, vision_fused.gelu_tanh),
    }
    strided = torch.zeros((10, 128), device=dev, dtype=torch.bfloat16)[:, :64]
    grad = q.clone().requires_grad_(True)
    before = vision_fused.LAUNCHES
    for name, call in passes.items():
        with pytest.raises(attention.KernelRefused, match="bfloat16"):
            call(q.float(), bq)
        with pytest.raises(attention.KernelRefused, match="bfloat16"):
            call(q, bq.float())
        with pytest.raises(attention.KernelRefused, match="contiguous"):
            call(strided, bq)
        with pytest.raises(attention.KernelRefused, match="backward"):
            call(grad, bq)
        with pytest.raises(attention.KernelRefused, match="multiple of 8"):
            call(q[:, :60].contiguous(), bq[:60].contiguous())
        with pytest.raises(attention.KernelRefused, match="on cpu"):
            call(q, bq.cpu())
        with torch.no_grad():  # the gradient flag does not matter under no_grad
            call(grad, bq)
    assert vision_fused.LAUNCHES == before + 3
    with pytest.raises(attention.KernelRefused, match="against rows"):
        vision_fused.bias_residual_layernorm(q, bq, k[:5], bk, bv, 1e-6)
    wide = torch.zeros((2, 4616), device=dev, dtype=torch.bfloat16)
    with pytest.raises(attention.KernelRefused, match="at most 4608"):
        vision_fused.bias_residual_layernorm(wide, None, None, wide[0], wide[0], 1e-6)
    with pytest.raises(attention.KernelRefused, match="activation"):
        vision_fused.bias_act(q, bq, torch.nn.functional.silu)
    assert vision_fused.LAUNCHES == before + 3


def test_siglip_tower_on_the_card_runs_the_fused_passes(dev):
    """`siglip_encode` at SigLIP-so400m's widths (2 of its layers run, 2
    frames of 384 px) on the card: 4 fused launches a layer and the first
    LN1, features within the tower tests' 0.05 x max of the eager CPU
    tower's in f32."""
    from mmduet_tpu_torch.config import SiglipConfig
    from mmduet_tpu_torch.models import siglip

    vcfg = SiglipConfig(num_layers=3)
    cfg = tiny_config().replace(vision=vcfg, frame_resolution=384)
    vision = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(2), dev,
                                torch.bfloat16)["vision"]
    px = torch.rand((2, 384, 384, 3), device=dev).mul(2).sub(1).to(torch.bfloat16)
    before, d_before = vision_fused.LAUNCHES, attention.VISION_LAUNCHES
    with torch.inference_mode():
        got = siglip.siglip_encode(vision, vcfg, px)
    assert vision_fused.LAUNCHES - before == 4 * 2 + 1
    assert attention.VISION_LAUNCHES - d_before == 2
    want = siglip.siglip_encode(_map(lambda t: t.float().cpu(), vision), vcfg, px.float().cpu())
    scale = want.abs().max().item()
    assert got.shape == want.shape == (2, 729, 1152)
    assert (got.float().cpu() - want).abs().max().item() <= 0.05 * scale


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


# ---------------------------------------------------------------------------
# live feeding, prewarm, the converter and load_checkpoint on the card
# ---------------------------------------------------------------------------


def _small_card_model(dev, bits=None):
    """A small model (hd 128) in bf16 on the card, int4 weights with
    ``bits=4``."""
    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(5), dev,
                                torch.bfloat16)
    if bits:
        params = quant.quantize_params(params, bits=bits)
    return cfg, params, CharTokenizer(frame_num_tokens=cfg.frame_num_tokens)


def _live_engine(cfg, params, tok, grounding=False, **kw):
    args = TestArgs(frame_fps=2.0, max_new_tokens=4, max_num_frames=64, grounding_mode=grounding,
                    stream_end_score_sum_threshold=0.6)
    return LiveInferEngine(params, cfg, tok, args, block_frames=4 if not grounding else 8, **kw)


LIVE_FRAMES = np.random.RandomState(9).randint(0, 256, (64, 32, 32, 3), dtype=np.uint8)
LIVE_QUERY = [{"role": "user", "content": "what now?", "time": 1.5}]


def _live_run(engine, stream: bool, upload_ahead: bool = False):
    engine.reset()
    engine.input_query_stream(list(LIVE_QUERY))
    if stream:
        out = engine.stream_video(LIVE_FRAMES, chunk_frames=16, upload_ahead=upload_ahead)
    else:
        engine.input_video_stream(LIVE_FRAMES)
        out = engine.inference()
    torch.cuda.synchronize()
    # stream_video lists the user turns after the answers before its sort
    # by time, as the JAX engine does: a user turn and an answer at the same
    # time come in either order
    out = sorted(out, key=lambda r: (r["time"], r["role"], r["content"]))
    return out, [(d["time"], d["informative_score"], d["relevance_score"])
                 for d in engine.debug_data_list], engine.state.cursor


@pytest.mark.parametrize("upload_ahead", [False, True], ids=["vision_ahead", "upload_ahead"])
@pytest.mark.parametrize("grounding", [False, True], ids=["generation", "grounding"])
def test_stream_video_on_the_card_equals_sequential(dev, grounding, upload_ahead):
    """Chunks of 16 frames (a multiple of the block) through the side
    stream give the sequential route's texts, times, scores and cursor, bit
    for bit: the same blocks, and every vision encode at the 32-frame
    shape."""
    cfg, params, tok = _small_card_model(dev)
    engine = _live_engine(cfg, params, tok, grounding)
    want = _live_run(engine, stream=False)
    got = _live_run(engine, stream=True, upload_ahead=upload_ahead)
    assert got == want
    assert len(got[1]) == 64 and (grounding or any(r["role"] == "assistant" for r in got[0]))


def test_stream_video_runs_kernel_d_on_its_own_stream(dev, monkeypatch):
    """Every launch of kernel D in `stream_video` is on the engine's vision
    stream, every launch of kernels A and B, and every replay of the
    captured decode step, on its decoder stream (of a higher priority); the
    split scratch of A and B is left at zero (the
    one-stream rule of `ops.attention._split_scratch` and
    `ops.quant_matmul._split_scratch`)."""
    from mmduet_tpu_torch.models import siglip

    cfg, params, tok = _small_card_model(dev, bits=4)
    engine = _live_engine(cfg, params, tok, kv_cache_quant="int8")
    main = torch.cuda.current_stream(dev)
    seen = {"D": set(), "A": set(), "B": set()}

    seen["replay"] = set()

    def spy(name, fn):
        def wrapped(*args, **kw):
            # a call under a CUDA graph's capture runs nothing; the graph
            # runs where it is replayed
            if not torch.cuda.is_current_stream_capturing():
                seen[name].add(torch.cuda.current_stream(dev).cuda_stream)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(siglip, "flash_vision_attention", spy("D", siglip.flash_vision_attention))
    monkeypatch.setattr(attention, "_decode_launch", spy("A", attention._decode_launch))
    monkeypatch.setattr(quant, "int4_matmul", spy("B", quant.int4_matmul))
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", spy("replay", torch.cuda.CUDAGraph.replay))
    before = attention.VISION_LAUNCHES, attention.INT8_LAUNCHES, quant_matmul.B_LAUNCHES
    _live_run(engine, stream=True)
    launched = (attention.VISION_LAUNCHES - before[0], attention.INT8_LAUNCHES - before[1],
                quant_matmul.B_LAUNCHES - before[2])
    assert all(n > 0 for n in launched), launched
    decoder, vision = engine._streams()
    assert len({decoder.cuda_stream, vision.cuda_stream, main.cuda_stream}) == 3
    assert decoder.priority < vision.priority  # a lower number is a higher priority
    assert seen["D"] == {vision.cuda_stream}
    assert seen["A"] == seen["B"] == {decoder.cuda_stream} >= seen["replay"]
    assert engine._graphs.kinds()["decode_step"] == 1  # the first answer's step was captured
    for scratch in (attention._split_scratch, quant_matmul._split_scratch):
        for part, counters in scratch.values():
            assert not bool(counters.any())


def test_prewarm_on_the_card_then_a_session_equals_a_cold_engine(dev):
    """`prewarm` captures what it feeds (each prefill bucket, the frame
    block, the decode's prefill and step); a session after it equals one
    on a cold engine and captures nothing more."""
    cfg, params, tok = _small_card_model(dev)
    warm = _live_engine(cfg, params, tok)
    warm.prewarm(vision=True)
    assert warm.state.cursor == 0 and warm.frame_embeds is None
    kinds = warm._graphs.kinds()
    assert kinds["decode_step"] == 1 and kinds["frames_block"] == 1, kinds
    assert kinds["step"] == len(DEFAULT_BUCKETS) + 1, kinds  # the buckets and the decode prompt
    captured = len(warm._graphs)
    assert _live_run(warm, stream=True) == _live_run(_live_engine(cfg, params, tok), stream=True)
    assert len(warm._graphs) == captured


def _grow_split_scratch(cfg, dev) -> None:
    """Launches of kernels A and B whose split scratch is larger than a
    decode step's, so that both are allocated anew."""
    kh, hd = cfg.text.num_kv_heads, cfg.text.head_dim
    bf = dict(dtype=torch.bfloat16, device=dev)
    B, T, S = 8, 64, 4096
    q = torch.randn(B, T, cfg.text.num_heads, hd, **bf)
    cache = torch.randn(1, B, kh, S, hd, **bf)
    chunk = torch.randn(B, kh, T, hd, **bf)
    lanes = torch.full((B,), 3000, dtype=torch.int32, device=dev)
    attention.flash_decode_attention(q, cache, cache, chunk, chunk, lanes,
                                     torch.full_like(lanes, T), 0)
    leaf = quant.quantize_weight_int4(torch.randn(4096, 4096, **bf), 0)
    quant_matmul.int4_matmul(torch.randn(256, 4096, **bf), leaf["qw4"], leaf["qs"])


@pytest.fixture
def empty_split_scratch(dev):
    """Kernels A's and B's split scratch emptied for the test (the capture
    then takes a decode step's, which a later launch grows), and the
    scratch the test found put back after it, so the tests after it see
    what they would have seen."""
    card = torch.zeros(1, device=dev).device  # the scratch's key: cuda:<index>
    found = [(s, s.pop(card, None)) for s in (attention._split_scratch,
                                                quant_matmul._split_scratch)]
    attention._split_memo.clear()
    yield card
    for s, kept in found:
        s.pop(card, None)
        if kept is not None:
            s[card] = kept
    attention._split_memo.clear()


@pytest.mark.parametrize("bits", [None, 4], ids=["bf16", "int4_int8_cache"])
def test_decode_graph_route_equals_the_eager_device_route(dev, bits, empty_split_scratch):
    """`decode_loop` with `EngineGraphs` (the first step eager, then
    captured; a second call all replays) gives the eager route's tokens,
    n, cursors, penalty mask and cache bit for bit, on lanes with a frozen
    one, also after kernels A and B grew their split scratch; the launch
    counts hold the replays."""
    cfg, params, tok = _small_card_model(dev, bits)
    kv = "int8" if bits else None
    assert _live_engine(cfg, params, tok, kv_cache_quant=kv).decode_route == "graph"
    B, t, max_new, L = 3, 5, 6, cfg.text.num_layers
    gen = torch.Generator(device=dev).manual_seed(7)
    start = qwen2.init_kv_cache(cfg.text, B, 2048, torch.bfloat16, dev, quant=kv)
    hist = torch.randn(L, B, cfg.text.num_kv_heads, 700, cfg.text.head_dim, generator=gen,
                       device=dev, dtype=torch.bfloat16)
    qwen2.commit_lanes(start, hist, -hist, 0)
    emb = torch.randn(B, t, cfg.text.hidden_size, generator=gen, device=dev,
                      dtype=torch.bfloat16) * 0.05
    pen = torch.zeros((B, cfg.text.vocab_size), dtype=torch.bool, device=dev)
    pen[:, [3, 70]] = True
    scratch = (attention._split_scratch, quant_matmul._split_scratch)
    leaves = lambda c: [x for leaf in c for x in  # noqa: E731
                        (leaf.values() if isinstance(leaf, dict) else (leaf,))]

    def run(graphs, cache):
        counts = attention.LAUNCHES, quant_matmul.B_LAUNCHES
        out = mmduet.decode_loop(params, cfg, emb, cache, [100, 640, 37], t, pen,
                                 [True, False, True], max_new=max_new, eos_id=-1, rep=1.1,
                                 graphs=graphs)
        torch.cuda.synchronize()
        return out, (attention.LAUNCHES - counts[0], quant_matmul.B_LAUNCHES - counts[1])

    def clone(c):
        return qwen2.KVCache(*({k: x.clone() for k, x in leaf.items()} if isinstance(leaf, dict)
                               else leaf.clone() for leaf in c))

    with torch.inference_mode():
        (want, want_cache, want_pen), eager_counts = run(None, clone(start))
        assert eager_counts == (L * max_new, (7 * L + 1) * max_new if bits else 0)
        graphs, cache = mmduet.EngineGraphs(), clone(start)
        for state in ("capture", "replays", "grown scratch"):
            if state == "grown scratch":
                held = [s.get(empty_split_scratch) for s in scratch]
                _grow_split_scratch(cfg, dev)
                now = [s.get(empty_split_scratch) for s in scratch]
                assert all(a is not b for a, b in zip(held, now)), state
            for x, y in zip(leaves(cache), leaves(start)):
                x.copy_(y)
            (got, got_cache, got_pen), counts = run(graphs, cache)
            assert counts == eager_counts, state
            assert torch.equal(got, want) and torch.equal(got_pen, want_pen), state
            assert all(torch.equal(x, y) for x, y in zip(leaves(got_cache), leaves(want_cache)))
        assert graphs.kinds() == {"step": 1, "decode_step": 1}  # the prefill and the step


def _cache_bytes(cache):
    return [x.clone() for leaf in cache for x in
            (leaf.values() if isinstance(leaf, dict) else (leaf,))]


def _launch_counts():
    return (attention.LAUNCHES, attention.INT8_LAUNCHES, attention.SHARDED_LAUNCHES,
            quant_matmul.B_LAUNCHES)


def _run_route(engine, session, cache_of):
    """``session(engine)`` from a reset: its outputs, cache bytes and launch
    counts."""
    before = _launch_counts()
    engine.reset()
    got = session(engine)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(_launch_counts(), before))
    return engine, got, _cache_bytes(cache_of(engine)), counts


def _routes(make, session, cache_of):
    """``session`` on the eager route (an engine whose graphs are taken
    away) and twice on the graph route (captures, then replays)."""
    eager = make()
    eager._graphs = None
    graph = make()
    return [_run_route(e, session, cache_of) for e in (eager, graph, graph)]


def _assert_routes_equal(runs):
    (_, want, want_cache, want_counts), *graph_runs = runs
    for i, (engine, got, cache, counts) in enumerate(graph_runs):
        assert got == want, i
        assert all(torch.equal(a, b) for a, b in zip(cache, want_cache)), i
        assert counts == want_counts and counts[0] > 0, (i, counts, want_counts)
    return graph_runs[-1][0]


@pytest.mark.parametrize("grounding", [False, True], ids=["generation", "grounding"])
@pytest.mark.parametrize("bits", [None, 4], ids=["bf16", "int4_int8_cache"])
def test_frame_graph_route_equals_the_eager_route(dev, bits, grounding, empty_split_scratch):
    """`LiveInferEngine` on the graph route (steps, frame blocks, the
    decode's prefill and steps each replaying a captured graph) gives the
    eager route's responses, scores, times, cursor, cache bytes (``qs``
    included) and launch counts of A, A-int8, A' and B, bit for bit: at the
    captures, in replay, in the pipelined grounding loop (which enqueues
    block i + 1 before it reads block i), and after kernels A and B grew
    their split scratch."""
    cfg, params, tok = _small_card_model(dev, bits)
    kv = "int8" if bits else None

    def session(engine):
        engine.pipeline_grounding = True
        out = _live_run(engine, stream=False)
        return out + (engine.frame_idx,)

    runs = _routes(lambda: _live_engine(cfg, params, tok, grounding, kv_cache_quant=kv),
                   session, lambda e: e.state.kv_cache)
    engine = _assert_routes_equal(runs)
    kinds = engine._graphs.kinds()
    assert kinds["frames_block"] == 1 and kinds["step"] >= 1, kinds
    assert ("decode_step" in kinds) == (not grounding)
    assert grounding or any(r["role"] == "assistant" for r in runs[0][1][0])
    _grow_split_scratch(cfg, dev)
    _assert_routes_equal([runs[0], _run_route(engine, session, lambda e: e.state.kv_cache)])


@pytest.mark.parametrize("mesh", [None, (2, 2)], ids=["no_mesh", "one_device_mesh"])
def test_batched_graph_route_equals_the_eager_route(dev, mesh, empty_split_scratch):
    """`BatchedStreamEngine.stream_all` (prefixes, per-lane dispatches with
    unfed lanes left out of the commit, batched decodes with frozen lanes)
    and `BatchedStreamScorer` (prefixes and pipelined lockstep blocks) on
    the graph route equal the eager route bit for bit: rows, scores,
    cursors, cache bytes and launch counts."""
    from mmduet_tpu_torch.infer import BatchedStreamEngine, BatchedStreamScorer

    cfg, params, tok = _small_card_model(dev)
    card = torch.zeros(1, device=dev).device  # the parameters' device: cuda:<index>
    m = make_mesh(mesh, devices=[card] * 4) if mesh else None
    args = TestArgs(frame_fps=2.0, max_new_tokens=4, max_num_frames=16,
                    stream_end_score_sum_threshold=0.6)
    r = np.random.RandomState(3)
    embeds = (r.randn(4, 12, cfg.frame_num_tokens, cfg.text.hidden_size) * 0.05).astype(
        np.float32)
    lengths = np.array([12, 7, 10, 3])
    queries = [[{"role": "user", "content": "what now?", "time": t}] for t in (0.0, 1.5, 3.0, 0.5)]

    def engine_session(engine):
        engine.input_frame_embeds(embeds, lengths=lengths)
        engine.input_query_streams(queries)
        return engine.stream_all(), engine.debug_data_lists, engine._cur.tolist()

    runs = _routes(lambda: BatchedStreamEngine(params, cfg, tok, args, n_streams=4,
                                               block_frames=4, mesh=m),
                   engine_session, lambda e: e._cache)
    engine = _assert_routes_equal(runs)
    assert set(engine._graphs.kinds()) == {"chunk_scores", "step", "decode_step"}
    assert any(r["role"] == "assistant" for rows in runs[0][1][0] for r in rows)

    def scorer_session(scorer):
        scorer.start_sessions(["what now?", None, "and then?", None])
        scorer.input_frame_embeds(embeds, lengths=lengths)
        return scorer.score_all(), scorer._cursor.tolist()

    runs = _routes(lambda: BatchedStreamScorer(params, cfg, tok, n_streams=4, block_frames=4,
                                               max_num_frames=16, mesh=m),
                   scorer_session, lambda e: e._cache)
    scorer = _assert_routes_equal(runs)
    assert set(scorer._graphs.kinds()) == {"chunk_scores", "step"}


def test_batched_graph_route_spans_and_counters(dev, tmp_path):
    """`serve()` on the graph route under `torch.profiler` with CUDA
    activity, cold and then warm: each first call of a shape captures its
    graph inside ``graphs.capture`` (``graph_captures``), every later one
    replays it (``graph_replays``), one a ``model.forward`` or
    ``decode.step`` span; and the card's kernels and the runtime's graph
    launches carry the correlation ids that put each kernel down to its
    launch."""
    from torch.profiler import ProfilerActivity, profile

    from mmduet_tpu_torch.infer import BatchedStreamEngine

    cfg, params, tok = _small_card_model(dev)
    args = TestArgs(frame_fps=2.0, max_new_tokens=4, max_num_frames=16,
                    stream_end_score_sum_threshold=0.6)
    engine = BatchedStreamEngine(params, cfg, tok, args, n_streams=4, block_frames=4)
    r = np.random.RandomState(4)
    sessions = [{"frame_embeds": (r.randn(n, cfg.frame_num_tokens, cfg.text.hidden_size)
                                  * 0.05).astype(np.float32), "fps": 2.0,
                 "conversation": [{"role": "user", "content": "what now?", "time": 0.0}]}
                for n in (12, 7, 10, 3, 9)]
    for run in ("cold", "warm"):
        engine.reset()
        before = engine.counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            served = list(engine.serve(sessions))
            torch.cuda.synchronize()
        path = tmp_path / f"{run}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        c = engine.counters()
        names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
        calls = names.count("mmduet.model.forward") + names.count("mmduet.decode.step")
        captures = c["graph_captures"] - before["graph_captures"]
        assert len(served) == len(sessions) and c["decodes"] > 0, run
        assert names.count("mmduet.graphs.capture") == captures, run
        assert calls == c["graph_replays"] - before["graph_replays"] + captures, run
        assert (captures > 0) == (run == "cold"), (run, captures)
        launches = {e["args"]["correlation"] for e in events
                    if e.get("name") == "cudaGraphLaunch" and "correlation" in e.get("args", {})}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        assert kernels and launches, run
        assert any(e["args"].get("correlation") in launches for e in kernels), run


def test_converter_needs_no_safetensors_and_loads_onto_the_card(dev, tmp_path, monkeypatch):
    """The GPU machine has no ``safetensors``: the converter reads the
    format itself. `chip_smoke.write_hf_dir` writes an HF directory of a
    tree; the CLI (default ``--device cuda``) converts it, and
    `load_checkpoint` with no device puts it back on the card, leaf for
    leaf."""
    import sys

    import chip_smoke
    from mmduet_tpu_torch.models import convert, io

    monkeypatch.setitem(sys.modules, "safetensors", None)  # import safetensors fails
    cfg = tiny_config()
    params = init_mmduet_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                torch.bfloat16)
    chip_smoke.write_hf_dir(str(tmp_path / "hf"), params, cfg)
    convert.main(["--hf_dir", str(tmp_path / "hf"), "--output", str(tmp_path / "ckpt")])
    _, loaded, lora = io.load_checkpoint(str(tmp_path / "ckpt"))
    assert lora is None

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}/{k}") if isinstance(v, dict) else ((f"{prefix}/{k}", v),)

    got, want = dict(flat(loaded)), dict(flat(params))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].is_cuda, key
        assert got[key].dtype == leaf.dtype and torch.equal(got[key], leaf), key


# ---------------------------------------------------------------------------
# tensor-parallel serving: kernels A, B and D at the shapes each rank of a
# (1, 2) mesh gives them at the 7B widths
# ---------------------------------------------------------------------------

# kernel A at a rank's 14 query heads over 2 kv heads: a decode step, a
# joiner + frame step and an 8-frame block
TP_A_CASES = [
    ("tp_decode_step", 1, 1, 31, 14, 2, 4096, 2, 1, (2047,), (11,), (10,)),
    ("tp_frame_step", 1, 64, 64, 14, 2, 4096, 2, 0, (3000,), (53,), (0,)),
    ("tp_8_frame_block", 1, 392, 392, 14, 2, 4096, 2, 1, (3000,), (392,), (0,)),
]


@pytest.mark.parametrize("case", TP_A_CASES, ids=[c[0] for c in TP_A_CASES])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_cache", "int8_cache"])
def test_kernel_a_at_a_ranks_heads_matches_plain_version(case, quantized, dev):
    name, B, T, Tc, nh, kh, S, L, layer, cl, tr, qo = case
    q, k, v, ck, cv, lanes = _decode_inputs(case, dev)
    scales = {}
    if quantized:
        (k, ks), (v, vs) = qwen2.quantize_kv_rows(k), qwen2.quantize_kv_rows(v)
        scales = dict(k_scale=ks, v_scale=vs)
    before = attention.LAUNCHES, attention.INT8_LAUNCHES
    got = attention.flash_decode_attention(q, k, v, ck, cv, lanes[0], lanes[1], layer,
                                           q_offset=lanes[2], **scales)
    assert (attention.LAUNCHES, attention.INT8_LAUNCHES) == (before[0] + 1,
                                                            before[1] + quantized)
    up = (q.float(), k if quantized else k.float(), v if quantized else v.float(),
          ck.float(), cv.float(), lanes[0], lanes[1], layer, lanes[2])
    want = attention.flash_decode_attention_ref(*up, **scales)
    rms = bounds.decode_attention_rms(*up, **scales)
    torch.cuda.synchronize()
    for b, n in enumerate(tr):
        assert bounds.row_ratio(got[b, :n], want[b, :n], rms[b, :n]) <= 1.0, (name, b)


# kernel B at the local (H, O) of q, k/v, o, gate/up, down and the LM head
TP_B_CASES = [(f"tp_{what}_{rows}", (rows,), H, O, 128)
              for what, H, O in (("q", 3584, 1792), ("kv", 3584, 256), ("o", 1792, 3584),
                                 ("gate_up", 3584, 9472), ("down", 9472, 3584),
                                 ("lm_head", 3584, 76032))
              for rows in (1, 392)]


@pytest.mark.parametrize("case", TP_B_CASES, ids=[c[0] for c in TP_B_CASES])
def test_kernel_b_at_a_ranks_weight_shapes_matches_plain_version(case, dev):
    y, qw4, qs = _int4_inputs(case, dev)
    before = quant_matmul.B_LAUNCHES
    got = quant_matmul.int4_matmul(y, qw4, qs)
    assert quant_matmul.B_LAUNCHES == before + 1
    want = quant_matmul.int4_matmul_ref(y, qw4, qs)
    torch.cuda.synchronize()
    assert bounds.int4_matmul_ratio(got, want, bounds.int4_matmul_magnitude(y, qw4, qs)) <= 1.0


@pytest.mark.parametrize("shape", [(2, 729, 8, 72), (2, 577, 8, 64)],
                         ids=["siglip_8_heads", "clip336_8_heads"])
def test_kernel_d_at_a_ranks_heads_matches_plain_version(shape, dev):
    test_flash_vision_kernel_matches_plain_version(shape, dev)


# ---------------------------------------------------------------------------
# the training mesh: kernel C at a rank's heads, the collectives of training
# on CUDA tensors under gloo, the train CLI on ranks sharing the card
# ---------------------------------------------------------------------------

# kernel C at a rank's 14 of 28 query heads over 2 of 4 kv heads
TP_FULL_CASES = [
    ("tp_one_sample", 1, 700, 14, 2, "right", (650,)),
    ("tp_two_left_pad_lengths", 2, 400, 14, 2, "left", (390, 120)),
]


@pytest.mark.parametrize("case", TP_FULL_CASES, ids=[c[0] for c in TP_FULL_CASES])
def test_flash_full_kernel_at_a_ranks_heads_matches_plain_version(case, dev):
    test_flash_full_kernel_matches_plain_version(case, dev)


def _collectives_rank(rank: int, port: int, out: str) -> None:
    """One of two ranks of a (1, 2) mesh on the one card over gloo: g
    (`reduce_model`), f (`copy_to_model`) and a bit-exact gather of bf16
    values, each forward and backward; the results to ``out/rank<r>.pt``."""
    import os

    from mmduet_tpu_torch.parallel import collectives, initialize_distributed

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    initialize_distributed("gloo")
    make_mesh((1, 2), device="cuda:0")
    part = torch.full((2, 3), float(rank + 1), device="cuda", requires_grad=True)
    summed = collectives.reduce_model(part)
    (summed * torch.arange(6.0, device="cuda").reshape(2, 3)).sum().backward()
    x = torch.ones((2, 3), device="cuda", requires_grad=True)
    (collectives.copy_to_model(x) * (rank + 1)).sum().backward()
    block = torch.tensor([[-0.0, 1.5, float(rank)]], dtype=torch.bfloat16, device="cuda")
    whole = collectives.gather(block, 0, "model")
    torch.save({"summed": summed.detach().cpu(), "g_grad": part.grad.cpu(),
                "f_grad": x.grad.cpu(), "whole": whole.cpu()}, f"{out}/rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_training_collectives_on_cuda_tensors_under_gloo(dev, tmp_path):
    """g sums forward (in f32) and passes the cotangent through backward;
    f passes the value through forward and sums the cotangents backward;
    a gather returns every rank's block bit for bit (the bf16 -0.0 too)."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_collectives_rank, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        assert got["summed"].dtype == torch.float32 and torch.equal(got["summed"],
                                                                    torch.full((2, 3), 3.0))
        assert torch.equal(got["g_grad"], torch.arange(6.0).reshape(2, 3))
        assert torch.equal(got["f_grad"], torch.full((2, 3), 3.0))
        want = torch.tensor([[-0.0, 1.5, 0.0], [-0.0, 1.5, 1.0]], dtype=torch.bfloat16)
        assert torch.equal(got["whole"].view(torch.int16), want.view(torch.int16))


def test_train_cli_on_two_ranks_sharing_the_card(dev, tmp_path):
    """``torch.distributed.run --nproc_per_node 2 -m mmduet_tpu_torch.train.loop
    --mesh_model 2 --dist_backend gloo --device cuda:0``: each rank launches
    kernel C on its heads; the losses are the one-process CLI's within bf16
    rounding (3e-2 relative, as `chip_smoke.py`'s small train check)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--tiny_random", "--synthetic_steps", "2", "--grad_accum_steps", "2",
            "--logging_steps", "1"]
    train_cli_main(argv + ["--output_dir", str(tmp_path / "one")])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
         "mmduet_tpu_torch.train.loop", *argv, "--mesh_model", "2", "--dist_backend", "gloo",
         "--device", "cuda:0", "--output_dir", str(tmp_path / "tp")],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [[json.loads(line) for line in open(tmp_path / d / "log.jsonl")] for d in ("one", "tp")]
    assert [r["step"] for r in rows[1]] == [1, 2]
    for got, want in zip(rows[1], rows[0]):
        for k in ("loss", "lm_loss", "video_loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= 3e-2 * abs(want[k]), (k, got[k], want[k])
    assert (tmp_path / "tp" / "final" / "params.pt").exists()


# ---------------------------------------------------------------------------
# the serving data axis: lanes over two ranks sharing the card
# ---------------------------------------------------------------------------

DP_LENGTHS = (6, 4, 5, 7, 3, 6)  # six pixel sessions through four lanes, two a rank


def _dp_serving_rank(rank: int, port: int, out: str) -> None:
    """One of two ranks of a (2, 1) mesh on the one card over gloo: batched
    serving of DP_LENGTHS's sessions through 4 lanes (2 a rank); its rows,
    its launches of kernels A, A' and D, its decoder forwards and the
    frames of the sessions its lanes took, to ``out/rank<r>.json``."""
    import os

    from mmduet_tpu_torch.infer import BatchedStreamEngine
    from mmduet_tpu_torch.parallel import initialize_distributed, lane_block, shard_params

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK=str(rank))
    initialize_distributed("gloo")
    dev = torch.device("cuda", 0)
    mesh = make_mesh((2, 1), device=dev)
    cfg, params, tok = _small_card_model(dev)
    params = shard_params(params, mesh, mode="replicate")
    args = TestArgs(frame_fps=2.0, max_new_tokens=4, max_num_frames=16,
                    stream_end_score_sum_threshold=0.6)
    engine = BatchedStreamEngine(params, cfg, tok, args, n_streams=4, block_frames=4, mesh=mesh)
    lo, hi = lane_block(mesh, 4)
    admit, local = engine._admit, []
    engine._admit = lambda lane, sess: (local.append(len(sess["frames"])) if lo <= lane < hi
                                        else None) or admit(lane, sess)
    r = np.random.RandomState(3)
    sessions = [{"frames": r.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8), "fps": 2.0,
                 "conversation": [{"role": "user", "content": f"query {i}?", "time": 0.0}]}
                for i, n in enumerate(DP_LENGTHS)]
    attention.LAUNCHES = attention.SHARDED_LAUNCHES = attention.VISION_LAUNCHES = 0
    rows = {i: [resp, [[d["informative_score"], d["relevance_score"]] for d in debug]]
            for i, resp, debug in engine.serve(sessions)}
    torch.cuda.synchronize()
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump({"rows": rows, "A": attention.LAUNCHES, "A_sharded": attention.SHARDED_LAUNCHES,
                   "D": attention.VISION_LAUNCHES, "forwards": engine.forwards,
                   "dispatches": engine.dispatches, "local_frames": local,
                   "cache": list(engine._cache.k.shape)}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_dp_serving_on_two_ranks_sharing_the_card_launches_kernels_a_and_d(dev, tmp_path):
    """`BatchedStreamEngine` on a (2, 1) mesh: each rank holds two lanes'
    cache and launches kernel A once a layer per decoder forward it ran
    (none for a dispatch none of its lanes was fed in), never A' shards,
    and kernel D once a tower layer per 32-frame batch of its own lanes'
    sessions; both ranks' rows are the same."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_serving_rank, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    cfg = tiny_config(hidden_size=512)
    assert ranks[0]["rows"] == ranks[1]["rows"] and len(ranks[0]["rows"]) == len(DP_LENGTHS)
    assert sorted(ranks[0]["local_frames"] + ranks[1]["local_frames"]) == sorted(DP_LENGTHS)
    for x in ranks:
        assert x["cache"][1] == 2  # its two lanes
        assert 0 < x["forwards"] and x["A"] == cfg.text.num_layers * x["forwards"]
        assert x["A_sharded"] == 0
        assert x["D"] == (cfg.vision.num_layers - 1) * sum(-(-n // 32) for n in x["local_frames"])
    for resp, scores in ranks[0]["rows"].values():
        assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for row in scores for v in row)


def test_parity_route_on_the_card_against_the_cpu(dev, tmp_path):
    """`scripts/verify_checkpoint_parity_torch.py`'s port side on the card
    (bf16: kernel A in the decoder's streaming forward, kernel D in the
    tower) against its CPU route (f32, the plain versions) on one saved
    checkpoint, within `chip_smoke.py`'s tolerances of that route."""
    import os
    import sys

    import chip_smoke
    from mmduet_tpu_torch.models.io import save_checkpoint

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import verify_checkpoint_parity_torch as parity

    cfg = tiny_config(hidden_size=512).replace(v_placeholder_id=511, eos_token_id=257)
    params = init_mmduet_params(cfg, torch.Generator().manual_seed(2), torch.device("cpu"),
                                torch.bfloat16)
    save_checkpoint(str(tmp_path), cfg, params)
    prompts, pixels = parity.make_inputs(cfg.text.vocab_size, cfg.vision.image_size, 3, 40)
    before = attention.LAUNCHES, attention.VISION_LAUNCHES
    card = parity.port_outputs(str(tmp_path), dev, prompts, pixels)
    assert attention.LAUNCHES > before[0] and attention.VISION_LAUNCHES > before[1]
    cpu = parity.port_outputs(str(tmp_path), "cpu", prompts, pixels)
    text = {k: v for k, v in cpu.items() if k.startswith("prompt")}
    vision = {k: v for k, v in cpu.items() if not k.startswith("prompt")}
    scale = float(np.max(np.abs(cpu["vision layer(-2) features"])))
    assert parity.compare(card, text, chip_smoke.PARITY_PROB_ATOL, chip_smoke.PARITY_LOGITS_ATOL,
                          argmax_ties=2 * chip_smoke.PARITY_LOGITS_ATOL) == []
    assert parity.compare(card, vision, chip_smoke.PARITY_FEATURE_REL * scale, 0.0) == []


def test_train_recipe_on_the_card(dev):
    """`scripts/train_torch.sh` in its synthetic mode with ``DEVICE=cuda``,
    in one process and on two gloo ranks sharing the card
    (`chip_smoke.run_train_recipe`: rc 0 and finite losses each)."""
    import chip_smoke

    chip_smoke.run_train_recipe(print)


def test_memory_budget_holds_a_serving_peak_on_the_card(dev):
    """`memory_budget_torch`'s estimate of a tiny serving configuration
    against its measured peak (`scripts/serving_peak_tensors_torch.py`'s
    `measure_tiny_serving`). A warm-up engine first makes the libraries'
    workspaces, which stay resident (as in `chip_smoke.py`); kernels A's and
    B's split scratch, which the budget counts as the configuration's own,
    is released after it, so the pass allocates its own, as a new process
    would. The pass runs on the graph route, and the bytes its graph pool
    keeps count in its peak. The persistent part (the weights, the
    engine's cache, the scratch, the pool) is at most the peak, and the
    whole estimate lies within 20 % of the peak less the resident bytes: at
    this size (tens of MiB) the budget's 1 GiB floor alone would hold any
    estimate."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import memory_budget_torch as mb
    from serving_peak_tensors_torch import measure_tiny_serving

    m = measure_tiny_serving()
    est, engine, peak, resident = m["est"], m["engine"], m["peak"], m["resident"]
    assert engine.decode_route == "graph" and m["idle"] >= 0
    terms = {n: b for n, b, _ in est.persistent}
    assert terms["KV cache"] == mb.tree_bytes(engine.state.kv_cache)
    ok, line = mb.check(est, peak, resident)
    assert ok, line
    assert abs(est.total_bytes - (peak - resident)) <= 0.2 * (peak - resident), line
