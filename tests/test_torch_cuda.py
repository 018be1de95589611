"""The port's CUDA kernels on the card: `flash_decode_attention` (kernel A,
with a bf16 and with an int8 cache), `int4_matmul` (kernel B) and
`flash_full_attention` (kernel C, forward and backward) against their
plain PyTorch versions, their refusals, and the CLIs' use of them.

Every test needs an NVIDIA GPU (`cuda` marker) and skips without one. The
file imports no jax, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mmduet_tpu_torch.eval.inference as cli
from mmduet_tpu_torch.config import TestArgs, tiny_config
from mmduet_tpu_torch.eval.inference import main as cli_main
from mmduet_tpu_torch.infer import LiveInferEngine
from mmduet_tpu_torch.models import init_lora, init_mmduet_params, quant, qwen2
from mmduet_tpu_torch.ops import attention, bounds, quant_matmul
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
    want = attention.flash_decode_attention_ref(
        q.float(), k.float(), v.float(), ck.float(), cv.float(),
        lanes[0], lanes[1], layer, q_offset=lanes[2])
    torch.cuda.synchronize()
    for b, n in enumerate(tr):
        worst = bounds.row_ratio(got[b, :n], want[b, :n])
        assert worst <= 1.0, (name, b, worst)


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
]


@pytest.mark.parametrize("case", FULL_CASES, ids=[c[0] for c in FULL_CASES])
def test_flash_full_kernel_matches_plain_version(case, dev):
    """Forward and the three input gradients, every row (pad rows too), each
    element within `ops.bounds`' bound: 2^-8 |plain| + 2^-9 8 rms + 1e-5,
    rms the root of the summed squared terms (bf16 rounding of one factor
    a term, independent between terms, and of the O behind D). A backward
    is three launches."""
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
    assert (attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES) == (before[0] + 1, before[1] + 3)
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
    one more per layer under remat, three backward kernels per layer."""
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
        assert (fwd, bwd) == ((2 if remat else 1) * L, 3 * L), remat
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
    three backward kernels), two log rows with finite losses, and a final
    checkpoint whose tensors came from the card."""
    out = tmp_path / "run"
    before = attention.FULL_FWD_LAUNCHES, attention.FULL_BWD_LAUNCHES
    train_cli_main(["--tiny_random", "--synthetic_steps", "2", "--grad_accum_steps", "2",
                    "--logging_steps", "1", "--output_dir", str(out)])
    calls = 2 * 2 * 2
    assert (attention.FULL_FWD_LAUNCHES - before[0],
            attention.FULL_BWD_LAUNCHES - before[1]) == (2 * calls, 3 * calls)
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
