"""The port's CUDA kernels on the card: `flash_decode_attention` (kernel A)
and `flash_full_attention` (kernel C, forward and backward) against their
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

from mmduet_tpu.config import tiny_config
from mmduet_tpu_torch.eval.inference import main as cli_main
from mmduet_tpu_torch.models import init_mmduet_params, qwen2
from mmduet_tpu_torch.ops import attention, bounds
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(case, dev):
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


def test_cli_tiny_random_runs_on_the_card_through_the_kernel(dev, tmp_path, monkeypatch):
    """`--tiny_random` with the default ``--device cuda``: the JSONL row has
    the keys of the CPU run's (which tests/test_torch_engine.py holds equal
    to the JAX CLI's), and the attention went through the kernel. Frames
    come from a stub dataset, so no video decoder is needed."""
    import mmduet_tpu.eval.inference as jax_cli

    frames = np.random.RandomState(0).randint(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    sample = SimpleNamespace(
        question_id="q0", frames=frames, fps=2.0, video_duration=3.0, error=None,
        conversation=[{"role": "user", "content": "query?", "time": 0}])
    monkeypatch.setattr(jax_cli, "_make_dataset", lambda args, resolution: [sample])
    argv = ["--tiny_random", "--no_prefetch", "--test_fname", "x", "--input_dir", "x",
            "--frame_fps", "2", "--stream_end_prob_threshold", "0.5",
            "--max_new_tokens", "4"]
    before = attention.LAUNCHES
    cli_main(argv + ["--output_fname", str(tmp_path / "cuda.jsonl")])
    launched = attention.LAUNCHES - before
    cli_main(argv + ["--output_fname", str(tmp_path / "cpu.jsonl"), "--device", "cpu"])
    assert attention.LAUNCHES - before == launched > 0
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
    out = qwen2.matmul_f32(xs, ws)
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
