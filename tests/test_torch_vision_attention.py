"""Kernel D of the port on the CPU: `flash_vision_attention_ref`, the plain
version the CPU takes, against the JAX package's `flash_vision_attention`
run as its own tests run it off the TPU (``_impl=mha_reference``) and
against `siglip._attend`'s jnp branch; the routing of ``use_flash`` through
`siglip_encode` and `visual_embed`; and kernel D's roofline bound. f32,
atol 1e-4 (summation order only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import mmduet as jmmduet
from mmduet_tpu.models import siglip as jsiglip
from mmduet_tpu.ops.attention import flash_vision_attention as jax_flash_vision
from mmduet_tpu_torch.models import mmduet, params_from_numpy, siglip
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.ops import attention, bounds

ATOL = 1e-4
# (N, T, nh, hd): so400m's hd 72 with a ragged T, CLIP-L's 64, one key, hd 128
SHAPES = [(2, 70, 4, 72), (1, 50, 16, 64), (3, 1, 2, 8), (1, 129, 2, 128)]


def _qkv(shape, seed=5):
    r = np.random.RandomState(seed)
    return [(r.randn(*shape) * 0.3).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_jax(shape):
    q, k, v = _qkv(shape)
    got = attention.flash_vision_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.equal(got, attention.flash_vision_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v))))  # CPU tensors take the plain version
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_flash_vision(jq, jk, jv, _impl=mha_reference)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsiglip._attend(jq, jk, jv, shape[-1], use_flash=False)),
        atol=ATOL, rtol=0)
    # the bound's helpers describe the same function: no key dropped gives o
    np.testing.assert_allclose(
        bounds.vision_attention_dropped(*(torch.from_numpy(x) for x in (q, k, v)),
                                        slice(0, 0)).numpy(), got.numpy(), atol=1e-5, rtol=0)


def test_bound_helpers_catch_a_lost_key_tile():
    """The check that holds the kernel on the card: the plain version
    passes its own bound with room, and without one key tile it does not."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv((2, 200, 4, 72), seed=1))
    want = attention.flash_vision_attention_ref(q.float(), k.float(), v.float())
    got = attention.flash_vision_attention_ref(q, k, v)  # bf16 rounding of p and o
    rms = bounds.vision_attention_rms(q, k, v)
    assert rms.shape == want.shape
    assert bounds.full_attention_ratio(got, want, rms) <= 1.0
    dropped = bounds.vision_attention_dropped(q, k, v, slice(64, 128))
    assert bounds.full_attention_ratio(got, dropped, rms) > 1.0
    ms, by = bounds.vision_attention_bound(32, 729, 16, 72)
    assert by == "operations" and ms == pytest.approx(1e3 * 4 * 32 * 16 * 729 ** 2 * 72 / 989e12)
    assert bounds.vision_attention_bound(32, 8, 16, 72)[1] == "bytes"


CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
PCFG = config_from_dict(dataclasses.asdict(CFG))
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
PIXELS = np.random.RandomState(3).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False, None], ids=["flash", "matmul", "auto"])
def test_siglip_encode_use_flash_on_cpu(use_flash, monkeypatch):
    """On CPU tensors True takes kernel D's plain version, False and None
    (auto) the matmul route; all agree with the JAX tower."""
    calls = []
    real = siglip.flash_vision_attention
    monkeypatch.setattr(siglip, "flash_vision_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    got = siglip.siglip_encode(TP["vision"], PCFG.vision, torch.from_numpy(PIXELS),
                               use_flash=use_flash)
    n_layers = PCFG.vision.num_layers - 1  # features at layer -2
    assert len(calls) == (n_layers if use_flash else 0)
    want = jsiglip.siglip_encode(JP["vision"], CFG.vision, jnp.asarray(PIXELS), use_flash=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    emb = mmduet.visual_embed(TP, PCFG, torch.from_numpy(PIXELS), vision_use_flash=use_flash)
    assert len(calls) == (2 * n_layers if use_flash else 0)
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(jmmduet.visual_embed(JP, CFG, jnp.asarray(PIXELS))),
        atol=ATOL, rtol=0)


def test_auto_differs_from_the_jax_package_only_on_the_card():
    """A deliberate difference, pinned: the JAX package's auto takes its jnp
    route everywhere; the port's auto takes kernel D for CUDA tensors (and
    the matmul route for CPU tensors, checked above). What a CUDA tensor
    would get is decided by ``is_cuda`` alone."""
    import inspect

    src = inspect.getsource(siglip._attend)
    assert "use_flash = q.is_cuda" in src
    # and on the card the matmul route is refused, not run (as kernel C's plain attention)
    assert "if q.is_cuda and use_flash is False:\n        raise KernelRefused" in src
    assert "use_flash = False" in inspect.getsource(jsiglip._attend)


def test_kernel_refuses_on_the_wrong_device():
    q = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(attention.KernelRefused, match="no kernel for device"):
        attention.flash_vision_attention(q, q, q)
