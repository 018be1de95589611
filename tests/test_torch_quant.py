"""The port's weight quantization (`mmduet_tpu_torch.models.quant`,
`ops.quant_matmul`) against the JAX package on the CPU: inputs from numpy
seeds feed both.

The quantizers must give the JAX package's bits (``qw`` / ``qw4`` / ``qs``
equal exactly). Products are compared on f32 inputs to rtol 1e-5 / atol
1e-5 (the order of the f32 sums differs); `int4_matmul_ref` is held
against the Pallas kernel in interpret mode, as `tests/test_quant_matmul.py`
runs it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import quant as jquant
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu.models import siglip as jsig
from mmduet_tpu.ops.quant_matmul import int4_matmul as pallas_int4_matmul
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models import quant as tquant
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.models import siglip as tsig
from mmduet_tpu_torch.models.io import config_from_dict
from mmduet_tpu_torch.ops import quant_matmul as tqm

RTOL = ATOL = 1e-5
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
TCFG = config_from_dict(dataclasses.asdict(CFG))
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)


def _rng(seed):
    return np.random.RandomState(seed)


def _np(x) -> np.ndarray:
    """A tensor or jax array as numpy (bf16 through f32)."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_leaf_bits_equal(got, want, where=""):
    assert set(got) == set(want), where
    for key in got:
        g, w = got[key], want[key]
        assert str(g.dtype).split(".")[-1] == str(w.dtype).split(".")[-1], (where, key)
        assert tuple(g.shape) == tuple(w.shape), (where, key)
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{where}.{key}")


def assert_tree_bits_equal(got, want, where=""):
    assert set(got) == set(want), where
    for name in got:
        if isinstance(got[name], dict) and not tquant.is_quantized(got[name]):
            assert_tree_bits_equal(got[name], want[name], f"{where}/{name}")
        elif isinstance(got[name], dict):
            assert jquant.is_quantized(want[name])
            assert_leaf_bits_equal(got[name], want[name], f"{where}/{name}")
        else:
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]), err_msg=where)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

# values with exact ties at .5 of the scale, zero columns and large ranges
def _weights(shape, seed):
    w = (_rng(seed).randn(*shape) * 0.05).astype(np.float32)
    w.flat[:: 7] = np.round(w.flat[:: 7] * 64) / 64
    w[..., 0] = 0.0
    return w


@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((64, 48), 1), ((3, 32, 16), 1),
                                        ((5, 7), 0)])
def test_quantize_weight_int8_bit_equal(shape, axis):
    w = _weights(shape, len(shape) + axis)
    assert_leaf_bits_equal(tquant.quantize_weight(torch.tensor(w), axis),
                           jquant.quantize_weight(w, axis))
    # the layer-by-layer walk of a stacked leaf gives the same bits
    assert_leaf_bits_equal(tquant._qw(torch.tensor(w), axis, 8), jquant._qw(w, axis, 8))


@pytest.mark.parametrize("shape,axis,group", [
    ((256, 48), 0, 128), ((48, 256), 1, 128), ((3, 256, 16), 1, 128),
    ((64, 8), 0, 128),     # group falls to gcd(64, 128) = 64
    ((96, 8), 0, 128),     # gcd 32
    ((256, 8), 0, 64),
])
def test_quantize_weight_int4_bit_equal(shape, axis, group):
    w = _weights(shape, sum(shape))
    got = tquant.quantize_weight_int4(torch.tensor(w), axis, group)
    want = jquant.quantize_weight_int4(w, axis, group)
    assert_leaf_bits_equal(got, want)
    if group == 128:
        assert_leaf_bits_equal(tquant._qw(torch.tensor(w), axis, 4), jquant._qw(w, axis, 4))


def test_quantize_weight_bf16_input_and_bad_bits():
    w = torch.tensor(_weights((128, 16), 3)).to(torch.bfloat16)
    want = jquant.quantize_weight_int4(w.float().numpy(), 0)
    assert_leaf_bits_equal(tquant.quantize_weight_int4(w, 0), want)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tquant._qw(w, 0, 3)


def test_int4_odd_group_raises_in_both():
    w = _weights((9, 4), 1)  # gcd(9, 128) = 1: cannot nibble-pack
    with pytest.raises(ValueError, match="even group"):
        jquant.quantize_weight_int4(w, 0)
    with pytest.raises(ValueError, match="even group"):
        tquant.quantize_weight_int4(torch.tensor(w), 0)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_unpack_int4_layout(axis):
    q = _rng(4).randint(-8, 8, (6, 10, 4)).astype(np.int8)
    packed = tquant.pack_int4(torch.tensor(q), axis)
    np.testing.assert_array_equal(packed.numpy(), jquant.pack_int4(q, axis))
    np.testing.assert_array_equal(tquant.unpack_int4(packed, axis).numpy(), q)
    np.testing.assert_array_equal(
        tquant.unpack_int4(packed, axis).numpy(),
        np.asarray(jquant.unpack_int4(jnp.asarray(packed.numpy()), axis)))
    # split halves: byte j holds value j (low nibble) and value j + n/2
    # (high nibble), not values 2j and 2j + 1
    ax = axis % 3
    n2 = q.shape[ax] // 2
    first = np.take(packed.numpy(), 0, axis=ax).view(np.uint8)
    np.testing.assert_array_equal(first & 0xF, np.take(q, 0, axis=ax).view(np.uint8) & 0xF)
    np.testing.assert_array_equal(first >> 4, np.take(q, n2, axis=ax).view(np.uint8) & 0xF)
    with pytest.raises(ValueError, match="odd"):
        tquant.pack_int4(torch.zeros((3, 2), dtype=torch.int8), 0)


@pytest.mark.parametrize("bits,components", [
    (8, ("decoder", "lm_head")), (4, ("decoder", "lm_head")),
    (8, ("decoder", "lm_head", "vision")),
])
def test_quantize_params_tree_bit_equal(bits, components):
    got = tquant.quantize_params(params_from_numpy(NP, "cpu"), components, bits=bits)
    want = jquant.quantize_params(NP, components, bits=bits)
    assert_tree_bits_equal(got, want)
    assert tquant.param_bytes(got) == jquant.param_bytes(want)
    key = "qw4" if bits == 4 else "qw"
    assert key in got["decoder"]["layers"]["down_proj"] and key in got["decoder"]["embed"]
    assert key in got["lm_head"]
    assert torch.is_tensor(got["projector"]["fc1"]) and torch.is_tensor(got["informative_head"])
    assert tquant.is_quantized(got["vision"]["patch_embed"]) == ("vision" in components)
    # the tree crosses from the JAX package as it is
    assert_tree_bits_equal(params_from_numpy(jax.tree.map(np.asarray, want), "cpu"), want)


def test_quantize_params_donate_and_vision_int4():
    src = params_from_numpy(NP, "cpu")
    kept = tquant.quantize_params(params_from_numpy(NP, "cpu"), ("decoder", "lm_head", "vision"))
    out = tquant.quantize_params(src, ("decoder", "lm_head", "vision"), donate=True)
    assert_tree_bits_equal(out, kept)
    assert "lm_head" not in src and "embed" not in src["decoder"]
    assert "q_proj" not in src["decoder"]["layers"] and "fc1" not in src["vision"]["layers"]
    assert "patch_embed" not in src["vision"]
    with pytest.raises(ValueError, match="int8 only"):
        tquant.quantize_params(params_from_numpy(NP, "cpu"), ("vision",), bits=4)
    with pytest.raises(ValueError):
        jquant.quantize_params(dict(NP), ("vision",), bits=4)


def test_params_from_numpy_keeps_quantized_dtypes():
    tree = {"w": {"qw": np.ones((2, 3), np.int8), "qs": jnp.ones((1, 3), jnp.bfloat16)},
            "cache": {"qw": np.zeros((1, 2), np.int8), "qs": np.ones((1,), np.float32)},
            "w4": {"qw4": np.ones((1, 2, 3), np.int8), "qs": jnp.ones((1, 1, 3), jnp.bfloat16)},
            "norm": np.ones((3,), np.float32)}
    out = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.bfloat16)
    assert out["w"]["qw"].dtype == out["w4"]["qw4"].dtype == out["cache"]["qw"].dtype == torch.int8
    assert out["w"]["qs"].dtype == out["w4"]["qs"].dtype == torch.bfloat16
    assert out["cache"]["qs"].dtype == torch.float32
    assert out["norm"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_weight(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for axis, shape in ((0, (256, 24)), (1, (24, 256)), (1, (2, 128, 8))):
        w = _weights(shape, axis + len(shape))
        for bits in (8, 4):
            got = tquant.dequantize_weight(tquant._qw(torch.tensor(w), axis, bits), tdt)
            want = jquant.dequantize_weight(jquant._qw(w, axis, bits), jdt)
            assert got.dtype == tdt and tuple(got.shape) == shape
            np.testing.assert_array_equal(_np(got), _np(want))


def test_dequantize_weight_degenerate_shape_as_the_reference():
    """A (2, 1) weight packs to qw4 (1, 1, 1) / qs (1, 1, 1): every axis
    looks like the group axis, both packages take the rightmost, and the
    result comes back as (1, 2), not (2, 1)."""
    w = np.array([[0.7], [-0.35]], np.float32)
    got = tquant.dequantize_weight(tquant.quantize_weight_int4(torch.tensor(w), 0), torch.float32)
    want = jquant.dequantize_weight(jquant.quantize_weight_int4(w, 0), jnp.float32)
    assert tuple(got.shape) == tuple(want.shape) == (1, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _leaves(kind, H, O, seed):
    """(port leaf, JAX leaf) of one (H, O) weight: dense f32, int8 or int4."""
    w = _weights((H, O), seed)
    if kind == "dense":
        return torch.tensor(w), jnp.asarray(w)
    bits = 8 if kind == "int8" else 4
    return tquant._qw(torch.tensor(w), 0, bits), jquant._qw(w, 0, bits)


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("lead", [(1,), (7,), (2, 5)])
def test_quantized_matmul_matches_jax(kind, lead):
    tw, jw = _leaves(kind, 256, 48, len(lead))
    y = (_rng(5).randn(*lead, 256) * 0.3).astype(np.float32)
    got = tquant.quantized_matmul(torch.tensor(y), tw)
    want = jquant.quantized_matmul(jnp.asarray(y), jw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (*lead, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("R,H,O,group", [
    (1, 256, 128, 128),     # decode matvec
    (8, 256, 128, 64),      # batched decode
    (3, 512, 384, 128),     # odd rows; several groups
    (16, 256, 1024, 128),   # wide output
    (1800, 256, 384, 128),  # beyond the Pallas wrapper's row chunk
])
def test_int4_matmul_ref_matches_pallas_interpret(R, H, O, group):
    w = (_rng(R).randn(H, O) * 0.05).astype(np.float32)
    qd = jquant.quantize_weight_int4(w, 0, group)
    y = (_rng(1).randn(R, H) * (0.1 if R > 100 else 0.3)).astype(np.float32)
    want = pallas_int4_matmul(jnp.asarray(y), qd["qw4"], qd["qs"], interpret=True)
    leaf = params_from_numpy({"w": jax.tree.map(np.asarray, qd)}, "cpu")["w"]
    got = tqm.int4_matmul_ref(torch.tensor(y), leaf["qw4"], leaf["qs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper is the plain version, and counts nothing
    before = tqm.B_LAUNCHES
    assert torch.equal(tqm.int4_matmul(torch.tensor(y), leaf["qw4"], leaf["qs"]), got)
    assert tqm.B_LAUNCHES == before


def test_int4_matmul_ref_3d_lead_dims_and_shape_check():
    w = (_rng(0).randn(256, 128) * 0.05).astype(np.float32)
    qd = jquant.quantize_weight_int4(w, 0)
    y = (_rng(2).randn(2, 5, 256) * 0.3).astype(np.float32)
    want = pallas_int4_matmul(jnp.asarray(y), qd["qw4"], qd["qs"], interpret=True)
    leaf = tquant.quantize_weight_int4(torch.tensor(w), 0)
    got = tqm.int4_matmul_ref(torch.tensor(y), leaf["qw4"], leaf["qs"])
    assert tuple(got.shape) == (2, 5, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="against 2 groups of 128"):
        tqm.int4_matmul_ref(torch.zeros((4, 300)), leaf["qw4"], leaf["qs"])


def test_int4_matmul_ref_bf16_is_the_grouped_form():
    """bf16 activations: exact f32 products of the stored values, the scale
    on each group's f32 partial sum (never a rounded q * s)."""
    w = (_rng(3).randn(256, 32) * 0.05).astype(np.float32)
    leaf = tquant.quantize_weight_int4(torch.tensor(w), 0)
    y = torch.tensor((_rng(4).randn(5, 256) * 0.3).astype(np.float32)).to(torch.bfloat16)
    q = tquant.unpack_int4(leaf["qw4"], 1).double()            # (G, g, O)
    part = torch.einsum("rgi,gio->rgo", y.double().reshape(5, 2, 128), q)
    want = (part * leaf["qs"].double().reshape(2, 32)).sum(1)
    got = tqm.int4_matmul_ref(y, leaf["qw4"], leaf["qs"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_split_groups_plan():
    # (rows, H, columns, g) -> blocks that share one output tile's k-steps
    # (`int4_plan`, which took the place of `split_groups`)
    assert tqm.int4_plan(1, 3584, 152064, 128).ks == 1    # LM head: 594 column tiles
    assert tqm.int4_plan(1, 3584, 3584, 128).ks == 28     # 14 column tiles
    assert tqm.int4_plan(1, 18944, 3584, 128).ks == 37    # down_proj: 4 groups a block
    assert tqm.int4_plan(1568, 3584, 18944, 128).ks == 1
    assert 1 < tqm.int4_plan(53, 3584, 512, 128).ks <= 28
    for R, H, O, g in ((1, 3584, 512, 128), (4, 18944, 3584, 128), (392, 3584, 512, 128),
                       (64, 256, 256, 128), (5, 48, 48, 16), (392, 18944, 3584, 128)):
        plan = tqm.int4_plan(R, H, O, g)
        assert 1 <= plan.ks <= plan.units and plan.per * plan.ks >= plan.units
        assert plan.per * (plan.ks - 1) < plan.units  # every split has a step


def test_int4_leaf_gradient_is_defined_on_the_cpu():
    """LoRA training over an int4 base: on the CPU the plain version is
    differentiable in the activations (the CUDA kernel refuses them; see
    tests/test_torch_cuda.py)."""
    w = (_rng(6).randn(128, 16) * 0.05).astype(np.float32)
    leaf = tquant.quantize_weight_int4(torch.tensor(w), 0)
    y = torch.tensor((_rng(7).randn(3, 128) * 0.3).astype(np.float32), requires_grad=True)
    tquant.quantized_matmul(y, leaf).square().sum().backward()
    y2 = y.detach().clone().requires_grad_(True)
    (y2 @ tquant.dequantize_weight(leaf, torch.float32)).square().sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), y2.grad.numpy(), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# consumers: embedding gathers, the decoder, SigLIP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_embedding_gather_and_lm_logits(bits):
    jqp = jquant.quantize_params(NP, bits=bits)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu")
    ids = np.array([[0, 5, 511, 600], [17, 3, 2, 1]], np.int32)  # 600 >= vocab: clamped
    got = tq.embed_tokens(tqp["decoder"], torch.tensor(ids), 512)
    want = jq.embed_tokens(jqp["decoder"], jnp.asarray(ids), 512)
    assert got.dtype == torch.bfloat16  # the scale's dtype, as in the JAX package
    np.testing.assert_array_equal(_np(got), _np(want))
    hid = (_rng(9).randn(1, 2, CFG.text.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        tq.lm_logits(tqp["lm_head"], torch.tensor(hid)).numpy(),
        np.asarray(jq.lm_logits(jqp["lm_head"], jnp.asarray(hid))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_qwen2_streaming_forward_with_quantized_leaves(bits):
    jqp = jquant.quantize_params(NP, bits=bits)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu")
    t = CFG.text
    B, T, S = 2, 8, 64
    shape = (t.num_layers, B, t.num_kv_heads, S, t.head_dim)
    k = (_rng(2).randn(*shape) * 0.5).astype(np.float32)
    v = (_rng(3).randn(*shape) * 0.5).astype(np.float32)
    cl, tr = np.array([5, 20], np.int32), np.array([8, 3], np.int32)
    emb = _rng(1).randn(B, T, t.hidden_size).astype(np.float32)
    pos = cl[:, None] + np.arange(T)[None]
    jh, jc = jq.qwen2_forward(
        jqp["decoder"], t, jnp.asarray(emb), jnp.asarray(pos),
        kv_cache=jq.KVCache(jnp.asarray(k), jnp.asarray(v)), cache_len=jnp.asarray(cl),
        t_real=jnp.asarray(tr), use_flash=False)
    th, tc = tq.qwen2_forward(
        tqp["decoder"], TCFG.text, torch.tensor(emb), torch.tensor(pos),
        kv_cache=tq.KVCache(torch.tensor(k), torch.tensor(v)), cache_len=cl.tolist(),
        t_real=tr.tolist())
    for b in range(B):
        np.testing.assert_allclose(th[b, : tr[b]].numpy(), np.asarray(jh)[b, : tr[b]],
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-4, rtol=0)


def test_siglip_int8_linear_matches_jax():
    jv = jquant.quantize_vision(NP["vision"])
    tv = params_from_numpy(jax.tree.map(np.asarray, jv), "cpu")
    assert_tree_bits_equal(tquant.quantize_vision(params_from_numpy(NP["vision"], "cpu")), jv)
    px = _rng(10).uniform(-1, 1, (3, 33, 35, 3)).astype(np.float32)
    got = tsig.siglip_encode(tv, TCFG.vision, torch.tensor(px))
    want = jsig.siglip_encode(jv, CFG.vision, jnp.asarray(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    y = torch.tensor(_rng(11).randn(2, 5, 32).astype(np.float32))
    leaf = {k: t[0] for k, t in tv["layers"]["fc1"].items()}
    bias = tv["layers"]["fc1_bias"][0]
    want = y @ tquant.dequantize_weight(leaf, torch.float32) + bias
    np.testing.assert_allclose(tsig._linear(y, leaf, bias).numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)
