"""`ops.vision_fused` on the CPU: the towers' layer loop, whose elementwise
steps run as the three passes, is bit-equal to the eager layer it replaced
(kept here as `_eager_layer`), for SigLIP and CLIP, in f32 and bf16, with
dense and int8 (`quant.quantize_vision`) weights; each pass on CPU tensors
is its plain version and launches nothing. The kernels run on the card
only (`tests/test_torch_cuda.py`)."""

import dataclasses

import pytest
import torch

from mmduet_tpu_torch.config import ClipConfig, tiny_config
from mmduet_tpu_torch.models import clip, init_clip_params, init_mmduet_params, quant, siglip
from mmduet_tpu_torch.ops import vision_fused
from mmduet_tpu_torch.ops.attention import KernelRefused

SIGLIP = dataclasses.replace(tiny_config().vision, num_layers=4)  # three layers run
CLIP = ClipConfig(image_size=32, patch_size=8, hidden_size=32, intermediate_size=64,
                  num_layers=3, num_heads=2)


def _eager_layer(h, p, cfg, act):
    """The encoder layer as it ran before the passes: every elementwise step
    its own PyTorch op."""
    N, T, C = h.shape
    hd = cfg.hidden_size // cfg.num_heads
    eps = cfg.layer_norm_eps
    y = vision_fused.layer_norm(h, p["ln1_scale"], p["ln1_bias"], eps)
    q = siglip._linear(y, p["q_proj"], p["q_bias"]).reshape(N, T, -1, hd)
    k = siglip._linear(y, p["k_proj"], p["k_bias"]).reshape(N, T, -1, hd)
    v = siglip._linear(y, p["v_proj"], p["v_bias"]).reshape(N, T, -1, hd)
    attn = siglip._attend(q, k, v, hd).reshape(N, T, -1)
    h = h + siglip._linear(attn, p["o_proj"], p["o_bias"])
    y = vision_fused.layer_norm(h, p["ln2_scale"], p["ln2_bias"], eps)
    y = siglip._linear(y, p["fc1"], p["fc1_bias"])
    y = act(y.float()).to(h.dtype)
    return h + siglip._linear(y, p["fc2"], p["fc2_bias"])


def _eager_siglip(params, cfg, images):
    x = siglip._linear(siglip.patchify(images, cfg.patch_size), params["patch_embed"],
                       params["patch_bias"])
    x = x + params["pos_embed"].to(x.dtype)[None]
    for i in range(cfg.num_layers - 1):  # feature_layer -2
        x = _eager_layer(x, quant.layer_view(params["layers"], i), cfg, vision_fused.gelu_tanh)
    return x


def _eager_clip(params, cfg, images):
    N = images.shape[0]
    x = siglip._linear(siglip.patchify(images, cfg.patch_size), params["patch_embed"], None)
    cls = params["class_embed"].to(x.dtype)[None, None].expand(N, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)[None]
    x = vision_fused.layer_norm(x, params["pre_ln_scale"], params["pre_ln_bias"],
                                cfg.layer_norm_eps)
    for i in range(cfg.num_layers):
        x = _eager_layer(x, quant.layer_view(params["layers"], i), cfg, vision_fused.quick_gelu)
    return x


def _noisy(tree, gen):
    """Every floating leaf moved off its initial value (LayerNorm scales of
    ones and zero biases would hide a swapped or dropped operand)."""
    if isinstance(tree, dict):
        return {k: _noisy(t, gen) for k, t in tree.items()}
    if tree.is_floating_point():
        return tree + 0.1 * torch.randn(tree.shape, generator=gen, dtype=tree.dtype)
    return tree


def _tower(arch, dtype, int8):
    gen = torch.Generator().manual_seed(7)
    if arch == "clip":
        params = init_clip_params(CLIP, gen, "cpu")
    else:
        params = init_mmduet_params(tiny_config().replace(vision=SIGLIP), gen, "cpu")["vision"]
    params = _noisy(params, gen)
    params = {k: (v.to(dtype) if torch.is_tensor(v) else {n: t.to(dtype) for n, t in v.items()})
              for k, v in params.items()}
    if int8:
        params = quant.quantize_vision(params)
    images = torch.rand((3, 32, 32, 3), generator=gen).mul(2).sub(1).to(dtype)
    return params, images


# (arch, dtype, int8 weights); `quantize_vision` quantizes the SigLIP tree only
TOWERS = [(arch, dtype, int8) for arch in ("siglip", "clip")
          for dtype in (torch.float32, torch.bfloat16) for int8 in (False, True)
          if not (arch == "clip" and int8)]


@pytest.mark.parametrize("arch,dtype,int8", TOWERS, ids=lambda x: str(x).replace("torch.", ""))
def test_tower_is_bit_equal_to_the_eager_layers(arch, dtype, int8):
    params, images = _tower(arch, dtype, int8)
    before = vision_fused.LAUNCHES
    if arch == "clip":
        got, want = clip.clip_encode(params, CLIP, images), _eager_clip(params, CLIP, images)
    else:
        got = siglip.siglip_encode(params, SIGLIP, images)
        want = _eager_siglip(params, SIGLIP, images)
    assert vision_fused.LAUNCHES == before  # CPU tensors take the plain versions
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def test_feature_layer_zero_layers_and_one():
    params, images = _tower("siglip", torch.float32, False)
    x = siglip._linear(siglip.patchify(images, SIGLIP.patch_size), params["patch_embed"],
                       params["patch_bias"]) + params["pos_embed"][None]
    layers = params["layers"]
    assert siglip.encoder_layers(x, layers, 0, SIGLIP, vision_fused.gelu_tanh) is x
    one = _eager_layer(x, quant.layer_view(layers, 0), SIGLIP, vision_fused.gelu_tanh)
    assert torch.equal(siglip.siglip_encode(params, SIGLIP, images, feature_layer=0), one)


def _operands(gen, rows=(2, 5), width=16, dtype=torch.bfloat16):
    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    return randn(*rows, width), randn(*rows, width), randn(width), randn(width), randn(width)


def test_bias_add3_on_cpu_is_its_plain_version():
    gen = torch.Generator().manual_seed(1)
    p, h, b1, b2, b3 = _operands(gen)
    before = vision_fused.LAUNCHES
    got = vision_fused.bias_add3(p, h, p, b1, b2, b3)
    assert vision_fused.LAUNCHES == before
    want = (p + b1, h + b2, p + b3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, vision_fused.bias_add3_ref(
        p, h, p, b1, b2, b3)))


@pytest.mark.parametrize("form", ["bias_residual_ln", "layer_norm_only", "residual_only",
                                  "residual_no_bias"])
def test_bias_residual_layernorm_on_cpu_is_its_plain_version(form):
    gen = torch.Generator().manual_seed(2)
    p, h, bias, scale, shift = _operands(gen)
    eps = 1e-6
    args = {"bias_residual_ln": (p, bias, h, scale, shift),
            "layer_norm_only": (p, None, None, scale, shift),
            "residual_only": (p, bias, h, None, None),
            "residual_no_bias": (p, None, h, scale, shift)}[form]
    before = vision_fused.LAUNCHES
    h_new, y = vision_fused.bias_residual_layernorm(*args, eps)
    assert vision_fused.LAUNCHES == before
    x = p if args[1] is None else p + bias
    want_h = x if args[2] is None else h + x
    assert torch.equal(h_new, want_h)
    if form == "layer_norm_only":
        assert h_new is p
    if args[3] is None:
        assert y is None
    else:
        assert torch.equal(y, vision_fused.layer_norm(want_h, scale, shift, eps))
        f = want_h.float()
        mu = f.mean(-1, keepdim=True)
        plain = ((f - mu) * torch.rsqrt(((f - mu) ** 2).mean(-1, keepdim=True) + eps)
                 * scale.float() + shift.float()).to(p.dtype)
        assert torch.equal(y, plain)


@pytest.mark.parametrize("act", [vision_fused.gelu_tanh, vision_fused.quick_gelu],
                         ids=["gelu_tanh", "quick_gelu"])
def test_bias_act_on_cpu_is_its_plain_version(act):
    gen = torch.Generator().manual_seed(3)
    p, _, bias, _, _ = _operands(gen)
    before = vision_fused.LAUNCHES
    got = vision_fused.bias_act(p, bias, act)
    assert vision_fused.LAUNCHES == before
    assert torch.equal(got, act((p + bias).float()).to(torch.bfloat16))


def test_towers_name_the_kernels_activations():
    """Each tower's activation is one the kernel has a code for (a CUDA
    tensor with another activation is refused)."""
    assert clip.quick_gelu is vision_fused.quick_gelu
    assert set(vision_fused._ACT_CODES) == {vision_fused.gelu_tanh, vision_fused.quick_gelu}
    x = torch.linspace(-4, 4, 33)
    assert torch.equal(vision_fused.gelu_tanh(x),
                       torch.nn.functional.gelu(x, approximate="tanh"))
    assert torch.equal(vision_fused.quick_gelu(x), x * torch.sigmoid(1.702 * x))


@pytest.mark.parametrize("which", ["bias_add3", "bias_residual_layernorm", "bias_act"])
def test_no_kernel_for_a_device_other_than_cuda(which):
    p = torch.zeros((4, 16), dtype=torch.bfloat16, device="meta")
    b = torch.zeros((16,), dtype=torch.bfloat16, device="meta")
    call = {"bias_add3": lambda: vision_fused.bias_add3(p, p, p, b, b, b),
            "bias_residual_layernorm": lambda: vision_fused.bias_residual_layernorm(
                p, b, p, b, b, 1e-6),
            "bias_act": lambda: vision_fused.bias_act(p, b, vision_fused.gelu_tanh)}[which]
    with pytest.raises(KernelRefused, match="no kernel for device meta"):
        call()
