"""Weight-only quantization for serving: int8 per output channel, and
group-128 int4, nibble-packed.

Port of `mmduet_tpu/models/quant.py`. Quantized leaves keep the JAX
package's schema, shapes and dtypes, so a quantized tree crosses between
the packages through `models.params.params_from_numpy`:

- int8: ``{"qw": int8, "qs": bf16}``, symmetric over the reduce axis,
  which the scale keeps as 1. The scale is per output channel, so it
  factors out of the product: ``y @ (q * s) == (y @ q) * s``.
- int4: ``{"qw4": int8, "qs": bf16}``. The reduce axis splits into
  ``(G, group)``; values are in [-7, 7] with one bf16 scale per (group,
  output channel). Storage is nibble-packed int8 with the group axis
  halved, in split-halves order: byte ``j`` of a group holds value ``j``
  in its low nibble and value ``j + group/2`` in its high nibble. The
  scale varies along the reduction, so consumers contract per group and
  scale the f32 partial sums (`ops.quant_matmul`).

The quantizers are plain functions of tensors on any device and give the
JAX package's bits (`torch.round` and `np.round` both round half to
even). Stacked ``(L, in, out)`` leaves are walked layer by layer so the
f32 temporaries stay one layer large. Decoder, embedding and LM head
consumers dispatch on the leaf's type, so dense and quantized trees run
through the same code. Training uses dense weights: quantize after it.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from ..ops.quant_matmul import int4_matmul

Leaf = Dict[str, torch.Tensor]

# decoder matmul weights: (L, in, out), reduced over dim 1 (in)
_DECODER_MATS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
# vision-tower matmul weights: (L, in, out), reduced over dim 1 (in)
_VISION_MATS = ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2")


def quantize_weight(w: torch.Tensor, reduce_axis: int) -> Leaf:
    """Symmetric int8 over ``reduce_axis``; the scale keeps that axis as 1."""
    w = w.float()
    amax = w.abs().amax(dim=reduce_axis, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return {"qw": q, "qs": scale.to(torch.bfloat16)}


def pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int8 values in [-8, 7] -> nibble-packed int8; ``axis`` halves.

    Split-halves order: byte ``j`` holds value ``j`` (low nibble) and value
    ``j + n/2`` (high nibble) along ``axis``, so decoding is a concatenation
    of two shifted copies, not a stride-2 interleave."""
    axis = axis % q.ndim
    if q.shape[axis] % 2:
        raise ValueError(f"pack_int4: axis {axis} of {tuple(q.shape)} is odd")
    n2 = q.shape[axis] // 2
    lo = q.narrow(axis, 0, n2).contiguous().view(torch.uint8)
    hi = q.narrow(axis, n2, n2).contiguous().view(torch.uint8)
    return ((lo & 0x0F) | (hi << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Nibble-packed int8 -> int8 values in [-8, 7]; ``axis`` doubles: the
    decoded axis is [all low nibbles | all high nibbles], both
    sign-extended."""
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # arithmetic: sign-extends the high nibble
    return torch.cat([lo, hi], dim=axis % p.ndim)


def _int4_group(dim: int, group: int) -> int:
    if dim % group:  # tiny shapes: the largest common divisor
        group = _gcd(dim, group)
    if group % 2:
        raise ValueError(
            f"int4 needs an even group size to nibble-pack; reduce dim "
            f"{dim} gives group {group}"
        )
    return group


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def quantize_weight_int4(w: torch.Tensor, reduce_axis: int, group: int = 128) -> Leaf:
    """Group-wise symmetric int4 (values in [-7, 7]) along ``reduce_axis``,
    which splits into ``(G, group)``: ``qw4`` is nibble-packed over the
    group axis, ``qs`` keeps it as 1."""
    w = w.float()
    reduce_axis = reduce_axis % w.ndim
    dim = w.shape[reduce_axis]
    group = _int4_group(dim, group)
    w = w.reshape(w.shape[:reduce_axis] + (dim // group, group) + w.shape[reduce_axis + 1:])
    amax = w.abs().amax(dim=reduce_axis + 1, keepdim=True)
    scale = amax.clamp(min=1e-8) / 7.0
    q = torch.round(w / scale).clamp(-7, 7).to(torch.int8)
    return {"qw4": pack_int4(q, reduce_axis + 1), "qs": scale.to(torch.bfloat16)}


def dequantize_weight(qd: Leaf, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if "qw4" in qd:  # grouped int4: unpack, scale, merge (G, group) back
        # The packed group axis is where qs is 1 and matches qw4 everywhere
        # else; if several axes qualify (all-1 dims in tiny shapes) it is
        # the rightmost, as in the JAX package, whose choice the tests pin.
        qs_s, qw_s = tuple(qd["qs"].shape), tuple(qd["qw4"].shape)
        ax = max(
            i for i in range(len(qs_s))
            if qs_s[i] == 1 and qs_s[:i] + qs_s[i + 1:] == qw_s[:i] + qw_s[i + 1:]
        )
        w = unpack_int4(qd["qw4"], ax).float() * qd["qs"].float()
        w = w.reshape(w.shape[: ax - 1] + (w.shape[ax - 1] * w.shape[ax],) + w.shape[ax + 1:])
        return w.to(dtype)
    return (qd["qw"].float() * qd["qs"].float()).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "qs" in leaf and ("qw" in leaf or "qw4" in leaf)


def layer_view(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a tree of layer-stacked leaves: views, also of the
    tensors inside quantized leaves."""
    return {name: ({k: t[i] for k, t in w.items()} if isinstance(w, dict) else w[i])
            for name, w in layers.items()}


class _MatmulF32(torch.autograd.Function):
    """bf16 ``(N, H) @ (H, O)`` on cuBLAS with an f32 output (f32
    accumulation, no f32 copy of either operand). The backward rounds the
    f32 cotangent to bf16 for its two products; the gradients come out in
    the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(..., H) @ (H, O)`` accumulated and returned in f32, as the JAX
    einsum with ``preferred_element_type=float32``. Two bf16 operands on
    CUDA go to cuBLAS as they are (`_MatmulF32`); otherwise both are
    upcast to f32."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def quantized_matmul(y: torch.Tensor, w: Any) -> torch.Tensor:
    """``(..., H) @ (H, O) -> (..., O)`` in f32 for every weight layout:
    a dense tensor, a factored int8 leaf or a grouped int4 leaf
    (consumers: the decoder's projections and `qwen2.lm_logits`).

    - int8: the product with the int8 values cast to the activation dtype,
      then one row of scales on the f32 result. The cast makes one copy of
      the weight in the activation dtype per call; there is no kernel for
      it, as the JAX package has none.
    - int4: `ops.quant_matmul.int4_matmul`, which launches the CUDA kernel
      for CUDA tensors (or raises) and runs its plain version for CPU
      tensors. There is no route from a CUDA tensor to an unpacked copy of
      the weight."""
    if is_quantized(w):
        if "qw4" in w:
            return int4_matmul(y, w["qw4"], w["qs"])
        return matmul_f32(y, w["qw"].to(y.dtype)) * w["qs"].float()
    return matmul_f32(y, w)


def _qw(w: torch.Tensor, reduce_axis: int, bits: int) -> Leaf:
    """Quantizes one leaf; a stacked (L, in, out) leaf goes layer by
    layer into preallocated outputs."""
    if bits == 8:
        one = quantize_weight
    elif bits == 4:
        one = quantize_weight_int4
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.ndim != 3 or reduce_axis != 1:
        return one(w, reduce_axis)
    out: Leaf = {}
    for i in range(w.shape[0]):
        for key, t in one(w[i], 0).items():
            if key not in out:
                out[key] = torch.empty((w.shape[0],) + tuple(t.shape), dtype=t.dtype,
                                       device=t.device)
            out[key][i] = t
    return out


def quantize_decoder(decoder: Dict, donate: bool = False, bits: int = 8) -> Dict:
    """Quantizes the layer-stacked matmul weights and the embedding (int8
    per channel, or group-wise int4 with ``bits=4``). Norms and biases
    stay as they are. The embedding is quantized per row (int4: per row
    group): rows are gathered, then scaled.

    ``donate=True`` pops each source leaf out of the INPUT tree as it is
    converted, so its memory is free before the next leaf is quantized;
    the caller must not reuse the input tree."""
    out = dict(decoder)
    layers = decoder["layers"] if donate else dict(decoder["layers"])
    new_layers = dict(layers)
    for name in _DECODER_MATS:
        src = new_layers.pop(name) if donate else new_layers[name]
        if donate:
            layers.pop(name, None)
        new_layers[name] = _qw(src, 1, bits)
        del src
    out["layers"] = new_layers
    src = decoder.pop("embed") if donate else decoder["embed"]
    out["embed"] = _qw(src, 1, bits)
    del src
    return out


def quantize_vision(vision: Dict, donate: bool = False) -> Dict:
    """int8-quantizes the SigLIP tower's layer-stacked matmuls and its
    patch embedding. LayerNorm scales and biases, projection biases and
    the position embedding stay as they are."""
    out = dict(vision)
    layers = vision["layers"] if donate else dict(vision["layers"])
    new_layers = dict(layers)
    for name in _VISION_MATS:
        src = new_layers.pop(name) if donate else new_layers[name]
        if donate:
            layers.pop(name, None)
        new_layers[name] = _qw(src, 1, 8)
        del src
    out["layers"] = new_layers
    src = vision.pop("patch_embed") if donate else vision["patch_embed"]
    out["patch_embed"] = quantize_weight(src, reduce_axis=0)
    del src
    return out


def quantize_params(
    params: Dict,
    components: Sequence[str] = ("decoder", "lm_head"),
    donate: bool = False,
    bits: int = 8,
) -> Dict:
    """Quantizes the serving weights of a full MMDuet parameter tree.

    ``components`` is a subset of {"decoder", "lm_head", "vision"}: the
    projector and the score heads always stay dense (tiny; the heads'
    numerics feed a trained-threshold policy), and the vision tower is
    opt-in. ``bits=4`` is group-128 int4 for the decoder, LM head and
    embedding; the vision tower takes int8 only."""
    out = dict(params)
    if "decoder" in components:
        out["decoder"] = quantize_decoder(params["decoder"], donate=donate, bits=bits)
    if "lm_head" in components and "lm_head" in params:
        src = params.pop("lm_head") if donate else params["lm_head"]
        out["lm_head"] = _qw(src, 0, bits)
        del src
    if "vision" in components and "vision" in params:
        if bits != 8:
            raise ValueError(
                "the vision tower takes int8 only; quantize it separately with bits=8"
            )
        out["vision"] = quantize_vision(params["vision"], donate=donate)
    return out


def param_bytes(params: Any) -> int:
    """Total bytes of a (possibly quantized) parameter tree; int4 counts
    packed, as it is stored."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if torch.is_tensor(params):
        return params.numel() * params.element_size()
    return 0
