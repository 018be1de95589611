"""The ViT encoder layer's elementwise passes between its GEMMs, each beside
its plain PyTorch version.

`models.siglip.encoder_layer` (the SigLIP and the CLIP towers) runs three
passes between its matrix products:

- `bias_add3`: q, k and v each plus its bias, ``round(p + b)``;
- `bias_residual_layernorm`: ``h_new = h + round(p + b)``, then ``y =
  LN(h_new)`` in f32, rounded once; after ``o_proj`` (y is LN2's output)
  and after ``fc2`` (y is the next layer's LN1 output). With no bias and no
  residual it is the LayerNorm of its input (the first layer's LN1), with
  no LayerNorm the residual step alone (the last layer);
- `bias_act`: ``round(act(float(round(p + b))))`` on fc1's product, act
  `gelu_tanh` (SigLIP) or `quick_gelu` (CLIP).

The plain versions (``*_ref``) are the eager chains of PyTorch ops the
layer ran before: CPU tensors take them, and they are what the JAX parity
tests hold. CUDA tensors launch the kernels of ``csrc/vision_fused.cu``,
which read each operand once and write each output once in bf16, with the
plain versions' roundings (the LayerNorm's f32 sums run in another order,
so a rare output differs by one bf16 ulp, or by the f32 error where the
sum it rounds cancels: `bounds.layernorm_ratio`). On a CUDA tensor a pass takes
bf16, contiguous, 16-byte aligned operands on one device, a width that is
a multiple of 8 (a LayerNorm row at most 4608 wide), and nothing that
requires a gradient under grad mode (the kernels are forward only; the
frozen tower runs under ``no_grad``); anything else raises
`KernelRefused`, a refused launch `KernelLaunchFailed`. There is no route
from a CUDA tensor to the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .attention import KernelLaunchFailed, KernelRefused

# Launches of the three kernels since the last reset to 0; only the CUDA
# branches add to it, once per launch.
LAUNCHES = 0

LN_MAX_WIDTH = 4608  # 18 16-byte vectors a lane of the row's warp

_lib: Optional[ctypes.CDLL] = None


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """SigLIP's MLP activation."""
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's MLP activation, x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


_ACT_CODES = {gelu_tanh: 0, quick_gelu: 1}  # the kernel's template parameter


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in f32, rounded once to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def bias_add3_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_bias: torch.Tensor,
                  k_bias: torch.Tensor, v_bias: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(x + b.to(x.dtype) for x, b in ((q, q_bias), (k, k_bias), (v, v_bias)))


def bias_residual_layernorm_ref(
        p: torch.Tensor, bias: Optional[torch.Tensor], h: Optional[torch.Tensor],
        scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
        eps: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = p if bias is None else p + bias.to(p.dtype)
    h = x if h is None else h + x
    return h, None if scale is None else layer_norm(h, scale, shift, eps)


def bias_act_ref(p: torch.Tensor, bias: torch.Tensor,
                 act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    return act((p + bias.to(p.dtype)).float()).to(p.dtype)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("vision_fused")
        ptr, num, big = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vision_bias_add3_bf16.argtypes = [ptr] * 9 + [big, num, ptr]
        lib.vision_residual_ln_bf16.argtypes = [ptr] * 7 + [num, num, ctypes.c_float, ptr]
        lib.vision_bias_act_bf16.argtypes = [ptr] * 3 + [big, num, num, ptr]
        for fn in (lib.vision_bias_add3_bf16, lib.vision_residual_ln_bf16,
                   lib.vision_bias_act_bf16):
            fn.restype = ctypes.c_int
        lib.vision_fused_error_string.argtypes = [ctypes.c_int]
        lib.vision_fused_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(what: str, rows_like: torch.Tensor, **tensors: Optional[torch.Tensor]) -> int:
    """What the kernels take (the module's docstring); ``rows_like`` is the
    (..., width) operand. Returns the width."""
    if rows_like.device.type != "cuda":
        raise KernelRefused(f"{what}: no kernel for device {rows_like.device}")
    width = rows_like.shape[-1] if rows_like.dim() else 0
    if width <= 0 or width % 8:
        raise KernelRefused(f"{what}: width {width} (the kernel takes a multiple of 8)")
    if rows_like.numel() // 8 > 2**31 - 1:
        raise KernelRefused(f"{what}: {rows_like.numel()} values (the kernel indexes its "
                            "16-byte vectors in 32 bits)")
    grad = torch.is_grad_enabled()
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != rows_like.device:
            raise KernelRefused(f"{what}: {name} on {t.device}, the rows on {rows_like.device}")
        if t.dtype != torch.bfloat16:
            raise KernelRefused(f"{what}: {name} is {t.dtype}, the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelRefused(f"{what}: {name} must be contiguous and 16-byte aligned")
        if t.shape[-1] != width or (t.dim() > 1 and t.shape != rows_like.shape):
            raise KernelRefused(f"{what}: {name} {tuple(t.shape)} against rows "
                                f"{tuple(rows_like.shape)}")
        if grad and t.requires_grad:
            raise KernelRefused(f"{what}: the kernel has no backward; {name} requires a "
                                "gradient (a frozen tower runs under no_grad)")
    return width


def _launched(what: str, err: int) -> None:
    global LAUNCHES
    if err:
        raise KernelLaunchFailed(f"{what}: kernel launch failed: "
                                 + _kernel_lib().vision_fused_error_string(err).decode())
    LAUNCHES += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bias_add3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_bias: torch.Tensor,
              k_bias: torch.Tensor, v_bias: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(q + q_bias, k + k_bias, v + v_bias), each rounded once to q's
    dtype; q, k, v of one (..., width) shape, the biases (width,). One
    launch on CUDA tensors; three contiguous outputs."""
    if q.device.type == "cpu":
        return bias_add3_ref(q, k, v, q_bias, k_bias, v_bias)
    width = _check("bias_add3", q, q=q, k=k, v=v, q_bias=q_bias, k_bias=k_bias, v_bias=v_bias)
    for name, b in (("q_bias", q_bias), ("k_bias", k_bias), ("v_bias", v_bias)):
        if b.dim() != 1:
            raise KernelRefused(f"bias_add3: {name} {tuple(b.shape)}, want ({width},)")
    outs = tuple(torch.empty_like(x) for x in (q, k, v))
    if q.numel():
        err = _kernel_lib().vision_bias_add3_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_bias.data_ptr(), k_bias.data_ptr(),
            v_bias.data_ptr(), *(o.data_ptr() for o in outs), q.numel() // width, width,
            _stream(q))
        _launched("bias_add3", err)
    return outs


def bias_residual_layernorm(
        p: torch.Tensor, bias: Optional[torch.Tensor], h: Optional[torch.Tensor],
        scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
        eps: float) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(h_new, y): ``h_new = h + (p + bias)`` with each sum rounded once (no
    bias or no h: that step is left out), ``y`` the LayerNorm of h_new with
    ``scale`` and ``shift`` in f32, rounded once (None when ``scale`` is
    None). p and h (..., width), the rest (width,). One launch on CUDA
    tensors; with neither bias nor h, h_new is p itself and only y is
    written."""
    if p.device.type == "cpu":
        return bias_residual_layernorm_ref(p, bias, h, scale, shift, eps)
    if (scale is None) != (shift is None):
        raise ValueError("bias_residual_layernorm: scale and shift go together")
    width = _check("bias_residual_layernorm", p, p=p, bias=bias, h=h, scale=scale, shift=shift)
    for name, t in (("bias", bias), ("scale", scale), ("shift", shift)):
        if t is not None and t.dim() != 1:
            raise KernelRefused(f"bias_residual_layernorm: {name} {tuple(t.shape)}, "
                                f"want ({width},)")
    if scale is not None and width > LN_MAX_WIDTH:
        raise KernelRefused(f"bias_residual_layernorm: width {width} (a LayerNorm row at most "
                            f"{LN_MAX_WIDTH})")
    h_out = p if bias is None and h is None else torch.empty_like(p)
    y = None if scale is None else torch.empty_like(p)
    if scale is None and h_out is p:
        return p, None
    if p.numel():
        err = _kernel_lib().vision_residual_ln_bf16(
            p.data_ptr(), _ptr(bias), _ptr(h), _ptr(scale), _ptr(shift),
            None if h_out is p else h_out.data_ptr(), _ptr(y), p.numel() // width, width,
            float(eps), _stream(p))
        _launched("bias_residual_layernorm", err)
    return h_out, y


def bias_act(p: torch.Tensor, bias: torch.Tensor,
             act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``act`` of ``p + bias`` (the sum rounded once to p's dtype, then act
    in f32, rounded once); p (..., width), the bias (width,); act
    `gelu_tanh` or `quick_gelu` on CUDA tensors, any function of an f32
    tensor on CPU tensors. One launch on CUDA tensors."""
    if p.device.type == "cpu":
        return bias_act_ref(p, bias, act)
    width = _check("bias_act", p, p=p, bias=bias)
    if bias.dim() != 1:
        raise KernelRefused(f"bias_act: bias {tuple(bias.shape)}, want ({width},)")
    if act not in _ACT_CODES:
        raise KernelRefused(f"bias_act: no kernel for the activation {act!r} (gelu_tanh, "
                            "quick_gelu)")
    out = torch.empty_like(p)
    if p.numel():
        err = _kernel_lib().vision_bias_act_bf16(
            p.data_ptr(), bias.data_ptr(), out.data_ptr(), p.numel() // width, width,
            _ACT_CODES[act], _stream(p))
        _launched("bias_act", err)
    return out
