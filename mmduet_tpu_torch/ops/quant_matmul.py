"""**Kernel B**, the W4A16 matrix product, beside its plain PyTorch version.

Port of `mmduet_tpu/ops/quant_matmul.py::int4_matmul`: ``y @ dequant(qw4,
qs)`` for the group-wise int4 weights of `models/quant.py` (``qw4``
nibble-packed int8 ``(G, g/2, O)`` in split-halves order, ``qs`` bf16
``(G, 1, O)``), returned in f32. The packed bytes are decoded inside the
kernel and never written to device memory unpacked, so the weight traffic
stays at half a byte per value.

Numerics, the grouped form: the products of a group accumulate in f32
from the exact int4 values, the group's partial sum is multiplied by its
scale in f32 and added to the f32 output (the arithmetic of the JAX
package's grouped einsum; its Pallas kernel instead rounds ``q * s`` to
the activation dtype before the product, which differs only for bf16
activations). `int4_matmul_ref` does the same arithmetic in plain
PyTorch.

`int4_matmul` chooses by device: tensors on the CPU take the plain
version; tensors on a CUDA device launch the kernel in
``csrc/int4_matmul.cu`` or raise (`KernelRefused` for operands the
kernel does not take, `KernelLaunchFailed` for a refused launch). There
is no route from a CUDA tensor to the plain version. The kernel has no
backward, so an activation that requires a gradient is refused under
grad mode; the plain version is differentiable through autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .attention import KernelLaunchFailed, KernelRefused

# Kernel launches since the last reset to 0: only the CUDA branch of
# `int4_matmul` adds to it, once per call (a call whose groups are split
# over blocks also runs the kernel that adds the partial outputs).
B_LAUNCHES = 0

GROUP_SIZES = (16, 32, 64, 128)  # what the kernel takes (its staged rows of y hold whole groups)
GEMV_ROWS = 4  # up to here the CUDA-core kernel, above it the tensor-core one
TARGET_BLOCKS = 528  # 4 blocks for each of the card's 132 SMs

_lib: Optional[ctypes.CDLL] = None


def unpack_groups(qw4: torch.Tensor) -> torch.Tensor:
    """(G, g/2, O) packed -> (G, g, O) int8 in [-8, 7]: all low nibbles,
    then all high nibbles, of each group."""
    lo = ((qw4 & 0x0F) ^ 8) - 8
    return torch.cat([lo, qw4 >> 4], dim=1)


def grouped_product(y: torch.Tensor, q: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``sum_G (y_G @ q_G) * qs_G`` in f32 for ``y (..., G g)``, ``q (G, g,
    O)`` and ``qs (G, 1, O)``: per group, the f32 product, then the scale
    on the group's partial sum. Group by group, so no (rows, G, O) tensor
    of partial sums is made."""
    G, g, O = q.shape
    if G * g != y.shape[-1]:
        raise ValueError(f"int4_matmul: y {tuple(y.shape)} against {G} groups of {g}")
    yg = y.reshape(-1, G, g).float()
    out = torch.zeros((yg.shape[0], O), dtype=torch.float32, device=y.device)
    for i in range(G):
        out = out + torch.matmul(yg[:, i], q[i].float()) * qs[i].float()
    return out.reshape(*y.shape[:-1], O)


def int4_matmul_ref(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `int4_matmul`: ``(..., H)`` times packed
    ``(G, g/2, O)`` -> ``(..., O)`` f32, the `grouped_product` with the
    exact int4 values."""
    return grouped_product(y, unpack_groups(qw4), qs)


def split_groups(R: int, G: int, O: int) -> int:
    """Over how many blocks the kernel splits the G groups of one output
    tile, so that about `TARGET_BLOCKS` blocks run: 1 when the output
    tiles alone are enough."""
    if R <= GEMV_ROWS:
        tiles = -(-O // 256)
    else:
        tiles = -(-O // 128) * -(-R // 64)
    want = min(G, max(1, TARGET_BLOCKS // tiles))
    per = -(-G // want)
    return -(-G // per)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int4_matmul")
        lib.int4_matmul_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.int4_matmul_bf16.restype = ctypes.c_int
        lib.int4_matmul_error_string.argtypes = [ctypes.c_int]
        lib.int4_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor) -> Tuple[int, int, int, int]:
    """What the kernel takes; returns (R, H, O, g)."""
    if qw4.ndim != 3:
        raise KernelRefused(f"int4_matmul: qw4 {tuple(qw4.shape)} is not (G, g/2, O)")
    G, g2, O = qw4.shape
    g, H = 2 * g2, y.shape[-1]
    if G * g != H or tuple(qs.shape) != (G, 1, O):
        raise KernelRefused(
            f"int4_matmul: inconsistent shapes y {tuple(y.shape)}, qw4 "
            f"{tuple(qw4.shape)}, qs {tuple(qs.shape)}")
    if g not in GROUP_SIZES:
        raise KernelRefused(f"int4_matmul: group size {g} (the kernel takes {GROUP_SIZES})")
    if O % 16:
        raise KernelRefused(f"int4_matmul: {O} output columns (the kernel takes a multiple of 16)")
    for name, t, dtype in (("y", y, torch.bfloat16), ("qw4", qw4, torch.int8),
                           ("qs", qs, torch.bfloat16)):
        if t.device != y.device:
            raise KernelRefused(f"int4_matmul: {name} on {t.device}, y on {y.device}")
        if t.dtype != dtype:
            raise KernelRefused(f"int4_matmul: {name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelRefused(f"int4_matmul: {name} must be contiguous and 16-byte aligned")
    if y.requires_grad and torch.is_grad_enabled():
        raise KernelRefused(
            "int4_matmul: the kernel has no backward; an activation that requires a "
            "gradient cannot go through int4 weights on a CUDA device")
    R = y.numel() // H
    return R, H, O, g


def int4_matmul(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``(..., H)`` times packed ``(G, g/2, O)`` with scales ``(G, 1, O)``
    -> ``(..., O)`` f32.

    CPU tensors: the plain version. CUDA tensors: kernel B, which takes
    bf16 activations, contiguous 16-byte aligned operands, a group size
    of 16, 32, 64 or 128 and a column count that is a multiple of 16;
    anything else raises `KernelRefused`, a refused launch
    `KernelLaunchFailed`. Any number of rows goes in one call: the blocks
    tile the rows, so the row chunking of the TPU kernel has no
    counterpart."""
    global B_LAUNCHES
    if y.device.type == "cpu":
        return int4_matmul_ref(y, qw4, qs)
    if y.device.type != "cuda":
        raise KernelRefused(f"int4_matmul: no kernel for device {y.device}")
    R, H, O, g = _check(y, qw4, qs)
    out = torch.empty((*y.shape[:-1], O), dtype=torch.float32, device=y.device)
    if R == 0:
        return out
    ks = split_groups(R, H // g, O)
    partial = (torch.empty((ks, R, O), dtype=torch.float32, device=y.device)
               if ks > 1 else out)
    lib = _kernel_lib()
    err = lib.int4_matmul_bf16(
        y.data_ptr(), qw4.data_ptr(), qs.data_ptr(), out.data_ptr(), partial.data_ptr(),
        R, H, O, g, ks, torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err:
        raise KernelLaunchFailed(
            "int4_matmul: kernel launch failed: " + lib.int4_matmul_error_string(err).decode())
    B_LAUNCHES += 1
    return out
