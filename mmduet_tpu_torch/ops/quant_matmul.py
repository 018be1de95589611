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
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .attention import KernelLaunchFailed, KernelRefused

# Kernel launches since the last reset to 0: only the CUDA branch of
# `int4_matmul` adds to it, once per call (one call is one launch, a call
# whose groups are split over blocks included).
B_LAUNCHES = 0

GROUP_SIZES = (16, 32, 64, 128)  # what the kernel takes (its staged rows of y hold whole groups)
GEMV_ROWS = 4  # up to here the CUDA-core kernel, above it the tensor-core one
NUM_SMS = 132  # the H100 SXM's streaming multiprocessors
TARGET_BLOCKS = 4 * NUM_SMS  # the GEMV's blocks: 4 for each SM
GEMV_COLS = 256  # output columns of a GEMV block
TILE_COLS = 192  # output columns of a tensor-core block: three warpgroups of 64
PARTIAL_STEPS = 6  # a split block's partial tile costs about as much as 6 of its k-steps


class Int4Plan(NamedTuple):
    """How kernel B cuts one call: ``path`` "gemv" (CUDA cores, R <= 4) or
    "wgmma" (tensor cores); a block owns ``rows`` x ``cols`` outputs and
    ``per`` of the call's ``units`` k-steps (of ``step`` values: a group
    for the GEMV, ``max(g, 64)`` values for the tensor cores); ``ks``
    blocks share an output tile's steps and add their partials in split
    order; ``grid`` is (column tiles, row tiles, ks)."""

    path: str
    rows: int
    cols: int
    step: int
    units: int
    per: int
    ks: int
    grid: Tuple[int, int, int]

    @property
    def tiles(self) -> int:
        """Output tiles, one ticket each when the steps are split."""
        return self.grid[0] * self.grid[1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(units: int, want: int) -> Tuple[int, int]:
    """(k-steps a block, blocks) for about ``want`` blocks over ``units``."""
    per = _cdiv(units, want)
    return per, _cdiv(units, per)


@functools.lru_cache(maxsize=1024)
def int4_plan(R: int, H: int, O: int, g: int) -> Int4Plan:
    """Kernel B's cut of an (R, H) x (H, O) product with groups of g (the
    kernel's launch computes the same from R, H, O, g and ``ks``).

    The GEMV splits the groups so that about `TARGET_BLOCKS` blocks run.
    The tensor cores take one block an SM (up to 161 KB of shared memory),
    so a call runs in waves of `NUM_SMS` blocks; they split the k-steps
    where that shortens the waves' total: the fewest whole waves times a
    block's steps, with a split block's partial tile counted as
    `PARTIAL_STEPS` more steps and the combine as ``ks``. Their ``rows``
    (64 or 104, the instantiations the launch has) go to the launch."""
    if R <= GEMV_ROWS:
        units = H // g
        tiles = _cdiv(O, GEMV_COLS)
        per, ks = _split(units, min(units, max(1, TARGET_BLOCKS // tiles)))
        return Int4Plan("gemv", R, GEMV_COLS, g, units, per, ks, (tiles, 1, ks))
    # the rows of y a block takes (wgmma's N): 64 up to 64 rows, else 104,
    # which is what the registers allow at three warpgroups
    rows, step = 64 if R <= 64 else 104, max(g, 64)
    units = _cdiv(H, step)
    grid = (_cdiv(O, TILE_COLS), _cdiv(R, rows))
    tiles = grid[0] * grid[1]

    def cost(split):
        per, ks = split
        return (_cdiv(tiles * ks, NUM_SMS) * (per + (PARTIAL_STEPS if ks > 1 else 0))
                + (ks if ks > 1 else 0))

    per, ks = min((_split(units, want) for want in range(1, units + 1)),
                  key=lambda split: (cost(split), split[1]))
    return Int4Plan("wgmma", rows, TILE_COLS, step, units, per, ks, (*grid, ks))


# The split's scratch per device: f32 partials and int32 tickets (zeros,
# and left zero by every launch), grown when a launch needs more. Launches
# that share it run one after another on one stream, so a call allocates
# only its output. The one-stream rule: kernel B runs on one stream at a
# time, the decoder's (as kernel A, `ops.attention`); the side stream of
# `LiveInferEngine.stream_video` runs the vision tower, which never
# launches B (its int8 leaves have no kernel).
_split_scratch: dict = {}


def _split_ptrs(device, plan: Int4Plan, R: int, O: int) -> Tuple[int, int]:
    """(partials pointer, tickets pointer) for a call cut by ``plan``; (0,
    0) when its steps are not split."""
    if plan.ks == 1:
        return 0, 0
    part, tickets = reserve_split_scratch(device, *split_scratch_numel(plan, R, O))
    return part.data_ptr(), tickets.data_ptr()


def split_scratch_numel(plan: Int4Plan, R: int, O: int) -> Tuple[int, int]:
    """(f32 partials, int32 tickets) of a call cut by ``plan``; (0, 0) when
    its steps are not split."""
    return (plan.ks * R * O, plan.tiles) if plan.ks > 1 else (0, 0)


def reserve_split_scratch(device, n_part: int, n_tickets: int):
    """Kernel B's split scratch of ``device``, grown to at least ``n_part``
    f32 partials and ``n_tickets`` int32 tickets (zeros), made anew when it
    grows (`ops.attention.reserve_split_scratch` for kernel A)."""
    part, tickets = _split_scratch.get(device, (None, None))
    if part is None or part.numel() < n_part or tickets.numel() < n_tickets:
        part = torch.empty(max(n_part, 0 if part is None else part.numel()),
                           dtype=torch.float32, device=device)
        tickets = torch.zeros(max(n_tickets, 0 if tickets is None else tickets.numel()),
                              dtype=torch.int32, device=device)
        _split_scratch[device] = (part, tickets)
    return part, tickets


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


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int4_matmul")
        lib.int4_matmul_bf16.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    plan = int4_plan(R, H, O, g)
    part, tickets = _split_ptrs(y.device, plan, R, O)
    lib = _kernel_lib()
    err = lib.int4_matmul_bf16(
        y.data_ptr(), qw4.data_ptr(), qs.data_ptr(), out.data_ptr(), part, tickets,
        R, H, O, g, plan.ks, plan.rows, torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err:
        raise KernelLaunchFailed(
            "int4_matmul: kernel launch failed: " + lib.int4_matmul_error_string(err).decode())
    B_LAUNCHES += 1
    return out
