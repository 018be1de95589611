"""The tolerances that hold each CUDA kernel against its plain version.

The kernel runs on bf16 operands; the plain version runs on the same
values in f32, so what separates them is the kernel's own bf16 rounding
and its order of summation. `chip_smoke.py` and `tests/test_torch_cuda.py`
check the kernels with these bounds; the `*_dropped` helpers build a wrong
plain version that a bound must refuse (the check that it is tight).

**Kernel A**, per output row (one query row of one head, hd values):
``|kernel - plain| <= ROW_REL * max|plain row| + ROW_ABS``. The bf16 output
rounding is at most half an ulp, 2^-9 of |x| <= 2^-9 of the row's max;
ROW_ABS covers f32 summation in another order.

**Kernel C**, per element of o, dq, dk, dv:
``|kernel - plain| <= 2^-8 |plain| + 2^-9 * SIGMAS * rms + FULL_ABS``.
Each element is a sum of terms (p v for o, p dO for dv, dS k and dS q for
dq and dk, summed over keys or over query rows and the group's heads). The
kernel rounds one factor of every term to bf16 (p or dS: relative error at
most half an ulp, 2^-8, independent between terms), so the sum's error
has a standard deviation of at most 2^-8 * rms / sqrt(3), rms = sqrt(sum
of squared terms), computed from the plain f32 softmax; 2^-9 * SIGMAS *
rms with SIGMAS = 8 is 6.9 of those. The backward also takes D =
rowsum(dO * O) from the bf16 output O, whose error moves every dS of a row
together: that adds sqrt(sum_d dO^2 (|o| + rms_o)^2) * |sum_s P k| to dq's
rms (one error for the whole row) and P times that root to each dS of
dk's. Half an ulp of the bf16 output adds up to 2^-8 * |plain|. dK and dV
sum over up to T query rows of 7 heads: a bound on the sum of |terms|
would grow with that count and let a lost query tile through, while this
one grows as its square root.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

ROW_REL, ROW_ABS = 2.0**-8, 1e-5
SIGMAS, FULL_ABS = 8.0, 1e-5

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def row_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel A: the largest ``|got - want|`` over its row bound (<= 1
    passes); rows run along the last axis."""
    bound = ROW_REL * want.abs().amax(dim=-1, keepdim=True) + ROW_ABS
    return ((got.float() - want).abs() / bound).max().item()


@torch.no_grad()
def full_probs(q, k, mask, drop_keys: slice = slice(0, 0)) -> torch.Tensor:
    """Kernel C's plain softmax P (B, kh, g, T, T) in f32; ``drop_keys``
    masks a range of keys as well (a forward that lost a key tile)."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    idx = torch.arange(T, device=q.device)
    vis = (idx[:, None] >= idx[None, :])[None] & (mask[:, :, None] == mask[:, None, :])
    vis[:, :, drop_keys] = False
    s = torch.einsum("btkgh,bskh->bkgts", q.float().reshape(B, T, kh, nh // kh, hd),
                     k.float()) / math.sqrt(hd)
    return torch.softmax(s.masked_fill_(~vis[:, None, None], -1e30), dim=-1)


@torch.no_grad()
def full_attention_rms(q, k, v, mask, dout, out) -> Grads:
    """The rms of kernel C's bound for every element of o, dq, dk, dv
    (``out`` is the kernel's output, standing in for |o|)."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    shape5 = (B, T, kh, nh // kh, hd)
    p = full_probs(q, k, mask)
    qf, kf, vf = q.float().reshape(shape5), k.float(), v.float()
    dof, of = dout.float().reshape(shape5), out.float().reshape(shape5)
    scale = 1.0 / math.sqrt(hd)
    p2 = p.square()
    o = torch.einsum("bkgts,bskh->btkgh", p2, vf.square()).sqrt()
    dv = torch.einsum("bkgts,btkgh->bskh", p2, dof.square()).sqrt()
    del p2
    d_err = (dof.square() * (of.abs() + o).square()).sum(-1).sqrt()  # (B, T, kh, g)
    pk = torch.einsum("bkgts,bskh->btkgh", p, kf).abs()
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)  # (B, kh, g, T)
    ds = torch.einsum("btkgh,bskh->bkgts", dof, vf).sub_(delta[..., None]).mul_(p)
    dq = torch.einsum("bkgts,bskh->btkgh", ds.square(), kf.square()).sqrt()
    dq = (dq + d_err[..., None] * pk) * scale
    u = ds.abs_().add_(p.mul_(d_err.permute(0, 2, 3, 1)[..., None]))
    dk = torch.einsum("bkgts,btkgh->bskh", u.square_(), qf.square()).sqrt() * scale
    return o.reshape(B, T, nh, hd), dq.reshape(B, T, nh, hd), dk, dv


def full_attention_ratio(got: torch.Tensor, want: torch.Tensor, rms: torch.Tensor) -> float:
    """Kernel C: the largest ``|got - want|`` over its element bound (<= 1
    passes)."""
    bound = 2.0**-8 * want.abs() + 2.0**-9 * SIGMAS * rms + FULL_ABS
    return ((got.float() - want).abs() / bound).max().item()


@torch.no_grad()
def full_attention_dropped(q, k, v, mask, dout, tile: slice) -> Grads:
    """Kernel C's plain o, dq, dk, dv in f32, each with one tile left out
    of the sum its kernel's tile loop makes: o is the softmax without keys
    ``tile`` (a forward that skipped a key tile), dq leaves out the terms
    of keys ``tile`` (a dQ kernel that skipped one), dk and dv leave out
    the terms of query rows ``tile`` (a dK/dV kernel that skipped a query
    tile). An empty ``tile`` gives the true gradients."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    shape5 = (B, T, kh, nh // kh, hd)
    qf, kf, vf = q.float().reshape(shape5), k.float(), v.float()
    dof = dout.float().reshape(shape5)
    scale = 1.0 / math.sqrt(hd)
    o_drop = torch.einsum("bkgts,bskh->btkgh", full_probs(q, k, mask, tile), vf)
    p = full_probs(q, k, mask)
    o = torch.einsum("bkgts,bskh->btkgh", p, vf)
    delta = (dof * o).sum(-1).permute(0, 2, 3, 1)  # (B, kh, g, T)
    ds = torch.einsum("btkgh,bskh->bkgts", dof, vf).sub_(delta[..., None]).mul_(p)
    rows = torch.ones(T, device=q.device)
    rows[tile] = 0.0
    dv = torch.einsum("bkgts,btkgh->bskh", p.mul_(rows[:, None]), dof)
    dk = torch.einsum("bkgts,btkgh->bskh", ds * rows[:, None], qf) * scale
    dq = torch.einsum("bkgts,bskh->btkgh", ds.mul_(rows), kf) * scale
    return o_drop.reshape(B, T, nh, hd), dq.reshape(B, T, nh, hd), dk, dv
