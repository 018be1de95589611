"""Kernel C's algebra on the CPU (`mmduet_tpu_torch.ops.attention`): the
plain backward `flash_full_backward_ref` (the kernels' algebra, tile-free)
and the plain row log-sum-exp `flash_full_lse_ref`, against autograd
through the plain forward, against the JAX oracle's gradients, and against
an emulation of the kernels' tiling (128-row resident tiles of two 64-row
halves, 128-key and 64-query streamed tiles, segment ids padded with -2 and
row statistics padded with zeros, the mask applied only on the tiles that a
warp's 16 rows find to need it, exp2 with the scale folded in, a finite
-1e30 for masked scores).

f32 on both sides, inputs from a numpy seed; differences are summation
order, so everything agrees to 1e-5 absolute."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.ops import attention as jatt
from mmduet_tpu_torch.ops import attention as tatt

ATOL = 1e-5
NH, KH, HD = 4, 2, 128
LOG2E = 1.4426950408889634
NEG = -1e30
PADS = ["left", "right", "none"]


def _inputs(T, pad_side, B=2):
    r = np.random.RandomState(T + len(pad_side))
    q, k, v, dout = (torch.tensor(r.randn(B, T, h, HD).astype(np.float32) * 0.3)
                     for h in (NH, KH, KH, NH))
    mask = np.ones((B, T), bool)
    for b, n in enumerate((T - 5, T - 17)):  # two pad lengths
        if pad_side == "left":
            mask[b, : T - n] = False
        elif pad_side == "right":
            mask[b, n:] = False
    return q, k, v, dout, (None if pad_side == "none" else torch.tensor(mask))


def _forward(q, k, v, mask):
    B, T = q.shape[:2]
    seg = tatt._segments(mask, B, T, q.device)
    return seg, tatt.flash_full_attention_ref(q, k, v, mask), tatt.flash_full_lse_ref(q, k, seg)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0.0)


@pytest.mark.parametrize("pad_side", PADS)
@pytest.mark.parametrize("T", [40, 200])
def test_backward_ref_matches_autograd(pad_side, T):
    q, k, v, dout, mask = _inputs(T, pad_side)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tatt.flash_full_attention_ref(*leaves, mask)
    out.backward(dout)
    seg, o, lse = _forward(q, k, v, mask)
    got = tatt.flash_full_backward_ref(q, k, v, seg, o, lse, dout)
    for g, leaf in zip(got, leaves):
        _close(g, leaf.grad)


@pytest.mark.parametrize("pad_side", PADS)
@pytest.mark.parametrize("T", [40, 200])
def test_backward_ref_matches_jax_oracle(pad_side, T):
    """The gradients of the JAX wrapper over the stock kernel's jnp
    reference (`mha_reference_no_custom_vjp`), every row, pad rows too."""
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference_no_custom_vjp

    q, k, v, dout, mask = _inputs(T, pad_side)
    jm = None if mask is None else jnp.asarray(mask.numpy())

    def jloss(q_, k_, v_):
        out = jatt.flash_full_attention(q_, k_, v_, jm, _impl=mha_reference_no_custom_vjp)
        return jnp.sum(out * dout.numpy())

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    seg, o, lse = _forward(q, k, v, mask)
    got = tatt.flash_full_backward_ref(q, k, v, seg, o, lse, dout)
    for g, w in zip(got, want):
        _close(g, w, atol=2e-5)  # the bound of the forward's oracle test


@pytest.mark.parametrize("pad_side", PADS)
@pytest.mark.parametrize("T", [40, 200])
def test_lse_ref_is_logsumexp_of_the_masked_scores(pad_side, T):
    """Against numpy, written out independently; and exp(S - lse) V is the
    plain forward's output."""
    q, k, v, _, mask = _inputs(T, pad_side)
    seg, o, lse = _forward(q, k, v, mask)
    B, group = q.shape[0], NH // KH
    kr = k.numpy().repeat(group, axis=2)
    s = np.einsum("bthd,bshd->bhts", q.numpy(), kr) / math.sqrt(HD)
    sg = seg.numpy()
    vis = (np.arange(T)[:, None] >= np.arange(T)[None, :])[None] & (sg[:, :, None] == sg[:, None, :])
    s = np.where(vis[:, None], s, -np.inf)
    top = s.max(-1, keepdims=True)
    want = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (B, NH, T) and lse.dtype == torch.float32
    _close(lse, want)
    p = np.exp(s - lse.numpy()[..., None])
    _close(o, np.einsum("bhts,bshd->bthd", p, v.numpy().repeat(group, axis=2)))


# ---------------------------------------------------------------------------
# the kernels' tiling, emulated
# ---------------------------------------------------------------------------

BM, BKV, BQS = 128, 128, 64  # resident rows (two halves of 64), streamed keys, streamed queries
WARP = 16  # rows of a warp: the unit that decides whether a tile needs the mask


def _rows(x, r0, n):
    """Rows [r0, r0 + n) with zeros past the end, as a TMA box brings them."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    got = x[r0:r0 + n]
    out[: got.shape[0]] = got
    return out


def _ids(seg_row, r0, n):
    """The padded segment ids of rows [r0, r0 + n): -2 past T."""
    out = torch.full((n,), -2, dtype=torch.int64)
    got = seg_row[r0:r0 + n]
    out[: got.shape[0]] = got
    return out


def _warp_rows_id(ids):
    """The id a warp's 16 rows share, else -1 (`warp_rows_id`)."""
    return int(ids[0]) if bool((ids == ids[0]).all()) else -1


def _tile_id(ids):
    """The id a streamed tile's rows share, -2 counting as any, else -1 (`tile_id`)."""
    return int(ids[0]) if bool(((ids == ids[0]) | (ids == -2)).all()) else -1


def _tiled_forward(q, k, v, seg):
    """flash_full_fwd_kernel: one (q head, 128-query block, lane) per block,
    128-key tiles up to the diagonal; a warp's 16 rows decide together."""
    B, T, nh, hd = q.shape
    group = nh // k.shape[2]
    c = LOG2E / math.sqrt(hd)
    o = torch.zeros_like(q)
    lse = torch.zeros((B, nh, T))
    masked_tiles = plain_tiles = 0
    for b in range(B):
        for h in range(nh):
            for qt in range(-(-T // BM)):
                for r0 in range(qt * BM, (qt + 1) * BM, WARP):
                    row = torch.arange(r0, r0 + WARP)
                    rseg = _ids(seg[b], r0, WARP)
                    qid = _warp_rows_id(rseg)
                    qa = _rows(q[b, :, h], r0, WARP)
                    m = torch.full((WARP,), NEG)
                    l = torch.zeros(WARP)
                    acc = torch.zeros(WARP, hd)
                    for j in range(qt + 1):
                        k0 = j * BKV
                        s = qa @ _rows(k[b, :, h // group], k0, BKV).T
                        ss = _ids(seg[b], k0, BKV)
                        if j == qt or _tile_id(ss) != qid or qid < 0:
                            key = torch.arange(k0, k0 + BKV)
                            vis = (key[None] <= row[:, None]) & (ss[None] == rseg[:, None])
                            s = torch.where(vis, s, torch.full_like(s, NEG))
                            masked_tiles += 1
                        else:
                            plain_tiles += 1
                        mn = torch.maximum(m, s.max(1).values)
                        alpha = torch.exp2((m - mn) * c)
                        mc = torch.where(mn > 0.5 * NEG, mn * c, torch.zeros_like(mn))
                        p = torch.exp2(s * c - mc[:, None])
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ _rows(v[b, :, h // group], k0, BKV)
                        m = mn
                    n = max(0, min(WARP, T - r0))
                    o[b, r0:r0 + n, h] = (acc / l[:, None])[:n]
                    lse[b, h, r0:r0 + n] = ((m * c + torch.log2(l)) * math.log(2.0))[:n]
    return o, lse, masked_tiles, plain_tiles


def _rowstats(lse, delta, T):
    """flash_full_pre_kernel's output: the LSE in log2 units and D, zeros past T."""
    Tp = -(-T // BM) * BM
    out = torch.zeros((2,) + tuple(lse.shape[:2]) + (Tp,))
    out[0, :, :, :T] = lse * LOG2E
    out[1, :, :, :T] = delta
    return out


def _tiled_dkdv(q, k, v, seg, lse, delta, dout):
    """flash_full_dkdv_kernel and the reduction: one (q head, 128-key block,
    lane) per block, two warpgroups of 64 keys, 64-query tiles from the
    diagonal on; per-q-head partials summed in q-head order. Also returns
    every (lane, q head, 64-key tile, 64-query tile) that was computed."""
    B, T, nh, hd = q.shape
    kh = k.shape[2]
    group = nh // kh
    c = LOG2E / math.sqrt(hd)
    stats = _rowstats(lse, delta, T)
    dk_part = torch.zeros(B, T, nh, hd)
    dv_part = torch.zeros(B, T, nh, hd)
    visited = []
    for b in range(B):
        for h in range(nh):
            hk = h // group
            for kt in range(-(-T // BM)):
                for wg in range(2):
                    kw0 = kt * BM + wg * 64
                    for it in range(2 * kt, -(-T // BQS)):
                        q0 = it * BQS
                        if q0 + BQS - 1 < kw0:
                            continue
                        visited.append((b, h, kw0 // 64, it))
                        qa, doa = _rows(q[b, :, h], q0, BQS), _rows(dout[b, :, h], q0, BQS)
                        lse2, dl = stats[0, b, h, q0:q0 + BQS], stats[1, b, h, q0:q0 + BQS]
                        ss = _ids(seg[b], q0, BQS)
                        qid = _tile_id(ss)
                        t = torch.arange(q0, q0 + BQS)
                        for r0 in range(kw0, kw0 + 64, WARP):  # a warp's 16 keys
                            key = torch.arange(r0, r0 + WARP)
                            kseg = _ids(seg[b], r0, WARP)
                            kid = _warp_rows_id(kseg)
                            ka, va = _rows(k[b, :, hk], r0, WARP), _rows(v[b, :, hk], r0, WARP)
                            p = torch.exp2((ka @ qa.T) * c - lse2[None])
                            if q0 < r0 + WARP - 1 or qid != kid or kid < 0:
                                vis = (key[:, None] <= t[None]) & (ss[None] == kseg[:, None])
                                p = torch.where(vis, p, torch.zeros_like(p))
                            n = max(0, min(WARP, T - r0))
                            dv_part[b, r0:r0 + n, h] += (p @ doa)[:n]
                            dk_part[b, r0:r0 + n, h] += ((p * (va @ doa.T - dl[None])) @ qa)[:n]
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for g in range(group):  # the reduction's order
        dk += dk_part.reshape(B, T, kh, group, hd)[:, :, :, g]
        dv += dv_part.reshape(B, T, kh, group, hd)[:, :, :, g]
    return dk / math.sqrt(hd), dv, visited


def _tiled_dq(q, k, v, seg, lse, delta, dout):
    """flash_full_dq_kernel: the forward's blocks and key tiles."""
    B, T, nh, hd = q.shape
    group = nh // k.shape[2]
    c = LOG2E / math.sqrt(hd)
    stats = _rowstats(lse, delta, T)
    dq = torch.zeros_like(q)
    for b in range(B):
        for h in range(nh):
            for qt in range(-(-T // BM)):
                for r0 in range(qt * BM, (qt + 1) * BM, WARP):
                    n = max(0, min(WARP, T - r0))
                    row = torch.arange(r0, r0 + WARP)
                    rseg = _ids(seg[b], r0, WARP)
                    qid = _warp_rows_id(rseg)
                    qa, doa = _rows(q[b, :, h], r0, WARP), _rows(dout[b, :, h], r0, WARP)
                    lse2, dl = stats[0, b, h, r0:r0 + WARP], stats[1, b, h, r0:r0 + WARP]
                    acc = torch.zeros(WARP, hd)
                    for j in range(qt + 1):
                        k0 = j * BKV
                        ka, va = (_rows(x[b, :, h // group], k0, BKV) for x in (k, v))
                        ss = _ids(seg[b], k0, BKV)
                        p = torch.exp2((qa @ ka.T) * c - lse2[:, None])
                        if j == qt or _tile_id(ss) != qid or qid < 0:
                            key = torch.arange(k0, k0 + BKV)
                            vis = (key[None] <= row[:, None]) & (ss[None] == rseg[:, None])
                            p = torch.where(vis, p, torch.zeros_like(p))
                        acc += (p * (doa @ va.T - dl[:, None])) @ ka
                    dq[b, r0:r0 + n, h] = acc[:n] / math.sqrt(hd)
    return dq


@pytest.mark.parametrize("pad_side", PADS)
@pytest.mark.parametrize("T", [40, 200, 333])
def test_tiled_forward_matches_ref(pad_side, T):
    """Online softmax on exp2 over 128-key tiles with the mask on flagged
    tiles only: O and the natural-log LSE; a left-padded real row passes
    through fully masked tiles first (m stays -1e30, l stays 0)."""
    q, k, v, _, mask = _inputs(T, pad_side)
    seg, o, lse = _forward(q, k, v, mask)
    got_o, got_lse, masked_tiles, plain_tiles = _tiled_forward(q, k, v, seg)
    _close(got_o, o)
    _close(got_lse, lse)
    if T == 333:
        assert plain_tiles > 0  # some tile skipped the visibility test
    if T == 333 and pad_side == "left":
        diagonal = 2 * NH * 3 * (BM // WARP)  # lanes x heads x blocks x warps
        assert masked_tiles > diagonal  # the tiles across the pad boundary too


@pytest.mark.parametrize("pad_side", PADS)
@pytest.mark.parametrize("T", [40, 200, 333])
def test_tiled_backward_matches_ref(pad_side, T):
    q, k, v, dout, mask = _inputs(T, pad_side)
    seg, o, lse = _forward(q, k, v, mask)
    want = tatt.flash_full_backward_ref(q, k, v, seg, o, lse, dout)
    delta = (dout * o).sum(-1).permute(0, 2, 1)
    dk, dv, _ = _tiled_dkdv(q, k, v, seg, lse, delta, dout)
    dq = _tiled_dq(q, k, v, seg, lse, delta, dout)
    for g, w in zip((dq, dk, dv), want):
        _close(g, w)


@pytest.mark.parametrize("T", [40, 64, 65, 129, 200, 333, 640])
def test_dkdv_tiling_covers_every_tile_once(T):
    """Every (64-key tile, q head, 64-query tile) at or below the diagonal
    is computed exactly once, and nothing above it."""
    B = 1
    q, k, v, dout = (torch.zeros(B, T, h, HD) for h in (NH, KH, KH, NH))
    seg = torch.ones((B, T), dtype=torch.int32)
    zeros = torch.zeros(B, NH, T)
    _, _, visited = _tiled_dkdv(q, k, v, seg, zeros, zeros, dout)
    n = -(-T // 64)
    want = sorted((0, h, kt, qt) for h in range(NH) for kt in range(n) for qt in range(kt, n))
    assert sorted(visited) == want


def test_partial_sum_order_is_the_q_head_order():
    """The fixed order of the GQA sum: the plain backward adds the group's
    heads in ascending order, so its f32 result is bit-equal to that sum
    and to a second run."""
    q, k, v, dout, mask = _inputs(40, "right")
    seg, o, lse = _forward(q, k, v, mask)
    a = tatt.flash_full_backward_ref(q, k, v, seg, o, lse, dout)
    b = tatt.flash_full_backward_ref(q, k, v, seg, o, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert tatt.FULL_BWD_KERNELS == ("bwd_pre", "bwd_dkdv", "bwd_reduce", "bwd_dq")


def test_kernel_segments_are_padded_and_kept_per_mask():
    """The ids the kernels read: padded to a multiple of 128 with -2, the
    mask's values below T; the same tensor for the same mask object (a
    decoder's layers all pass one), a new one once the mask changed in
    place or another mask came."""
    mask = torch.ones((2, 130), dtype=torch.bool)
    mask[1, 100:] = False
    seg = tatt._kernel_segments(mask, 2, 130, "cpu")
    assert seg.shape == (2, 256) and seg.dtype == torch.int32
    assert torch.equal(seg[:, :130], mask.int()) and bool((seg[:, 130:] == -2).all())
    assert tatt._kernel_segments(mask, 2, 130, "cpu") is seg
    mask[0, 0] = False
    changed = tatt._kernel_segments(mask, 2, 130, "cpu")
    assert changed is not seg and changed[0, 0] == 0
    other = tatt._kernel_segments(mask.clone(), 2, 130, "cpu")
    assert other is not changed and torch.equal(other, changed)
    assert bool((tatt._kernel_segments(None, 1, 5, "cpu")[:, :5] == 1).all())
