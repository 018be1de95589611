"""Kernels A (bf16 and int8 cache) and D as they cut their work, emulated on
the CPU against the JAX package, and the build key of their shared header.

- Kernel A: 64-row query tiles of one (lane, kv head); the cache cut into
  spans of `attention.decode_split_span` slots (or a span given here), one
  block a (tile, span); the chunk's 64-key tiles first (span 0 only), masked
  per row at min(t_real, q_offset + t + 1), then the span's cache tiles,
  masked at the span's end, and only a tile that reaches past the least
  limit of the block's rows masked; an online softmax on exp2 with the scale folded
  in; blocks past the lane's cursor do nothing; with one live span the
  block writes its rows, else the partials (acc, m, l) are combined in span
  order. Held against the JAX package's Pallas kernel in interpret mode and
  against the port's `attend_split`, with empty spans at cache_len 0 and 1,
  a cursor exactly at a span edge and q_offset > 0; every visible (row,
  key) pair is taken exactly once. The int8 cache takes the same tiles, its
  K scale on S's columns (zero past the span's end, as the kernel loads
  them), the row sum of the unscaled p, and its V scale on p; it is held
  against the Pallas kernel's ``quantized=True`` variant with scales
  poisoned past each cursor (the references get them zeroed), and, with p
  * v_scale rounded to bf16 as the kernel rounds it, within the row bound
  and its rms term (`ops/bounds.py`), which a lost split or key tile fails.
- Kernel D: 192-query blocks of three 64-row warpgroups, 128-key tiles, Q K^T
  over ceil(hd / 16) steps of 16 columns and P V over N = hd (64, 72) or the
  next of 80 and 128, the columns past hd and the rows past T zeros; only the
  last key tile masked. Held against the JAX `flash_vision_attention`'s
  plain route (``_impl=mha_reference``) at hd 64, 72, 128 and T 1, 50, 729.

f32 throughout, inputs from a numpy seed: the emulations differ from the
references by summation order only, so they agree to 2e-5 absolute (1e-5
relative), the tolerance of `tests/test_torch_attention.py`."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from mmduet_tpu.ops.attention import flash_decode_attention as jax_flash_decode
from mmduet_tpu.ops.attention import flash_vision_attention as jax_flash_vision
from mmduet_tpu_torch.ops import _build, attention, bounds

ATOL, RTOL = 2e-5, 1e-5
LOG2E = 1.4426950408889634
NEG = -1e30
TILE = 64  # kernel A's query rows and keys a tile, and a warpgroup's rows


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x with zeros past its end, as a copy brings them."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    got = x[r0:r0 + n]
    out[: got.shape[0]] = got
    return out


def _online(m, l, acc, s, v, c, vscale=None, round_p=False):
    """One tile into a row block's online softmax on exp2, as the kernels
    do it: a row with nothing visible yet subtracts 0, not its -1e30. The
    row sum takes p; the value product p times ``vscale`` (an int8 cache's
    V scales, per key), rounded to bf16 if ``round_p``. Rows and keys are
    the last two dims of ``s`` (leading dims: blocks side by side)."""
    mn = torch.maximum(m, s.max(-1).values)
    alpha = torch.exp2((m - mn) * c)
    mc = torch.where(mn > 0.5 * NEG, mn * c, torch.zeros_like(mn))
    p = torch.exp2(s * c - mc[..., None])
    pv = p if vscale is None else p * vscale
    if round_p:
        pv = pv.bfloat16().float()
    return mn, l * alpha + p.sum(-1), acc * alpha[..., None] + pv @ v


# ---------------------------------------------------------------------------
# kernel A, bf16 cache
# ---------------------------------------------------------------------------


def _emulate_decode(q, kc, vc, ck, cv, cl, tr, layer, qo, split=None, ks=None, vs=None,
                    round_p=False, lose_span=None):
    """flash_decode_tc_kernel over its grid, one (lane, kv head) at a time
    and its 64-row tiles side by side; returns the output and, per (lane,
    kv head), the count of times each (GQA row, key) pair was taken
    unmasked (keys: cache slots, then chunk columns). ``split`` (span_min,
    nsplit) replaces `attention.decode_split`; each lane cuts its cache as
    `attention.lane_spans` says. ``ks`` / ``vs`` (L, B, kh, S): the cache is
    int8 values (here in f32) with these scales, read as zeros at and past
    a span's end; ``round_p`` rounds the value product's p (times vs) to
    bf16, as the kernel does. ``lose_span`` k: a faulty kernel that leaves
    span k out of the combine."""
    B, T, nh, hd = q.shape
    kh, S, Tc = kc.shape[2], kc.shape[3], ck.shape[2]
    group = nh // kh
    rows = group * T
    span_min, nsplit = split or attention.decode_split(rows, S)
    n_tiles = -(-rows // TILE)
    R = n_tiles * TILE
    c = LOG2E / math.sqrt(hd)
    out = torch.zeros_like(q)
    taken = torch.zeros((B, kh, rows, S + Tc), dtype=torch.int64)
    row = torch.arange(R)
    real = row < rows
    row0 = torch.arange(n_tiles) * TILE
    last = torch.clamp(row0 + TILE, max=rows) - 1
    one_g = row0 // T == last // T  # a tile's rows are of one q head
    t_max = torch.where(one_g, last % T, torch.full_like(last, T - 1))
    for b in range(B):
        clen, treal, qoff = int(cl[b]), int(tr[b]), int(qo[b])
        span, n_live = attention.lane_spans(clen, span_min, nsplit)
        assert n_live <= nsplit
        # a row's causal limit in the chunk (rows past `rows` are never stored)
        limit = torch.where(real, torch.clamp(qoff + row % T + 1, max=treal),
                            torch.zeros_like(row))
        chunk_end = torch.clamp(torch.clamp(qoff + t_max + 1, max=treal), min=0)
        chunk_free = torch.clamp(qoff + torch.where(one_g, row0 % T, 0) + 1, max=treal)
        for h in range(kh):
            # the (lane, head)'s GQA rows: row = g * T + t
            qa = _rows(q[b, :, h * group:(h + 1) * group].permute(1, 0, 2).reshape(rows, hd),
                       0, R).view(n_tiles, TILE, hd)
            parts = []
            for sp in range(n_live):
                lo, hi = sp * span, min(clen, sp * span + span)
                tiles = [("chunk", j0) for j0 in range(0, int(chunk_end.max()) if sp == 0 else 0,
                                                        TILE)]
                tiles += [("cache", j0) for j0 in range(lo, hi, TILE)]
                m = torch.full((n_tiles, TILE), NEG)
                l, acc = torch.zeros((n_tiles, TILE)), torch.zeros((n_tiles, TILE, hd))
                for src, j0 in tiles:
                    key = torch.arange(j0, j0 + TILE)
                    if src == "chunk":
                        kk, vv = _rows(ck[b, h], j0, TILE), _rows(cv[b, h], j0, TILE)
                        # each row tile loads keys below its own chunk_end
                        live = key[None] < chunk_end[:, None]
                        seen = (key[None] < limit[:, None]).view(n_tiles, TILE, TILE)
                        free = j0 + TILE <= chunk_free  # tiles the kernel leaves unmasked
                        kt = torch.where(live[:, :, None], kk[None], 0.0)
                        vt = torch.where(live[:, :, None], vv[None], 0.0)
                        sc_k = sc_v = None
                    else:
                        ok = key < hi  # zeros at and past the span's end
                        kt = torch.where(ok[:, None], _rows(kc[layer, b, h], j0, TILE), 0.0)[None]
                        vt = torch.where(ok[:, None], _rows(vc[layer, b, h], j0, TILE), 0.0)[None]
                        seen = ok[None, None].expand(n_tiles, TILE, TILE)
                        free = torch.full((n_tiles,), j0 + TILE <= hi)
                        sc_k = sc_v = None
                        if ks is not None:
                            sc_k, sc_v = (torch.where(ok, _rows(x[layer, b, h], j0, TILE), 0.0)
                                          for x in (ks, vs))
                    s = qa @ kt.transpose(1, 2)
                    if sc_k is not None:
                        s = s * sc_k  # before the mask and the max
                    # the kernel skips the mask of a free tile: every real row sees every key
                    for t_ in torch.nonzero(free).flatten().tolist():
                        nr = min(TILE, rows - t_ * TILE)
                        assert seen[t_, :nr].all()
                    s = torch.where(seen, s, NEG)
                    m, l, acc = _online(m, l, acc, s, vt, c, sc_v, round_p)
                    c0 = j0 + (S if src == "chunk" else 0)
                    w = min(TILE, S + Tc - c0)
                    taken[b, h, :, c0:c0 + w] += seen.reshape(R, TILE)[:rows, :w]
                parts.append(None if sp == lose_span else (m, l, acc))
            # the last block combines the partials in span order; more than
            # a group of spans combine in two levels, each group, then the groups
            if n_live > attention.SPLIT_GROUP:
                parts = [_merge([x for x in parts[g:g + attention.SPLIT_GROUP] if x is not None],
                                c) for g in range(0, n_live, attention.SPLIT_GROUP)]
            _, lt, ot = _merge([x for x in parts if x is not None], c)
            o = ot / torch.clamp(lt, min=1e-30)[..., None]
            o = o.reshape(R, hd)[:rows].view(group, T, hd)
            out[b, :, h * group:(h + 1) * group] = o.permute(1, 0, 2)
    return out, taken


def _merge(items, c):
    """One level of the combine: partials (m, l, acc) into (max m, total of
    w l, sum of w acc), w = exp2((m - max m) c), summed in item order."""
    mx = torch.stack([x[0] for x in items]).max(0).values
    lt, ot = torch.zeros_like(items[0][1]), torch.zeros_like(items[0][2])
    for m, l, acc in items:
        w = torch.exp2((m - mx) * c)
        lt, ot = lt + w * l, ot + w[..., None] * acc
    return mx, lt, ot


def _visible(cl, tr, qo, B, kh, T, group, S, Tc):
    """The (GQA row, key) pairs the plain version attends, as 0/1 counts."""
    want = torch.zeros((B, kh, group * T, S + Tc), dtype=torch.int64)
    for b in range(B):
        for r in range(group * T):
            t = r % T
            want[b, :, r, :int(cl[b])] = 1
            want[b, :, r, S:S + min(int(tr[b]), int(qo[b]) + t + 1)] = 1
    return want


def _decode_inputs(B, T, Tc, nh, kh, S, L, seed):
    r = np.random.RandomState(seed)
    f = lambda *s: (r.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    return f(B, T, nh, 128), f(L, B, kh, S, 128), f(L, B, kh, S, 128), f(B, kh, Tc, 128), \
        f(B, kh, Tc, 128)


# (name, B, T, Tc, nh, kh, S, layer, cache_len, t_real, q_offset, (span_min,
# nsplit) or None)
DECODE_CASES = [
    # decode steps: one row tile, a 64-slot span for every 64 live slots;
    # empty spans at cache_len 0 and 1, cursors on a span edge and one past
    # it, q_offset > 0
    ("decode_empty_and_one", 2, 1, 31, 8, 2, 2048, 1, (0, 1), (11, 4), (10, 3), None),
    ("decode_span_edges", 3, 1, 16, 8, 2, 2048, 0, (256, 512, 257), (1, 16, 9), (0, 15, 8), None),
    # several row tiles and spans (a split given here: 8 spans of 128 slots)
    ("tiles_and_spans", 2, 20, 20, 8, 2, 2048, 1, (1023, 128), (20, 13), (0, 2), (128, 16)),
    # a frame step's rows, eight spans of 256 slots at cache_len 1900
    ("frame_rows", 1, 40, 40, 8, 2, 2048, 0, (1900,), (33,), (0,), None),
    # a chunk longer than a tile behind a q_offset past it: whole chunk
    # tiles below every row's limit go unmasked
    ("chunk_past_offset", 1, 70, 200, 4, 2, 512, 0, (300,), (190,), (120,), None),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_split_matches_jax_and_attend_split(case):
    name, B, T, Tc, nh, kh, S, layer, cl, tr, qo, split = case
    q, k, v, ck, cv = _decode_inputs(B, T, Tc, nh, kh, S, 2, seed=len(name))
    cl, tr, qo = (np.asarray(x, np.int32) for x in (cl, tr, qo))
    t = torch.from_numpy
    got, taken = _emulate_decode(t(q), t(k), t(v), t(ck), t(cv), cl, tr, layer, qo, split)
    assert torch.equal(taken, _visible(cl, tr, qo, B, kh, T, nh // kh, S, Tc))
    want_port = attention.attend_split(t(q), t(k[layer]), t(v[layer]), t(ck), t(cv), t(cl),
                                       t(tr), t(qo))
    want_jax = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cl), jnp.asarray(tr), jnp.int32(layer), q_offset=jnp.asarray(qo),
        interpret=True))
    for b, n in enumerate(tr):  # rows t >= t_real are never read
        np.testing.assert_allclose(got[b, :n].numpy(), want_port[b, :n].numpy(),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[b, :n].numpy(), want_jax[b, :n], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("T", [1, 9, 10, 64, 100])
def test_decode_tiling_takes_every_visible_pair_once(T):
    """Row tiles x spans x key tiles, at the split the rule gives and at a
    small one, cover each visible (GQA row, key) pair exactly once and no
    other pair: cursors in the middle of a span, on an edge, and 0."""
    nh, kh, S, Tc = 7, 1, 1024, T + 3
    q, k, v, ck, cv = (torch.zeros(s) for s in ((2, T, nh, 128), (1, 2, kh, S, 128),
                                                (1, 2, kh, S, 128), (2, kh, Tc, 128),
                                                (2, kh, Tc, 128)))
    cl, tr, qo = np.array([300, 0]), np.array([T, max(1, T - 2)]), np.array([3, 0])
    want = _visible(cl, tr, qo, 2, kh, T, nh, S, Tc)
    for split in (None, (128, 8)):
        _, taken = _emulate_decode(q, k, v, ck, cv, cl, tr, 0, qo, split)
        assert torch.equal(taken, want), split


def _quantize_rows(x):
    """Symmetric per-row int8 over the last axis, as `qwen2.quantize_kv_rows`
    makes it: (int8 values, f32 scales)."""
    scale = np.maximum(np.abs(x).max(-1), 1e-20) / 127.0
    return np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8), \
        scale.astype(np.float32)


def _int8_inputs(case):
    """A `DECODE_CASES` case with an int8 cache: (q, kq, vq, ck, cv), the
    scales poisoned past each lane's cursor (inf for K, NaN for V) and the
    same zeroed there, and the cursors."""
    name, B, T, Tc, nh, kh, S, layer, cl, tr, qo, split = case
    q, k, v, ck, cv = _decode_inputs(B, T, Tc, nh, kh, S, 2, seed=len(name) + 100)
    (kq, ks), (vq, vs) = _quantize_rows(k), _quantize_rows(v)
    clean_ks, clean_vs = ks.copy(), vs.copy()
    for b, n in enumerate(cl):
        ks[:, b, :, n:], vs[:, b, :, n:] = np.inf, np.nan
        clean_ks[:, b, :, n:], clean_vs[:, b, :, n:] = 0.0, 0.0
    cl, tr, qo = (np.asarray(x, np.int32) for x in (cl, tr, qo))
    return (q, kq, vq, ck, cv), (ks, vs), (clean_ks, clean_vs), (cl, tr, qo)


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_int8_decode_split_matches_jax_and_attend_split(case):
    """The int8 cache through the same tiling: K scale on S's columns, the
    row sum of the unscaled p, V scale on p; against the Pallas kernel's
    ``quantized=True`` variant in interpret mode and `attend_split` with
    scales, in f32, every visible pair taken once; the poisoned scales past
    the cursors never reach the result."""
    name, B, T, Tc, nh, kh, S, layer, _, _, _, split = case
    (q, kq, vq, ck, cv), (ks, vs), (cks, cvs), (cl, tr, qo) = _int8_inputs(case)
    t = torch.from_numpy
    got, taken = _emulate_decode(t(q), t(kq).float(), t(vq).float(), t(ck), t(cv), cl, tr,
                                 layer, qo, split, t(ks), t(vs))
    assert torch.equal(taken, _visible(cl, tr, qo, B, kh, T, nh // kh, S, Tc))
    assert torch.isfinite(got).all()
    want_port = attention.attend_split(t(q), t(kq[layer]), t(vq[layer]), t(ck), t(cv), t(cl),
                                       t(tr), t(qo), t(cks[layer]), t(cvs[layer]))
    want_jax = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(cl), jnp.asarray(tr), jnp.int32(layer), q_offset=jnp.asarray(qo),
        k_scale=jnp.asarray(cks), v_scale=jnp.asarray(cvs), interpret=True))
    for b, n in enumerate(tr):  # rows t >= t_real are never read
        np.testing.assert_allclose(got[b, :n].numpy(), want_port[b, :n].numpy(),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[b, :n].numpy(), want_jax[b, :n], atol=ATOL, rtol=RTOL)


# (case of DECODE_CASES, cache slots a lost split or key tile)
INT8_DROPS = [(DECODE_CASES[1], slice(256, 512)), (DECODE_CASES[2], slice(128, 256)),
              (DECODE_CASES[3], slice(640, 704))]


@pytest.mark.parametrize("case,drop", INT8_DROPS, ids=[c[0][0] for c in INT8_DROPS])
def test_int8_rounding_of_p_is_within_the_bound_and_a_lost_tile_is_not(case, drop):
    """With p * v_scale rounded to bf16 as the kernel rounds it, the
    emulation stays within kernel A's row bound plus its rms term of the
    scaled values (`bounds.decode_attention_rms` with the scales); the
    plain version without one split or key tile
    (`bounds.decode_attention_dropped`) does not, and with nothing dropped
    it is `attend_split`."""
    name, B, T, Tc, nh, kh, S, layer, _, _, _, split = case
    (q, kq, vq, ck, cv), (ks, vs), (cks, cvs), (cl, tr, qo) = _int8_inputs(case)
    t = torch.from_numpy
    got, _ = _emulate_decode(t(q), t(kq).float(), t(vq).float(), t(ck), t(cv), cl, tr, layer,
                             qo, split, t(ks), t(vs), round_p=True)
    up = (t(q), t(kq), t(vq), t(ck), t(cv), t(cl), t(tr), layer, t(qo))
    scales = dict(k_scale=t(cks), v_scale=t(cvs))
    want = bounds.decode_attention_dropped(*up, **scales)
    np.testing.assert_allclose(
        want.numpy(), attention.attend_split(t(q), t(kq[layer]), t(vq[layer]), t(ck), t(cv),
                                             t(cl), t(tr), t(qo), t(cks[layer]),
                                             t(cvs[layer])).numpy(), atol=ATOL, rtol=RTOL)
    rms = bounds.decode_attention_rms(*up, **scales)
    dropped = bounds.decode_attention_dropped(*up, drop=drop, **scales)
    lanes = [b for b in range(B) if int(cl[b]) >= drop.stop]  # lanes whose slots were dropped
    assert lanes
    for b, n in enumerate(tr):
        assert bounds.row_ratio(got[b, :n], want[b, :n], rms[b, :n]) <= 1.0
    assert max(bounds.row_ratio(got[b, :tr[b]], dropped[b, :tr[b]], rms[b, :tr[b]])
               for b in lanes) > 1.0


def test_decode_split_span_depends_on_rows_and_capacity_only():
    """The grid's split has two inputs, the rows of a (lane, kv head) and the
    capacity S, and a lane's spans one more, its own cursor: no B, kv head
    or lane count enters, so a shard (the same rows a head, the same S and
    cursors) splits each (lane, head) as one launch does. One row tile: a
    span for every 128 live slots, at most 128; up to 16 tiles: every 256, at
    most 16; up to 64 tiles: every 4096, at most 2; more: one span; never
    more spans than the capacity holds. A lane's spans are equal whole
    64-slot key tiles, as few as its cursor allows."""
    assert list(inspect.signature(attention.decode_split).parameters) == ["rows", "S"]
    assert list(inspect.signature(attention.lane_spans).parameters) == \
        ["cache_len", "span_min", "nsplit"]
    split = attention.decode_split
    assert [split(r, 24576) for r in (1, 7, 64, 65, 448, 1024, 1025, 2744, 4096, 4097,
                                      10976)] == \
        [(128, 128)] * 3 + [(256, 16)] * 3 + [(4096, 2)] * 3 + [(24576, 1)] * 2
    assert split(7, 100) == (128, 1) and split(7, 4096) == (128, 32) and \
        split(448, 1000) == (256, 4) and split(2744, 4096) == (4096, 1) and \
        split(2744, 4608) == (4096, 2) and split(10976, 2048) == (2048, 1)
    spans = attention.lane_spans
    assert [spans(n, 128, 128) for n in (0, 1, 128, 129, 2047, 2048, 8193, 16384, 16385,
                                         24000)] == \
        [(64, 1), (64, 1), (128, 1), (128, 2), (128, 16), (128, 16), (128, 65), (128, 128),
         (192, 86), (192, 125)]
    assert [spans(n, 256, 16) for n in (255, 257, 2048, 24000)] == \
        [(256, 1), (192, 2), (256, 8), (1536, 16)]
    assert [spans(n, 4096, 2) for n in (2048, 4096, 4097, 6000, 24000)] == \
        [(2048, 1), (4096, 1), (2112, 2), (3008, 2), (12032, 2)]
    assert spans(24000, 24576, 1) == (24000, 1)


# Rank shapes: (name, T, Tc, t_real, q_offset, S, the cursors of 8 lanes). The
# main path's decode step, frame step and 8-frame block at the 7B's GQA group
# of 7 (a (1, 4) rank's nh 7 / kh 1, a (1, 2) rank's 14 / 2, the whole
# model's 28 / 4), S cut to 2048 (4096 for the decode step, whose 32 spans
# combine in two levels, 4608 for the block, which splits past 4096) to keep
# the CPU's work small: each lane takes the spans its cursor gives it, from
# none live to the most the grid holds.
RANK_SHAPES = [
    ("decode_step", 1, 31, 11, 10, 4096, (0, 1, 128, 129, 2048, 2049, 3000, 4096)),
    ("frame_step", 64, 64, 53, 0, 2048, (0, 255, 256, 257, 900, 1500, 2000, 2048)),
    ("8_frame_block", 392, 392, 392, 0, 4608, (0, 100, 4097, 4200, 4400, 4500, 4096, 4608)),
]
# (shape, kv heads, lanes: the shape's last cursors); the 8-frame block, whose
# 43 row tiles a head cost the CPU the most, at two (lane, head)s
RANK_CASES = [(RANK_SHAPES[0], 1, 8), (RANK_SHAPES[0], 2, 4), (RANK_SHAPES[0], 4, 1),
              (RANK_SHAPES[1], 1, 4), (RANK_SHAPES[1], 2, 2), (RANK_SHAPES[1], 4, 1),
              (RANK_SHAPES[2], 1, 2), (RANK_SHAPES[2], 2, 1)]


@pytest.fixture(autouse=True)
def _few_threads():
    """Two torch threads a test: the test workers share the CPU's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _rank_case(shape, kh, B, cache, seed):
    """The inputs of a rank-shape case, bf16 values in f32 (and for the
    int8 cache its int8 values and scales): (args of `_emulate_decode`,
    the scales, the operands of `bounds`)."""
    name, T, Tc, t_real, q_off, S, cursors = shape
    nh = 7 * kh
    q, k, v, ck, cv = (torch.from_numpy(x).bfloat16().float()
                       for x in _decode_inputs(B, T, Tc, nh, kh, S, 1, seed))
    cl = torch.tensor(cursors[-B:], dtype=torch.int32)
    tr, qo = (torch.full((B,), x, dtype=torch.int32) for x in (t_real, q_off))
    scales = {}
    if cache == "int8":
        (kq, ks), (vq, vs) = _quantize_rows(k.numpy()), _quantize_rows(v.numpy())
        k, v = torch.from_numpy(kq).float(), torch.from_numpy(vq).float()
        scales = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    return (q, k, v, ck, cv, cl, tr, 0, qo), scales


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("shape,kh,B", RANK_CASES,
                         ids=[f"{c[0][0]}-kh{c[1]}_B{c[2]}" for c in RANK_CASES])
def test_rank_shapes_split_and_combine_within_the_row_bound_of_jax(shape, kh, B, cache):
    """The split and the span-order combine at a rank's shapes, with p (times
    the V scales) rounded to bf16 as the kernel rounds it: within kernel A's
    row bound and its rms term (`ops/bounds.py`) of the JAX package's
    `flash_decode_attention` (the Pallas kernel in interpret mode) on the
    same values, at every lane's cursor."""
    args, scales = _rank_case(shape, kh, B, cache, seed=kh * 10 + B)
    q, k, v, ck, cv, cl, tr, layer, qo = args
    span_min, nsplit = attention.decode_split(7 * q.shape[1], k.shape[3])
    live = [attention.lane_spans(int(n), span_min, nsplit)[1] for n in cl]
    assert max(live) <= nsplit and (nsplit == 1 or max(live) > 1)  # the split at work
    got, _ = _emulate_decode(*args, None, scales.get("k_scale"), scales.get("v_scale"),
                             round_p=True)
    jx = {k_: jnp.asarray(v_.numpy()) for k_, v_ in scales.items()}
    want = torch.from_numpy(np.array(jax_flash_decode(
        *(jnp.asarray(x.numpy()) for x in (q, k.to(torch.int8) if scales else k,
                                          v.to(torch.int8) if scales else v, ck, cv, cl, tr)),
        jnp.int32(layer), q_offset=jnp.asarray(qo.numpy()), interpret=True, **jx))).float()
    up = (q, k.to(torch.int8) if scales else k, v.to(torch.int8) if scales else v, ck, cv,
          cl, tr, layer, qo)
    rms = bounds.decode_attention_rms(*up, **scales)
    for b, n in enumerate(tr.tolist()):
        assert bounds.row_ratio(got[b, :n], want[b, :n], rms[b, :n]) <= 1.0, (b, int(cl[b]))


@pytest.mark.parametrize("shape", RANK_SHAPES[:2], ids=[s_[0] for s_ in RANK_SHAPES[:2]])
def test_a_shards_emulated_launch_is_bit_equal_to_its_slice_of_one_launch(shape):
    """4 lanes x 2 kv heads (14 heads), and each shard of the (2, 2), (1, 2)
    and (4, 1) meshes launched on its own lanes, kv heads and their query
    heads: the wrapper gives the shard the split it gives the whole launch
    (`_split_args`), and the shard's emulated output is bit-equal to its
    slice of the whole launch's."""
    (q, k, v, ck, cv, cl, tr, layer, qo), _ = _rank_case(shape, 2, 4, "bf16", seed=3)
    rows, S = 7 * q.shape[1], k.shape[3]
    whole, _ = _emulate_decode(q, k, v, ck, cv, cl, tr, layer, qo, round_p=True)
    cpu = torch.device("cpu")
    split = attention._split_args(cpu, 4, 2, rows, S, 128)[:2]
    for data_n, model_n in ((2, 2), (1, 2), (4, 1)):
        lb, hk = 4 // data_n, 2 // model_n
        for i in range(data_n):
            for j in range(model_n):
                ln, kv, qh = (slice(i * lb, (i + 1) * lb), slice(j * hk, (j + 1) * hk),
                              slice(j * 7 * hk, (j + 1) * 7 * hk))
                assert attention._split_args(cpu, lb, hk, rows, S, 128)[:2] == split
                got, _ = _emulate_decode(q[ln, :, qh], k[:, ln, kv], v[:, ln, kv], ck[ln, kv],
                                         cv[ln, kv], cl[ln], tr[ln], layer, qo[ln],
                                         round_p=True)
                assert torch.equal(got, whole[ln, :, qh]), ((data_n, model_n), i, j)


# the rank shapes whose lanes split at their last cursor
SPLIT_SHAPES = [s_ for s_ in RANK_SHAPES if attention.decode_split(7 * s_[1], s_[5])[1] > 1]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=[s_[0] for s_ in SPLIT_SHAPES])
def test_a_dropped_span_fails_the_row_bound(shape, cache):
    """A (1, 4) rank's lane at its shape's last cursor: the emulation within the row
    bound of the plain version, and a faulty one that leaves one span out
    of the combine far outside it, for each span the lane takes."""
    args, scales = _rank_case(shape, 1, 1, cache, seed=7)
    q, k, v, ck, cv, cl, tr, layer, qo = args
    ksc, vsc = scales.get("k_scale"), scales.get("v_scale")
    up = (q, k.to(torch.int8) if scales else k, v.to(torch.int8) if scales else v, ck, cv,
          cl, tr, layer, qo)
    want = bounds.decode_attention_dropped(*up, **scales)
    rms = bounds.decode_attention_rms(*up, **scales)
    n = int(tr[0])
    got, _ = _emulate_decode(*args, None, ksc, vsc, round_p=True)
    assert bounds.row_ratio(got[:, :n], want[:, :n], rms[:, :n]) <= 1.0
    _, n_live = attention.lane_spans(int(cl[0]), *attention.decode_split(7 * q.shape[1],
                                                                         k.shape[3]))
    assert n_live > 1
    for lost in range(n_live):
        bad, _ = _emulate_decode(*args, None, ksc, vsc, round_p=True, lose_span=lost)
        assert bounds.row_ratio(bad[:, :n], want[:, :n], rms[:, :n]) > 1.0, lost


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------

VBQ, VBK = 192, 128  # kernel D's query block (three warpgroups of 64 rows) and key tile


def _vision_widths(hd):
    """(16-column steps of Q K^T, columns of P V) that kernel D runs for hd."""
    ks = -(-hd // 16)
    nv = hd if hd in (64, 72) else next(n for n in (64, 80, 128) if n >= hd)
    return ks, nv


def _emulate_vision(q, k, v):
    """flash_vision_kernel over its grid (image, head, 192-query block, 64-row
    warpgroup), with the operands zero-padded to the widths it multiplies."""
    N, T, nh, hd = q.shape
    ks, nv = _vision_widths(hd)
    wk = 16 * ks
    c = LOG2E / math.sqrt(hd)
    pad = lambda x, w: torch.nn.functional.pad(x, (0, w - hd))  # noqa: E731
    out = torch.zeros_like(q)
    nk = -(-T // VBK)
    for n in range(N):
        for h in range(nh):
            qh, kh_, vh = pad(q[n, :, h], wk), pad(k[n, :, h], wk), pad(v[n, :, h], nv)
            for r0 in range(0, -(-T // VBQ) * VBQ, TILE):  # each warpgroup's 64 rows
                qa = _rows(qh, r0, TILE)
                m, l, acc = torch.full((TILE,), NEG), torch.zeros(TILE), torch.zeros(TILE, nv)
                for j in range(nk):
                    s = qa @ _rows(kh_, j * VBK, VBK).T
                    if j == nk - 1 and T % VBK:  # only the last key tile is ragged
                        s[:, T % VBK:] = NEG
                    m, l, acc = _online(m, l, acc, s, _rows(vh, j * VBK, VBK), c)
                live = min(TILE, T - r0)
                if live > 0:
                    out[n, r0:r0 + live, h] = (acc / l[:, None])[:live, :hd]
    return out


def test_vision_widths_shorten_the_products():
    assert [_vision_widths(hd) for hd in (8, 40, 64, 72, 80, 96, 128)] == \
        [(1, 64), (3, 64), (4, 64), (5, 72), (5, 80), (6, 128), (8, 128)]


@pytest.mark.parametrize("hd", [64, 72, 128])
@pytest.mark.parametrize("T", [1, 50, 729])
def test_vision_schedule_matches_jax(T, hd):
    r = np.random.RandomState(T + hd)
    q, k, v = ((r.randn(1, T, 2, hd) * 0.3).astype(np.float32) for _ in range(3))
    got = _emulate_vision(*(torch.from_numpy(x) for x in (q, k, v)))
    want = np.asarray(jax_flash_vision(*(jnp.asarray(x) for x in (q, k, v)),
                                       _impl=mha_reference))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the build key
# ---------------------------------------------------------------------------


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """A kernel's build key covers every local header it includes, so an
    edited header builds anew; a header it does not include does not."""
    own = _build.library_path("flash_vision")
    for name in ("flash_vision.cu", "hopper.cuh", "flash_full.cu"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources(tmp_path / "flash_vision.cu")] == \
        ["flash_vision.cu", "hopper.cuh"]
    before = _build.library_path("flash_vision")
    assert before == own  # the same bytes key the same library
    full = _build.library_path("flash_full")
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert _build.library_path("flash_vision") == before
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path("flash_vision")
    assert after != before and after.name.startswith("flash_vision-")
    assert _build.library_path("flash_full") == full  # includes no header
