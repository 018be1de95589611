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
    V scales, per key), rounded to bf16 if ``round_p``."""
    mn = torch.maximum(m, s.max(1).values)
    alpha = torch.exp2((m - mn) * c)
    mc = torch.where(mn > 0.5 * NEG, mn * c, torch.zeros_like(mn))
    p = torch.exp2(s * c - mc[:, None])
    pv = p if vscale is None else p * vscale[None, :]
    if round_p:
        pv = pv.bfloat16().float()
    return mn, l * alpha + p.sum(1), acc * alpha[:, None] + pv @ v


# ---------------------------------------------------------------------------
# kernel A, bf16 cache
# ---------------------------------------------------------------------------


def _emulate_decode(q, kc, vc, ck, cv, cl, tr, layer, qo, span=None, ks=None, vs=None,
                    round_p=False):
    """flash_decode_tc_kernel over its grid; returns the output and, per
    (lane, kv head), the count of times each (GQA row, key) pair was taken
    unmasked (keys: cache slots, then chunk columns). ``ks`` / ``vs`` (L, B,
    kh, S): the cache is int8 values (here in f32) with these scales, read
    as zeros at and past a tile's end; ``round_p`` rounds the cache's p *
    vs to bf16, as the kernel does."""
    B, T, nh, hd = q.shape
    kh, S, Tc = kc.shape[2], kc.shape[3], ck.shape[2]
    group = nh // kh
    rows = group * T
    span = span or attention.decode_split_span(rows, S)
    nsplit = -(-S // span)
    c = LOG2E / math.sqrt(hd)
    out = torch.zeros_like(q)
    taken = torch.zeros((B, kh, rows, S + Tc), dtype=torch.int64)
    for b in range(B):
        clen, treal, qoff = int(cl[b]), int(tr[b]), int(qo[b])
        n_live = max(1, -(-clen // span))
        for h in range(kh):
            # the (lane, head)'s GQA rows: row = g * T + t
            qrows = q[b, :, h * group:(h + 1) * group].permute(1, 0, 2).reshape(rows, hd)
            for tile in range(-(-rows // TILE)):
                row0 = tile * TILE
                row = torch.arange(row0, row0 + TILE)
                real = row < rows
                # a row's causal limit in the chunk (rows past `rows` are never stored)
                limit = torch.where(real, torch.minimum(torch.tensor(treal), qoff + row % T + 1),
                                    torch.zeros_like(row))
                last = min(row0 + TILE, rows) - 1
                one_g = row0 // T == last // T  # the tile's rows are of one q head
                t_max = last % T if one_g else T - 1
                chunk_free = min(treal, qoff + (row0 % T if one_g else 0) + 1)
                qa = _rows(qrows, row0, TILE)
                parts = []
                for split in range(nsplit):
                    if split >= n_live:  # the block exits at once
                        continue
                    lo, hi = split * span, min(clen, split * span + span)
                    chunk_end = max(0, min(treal, qoff + t_max + 1)) if split == 0 else 0
                    tiles = [("chunk", j0, chunk_end) for j0 in range(0, chunk_end, TILE)]
                    tiles += [("cache", j0, hi) for j0 in range(lo, hi, TILE)]
                    m, l, acc = torch.full((TILE,), NEG), torch.zeros(TILE), torch.zeros(TILE, hd)
                    for src, j0, n in tiles:
                        kt, vt = (ck[b, h], cv[b, h]) if src == "chunk" else (kc[layer, b, h],
                                                                              vc[layer, b, h])
                        key = torch.arange(j0, j0 + TILE)
                        kk, vv = _rows(kt, j0, TILE), _rows(vt, j0, TILE)
                        kk[key >= n] = 0.0
                        vv[key >= n] = 0.0
                        seen = key[None] < (limit[:, None] if src == "chunk" else hi)
                        nr = min(TILE, rows - row0)
                        s = qa @ kk.T
                        ksc = vsc = None
                        if ks is not None and src == "cache":  # zeros past the tile's end
                            ksc, vsc = (torch.where(key < n, _rows(x[layer, b, h], j0, TILE),
                                                    torch.zeros(TILE)) for x in (ks, vs))
                            s = s * ksc[None, :]  # before the mask and the max
                        if j0 + TILE <= (chunk_free if src == "chunk" else hi):
                            # the kernel skips the mask: every row sees every key
                            assert seen[:nr].all()
                        else:
                            s = torch.where(seen, s, torch.full((TILE, TILE), NEG))
                        m, l, acc = _online(m, l, acc, s, vv, c, vsc, round_p and vsc is not None)
                        c0 = j0 + (S if src == "chunk" else 0)
                        w = min(TILE, S + Tc - c0)
                        taken[b, h, row0:row0 + nr, c0:c0 + w] += seen[:nr, :w]
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    m, l, acc = parts[0]
                    o = acc / torch.clamp(l, min=1e-30)[:, None]
                else:  # the last block combines the partials in span order
                    mx = torch.stack([p[0] for p in parts]).max(0).values
                    lt, ot = torch.zeros(TILE), torch.zeros(TILE, hd)
                    for m, l, acc in parts:
                        w = torch.exp2((m - mx) * c)
                        lt, ot = lt + w * l, ot + w[:, None] * acc
                    o = ot / torch.clamp(lt, min=1e-30)[:, None]
                for r in range(min(TILE, rows - row0)):
                    g, t = divmod(row0 + r, T)
                    out[b, t, h * group + g] = o[r]
    return out, taken


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


# (name, B, T, Tc, nh, kh, S, layer, cache_len, t_real, q_offset, span or None)
DECODE_CASES = [
    # decode steps: one row tile, 256-slot spans; empty spans at cache_len 0
    # and 1, cursors on a span edge and one past it, q_offset > 0
    ("decode_empty_and_one", 2, 1, 31, 8, 2, 2048, 1, (0, 1), (11, 4), (10, 3), None),
    ("decode_span_edges", 3, 1, 16, 8, 2, 2048, 0, (256, 512, 257), (1, 16, 9), (0, 15, 8), None),
    # several row tiles and spans (a span given here)
    ("tiles_and_spans", 2, 20, 20, 8, 2, 2048, 1, (1023, 128), (20, 13), (0, 2), 128),
    # a frame step's rows, one span at S = 2048
    ("frame_rows", 1, 40, 40, 8, 2, 2048, 0, (1900,), (33,), (0,), None),
    # a chunk longer than a tile behind a q_offset past it: whole chunk
    # tiles below every row's limit go unmasked
    ("chunk_past_offset", 1, 70, 200, 4, 2, 512, 0, (300,), (190,), (120,), None),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_split_matches_jax_and_attend_split(case):
    name, B, T, Tc, nh, kh, S, layer, cl, tr, qo, span = case
    q, k, v, ck, cv = _decode_inputs(B, T, Tc, nh, kh, S, 2, seed=len(name))
    cl, tr, qo = (np.asarray(x, np.int32) for x in (cl, tr, qo))
    t = torch.from_numpy
    got, taken = _emulate_decode(t(q), t(k), t(v), t(ck), t(cv), cl, tr, layer, qo, span)
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
    """Row tiles x spans x key tiles, at the span the rule gives and at a
    small one, cover each visible (GQA row, key) pair exactly once and no
    other pair: cursors in the middle of a span, on an edge, and 0."""
    nh, kh, S, Tc = 7, 1, 1024, T + 3
    q, k, v, ck, cv = (torch.zeros(s) for s in ((2, T, nh, 128), (1, 2, kh, S, 128),
                                                (1, 2, kh, S, 128), (2, kh, Tc, 128),
                                                (2, kh, Tc, 128)))
    cl, tr, qo = np.array([300, 0]), np.array([T, max(1, T - 2)]), np.array([3, 0])
    want = _visible(cl, tr, qo, 2, kh, T, nh, S, Tc)
    for span in (None, 128):
        _, taken = _emulate_decode(q, k, v, ck, cv, cl, tr, 0, qo, span)
        assert torch.equal(taken, want), span


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
    name, B, T, Tc, nh, kh, S, layer, cl, tr, qo, span = case
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
    name, B, T, Tc, nh, kh, S, layer, _, _, _, span = case
    (q, kq, vq, ck, cv), (ks, vs), (cks, cvs), (cl, tr, qo) = _int8_inputs(case)
    t = torch.from_numpy
    got, taken = _emulate_decode(t(q), t(kq).float(), t(vq).float(), t(ck), t(cv), cl, tr,
                                 layer, qo, span, t(ks), t(vs))
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
    name, B, T, Tc, nh, kh, S, layer, _, _, _, span = case
    (q, kq, vq, ck, cv), (ks, vs), (cks, cvs), (cl, tr, qo) = _int8_inputs(case)
    t = torch.from_numpy
    got, _ = _emulate_decode(t(q), t(kq).float(), t(vq).float(), t(ck), t(cv), cl, tr, layer,
                             qo, span, t(ks), t(vs), round_p=True)
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
    """One row tile: 256 slots; up to 16 tiles: 2048; more: one span; never
    past the capacity. A shard has the same rows a (lane, head) and the
    same capacity, so it splits as one launch does."""
    span = attention.decode_split_span
    assert [span(r, 24576) for r in (1, 7, 64, 65, 448, 1024, 1025, 2744)] == \
        [256, 256, 256, 2048, 2048, 2048, 24576, 24576]
    assert span(7, 100) == 100 and span(448, 1000) == 1000


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
