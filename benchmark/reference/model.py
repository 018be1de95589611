"""The plain reference of MMDuet-7B: plain PyTorch in float32, TF32 off.

The reference of configurations of the ``LlavaQwenForCausalLM``
architecture, whose ``reference`` key names this file: the harness loads it
by path (`benchmark.spec.reference`), so it imports the benchmark's own
modules as ``benchmark.*``.

It follows the published description (LLaVA-OneVision: SigLIP-so400m's
first 26 layers, a two-layer GELU projector, bilinear pooling of the
27 x 27 patch grid to 7 x 7; the Qwen2 decoder; MMDuet's two score heads
on the last token of each frame) and imports nothing of the program. It
takes the benchmark's bf16 weights (`benchmark.weights`, made again from
the seed) and the traffic's pixels and token ids, and works out every
derived number itself: the int4 weights and the int8 cache of a quantized
configuration through `benchmark.reference.quant`.

Departures, each for the cost of the check and none for its strength:

- The stream runs once, causally, over its whole length, and each answer
  then runs as a branch against the stream's K/V up to its trigger: the
  same numbers as one full forward over [stream up to the trigger, the
  answer's prompt, its tokens], for every answer at once.
- Under an int8 cache every key and value of the stream and of an
  answer's prompt is seen through its int8 round trip, also by the rows of
  its own chunk (the program's chunk reads its own rows unquantized); an
  answer's generated tokens are seen as they are, as the program keeps
  them in its bf16 scratch.

`Precision` says how a weight, an activation and a cached key or value
are seen: as served (the configuration's own precision), or in a
control's lower precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.model_shapes import Shapes
from benchmark.reference import quant

QUERY_BLOCK = 512  # stream rows a block of the causal attention
VISION_BLOCK = 8  # frames a block of the tower


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass(frozen=True)
class Precision:
    """``weights``: how the weights that a configuration may quantize (the
    decoder's projections, the embedding, the LM head) are seen: "bf16" (as
    made), "int4" (the configuration's group-wise int4) or "fp8" (float8
    e4m3, one scale an output channel). ``rest``: the same for the weights
    it keeps in bf16 (the tower, the projector, the score heads): "bf16" or
    "fp8". ``act``: None, or "fp8" (every matmul's input in float8 e4m3, one
    scale a row). ``kv``: None, "int8" or "int4"."""

    weights: str = "bf16"
    kv: Optional[str] = None
    group: int = 128
    act: Optional[str] = None
    rest: str = "bf16"

    def quantized(self, w: torch.Tensor, reduce_axis: int) -> torch.Tensor:
        """A weight that the configuration may quantize."""
        if self.weights == "int4":
            return quant.int4_round_trip(w, reduce_axis, self.group)
        if self.weights == "fp8":
            return quant.fp8_weight_round_trip(w, reduce_axis)
        return w.float()

    def dense(self, w: torch.Tensor, reduce_axis: int) -> torch.Tensor:
        """A weight that the configuration keeps in bf16."""
        if self.rest == "fp8":
            return quant.fp8_weight_round_trip(w, reduce_axis)
        return w.float()

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return quant.fp8_act_round_trip(x) if self.act == "fp8" else x

    def cached(self, x: torch.Tensor) -> torch.Tensor:
        if self.kv == "int8":
            return quant.int8_kv_round_trip(x)
        if self.kv == "int4":
            return quant.int4_kv_round_trip(x)
        return x


def served(s: Shapes) -> Precision:
    return Precision("int4" if s.weight_bits == 4 else "bf16", s.kv_quant, s.group)


def control(s: Shapes) -> Precision:
    """Each precision the configuration states, one step down where there
    is one: bf16 weights to fp8 (the decoder's and the LM head's where they
    are bf16; the tower's, the projector's and the heads' always), bf16
    activations to fp8, an int8 cache to int4; int4 weights have none below
    them and stay."""
    weights = "int4" if s.weight_bits == 4 else "fp8"
    kv = {"int8": "int4", None: None}[s.kv_quant]
    return Precision(weights, kv, s.group, act="fp8", rest="fp8")


def _mm(p: Precision, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    y = p.input(x) @ w
    return y if b is None else y + b.float()


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


# ---------------------------------------------------------------------------
# vision: pixels -> frame embeddings
# ---------------------------------------------------------------------------


def _tower(w: Dict, s: Shapes, p: Precision, px: torch.Tensor) -> torch.Tensor:
    """(N, R, R, 3) uint8 -> (N, patches, C) f32 features at the selected
    layer (no final norm)."""
    x = (px.float() / 255.0 - 0.5) / 0.5
    C = s.v_hidden
    conv = p.dense(w["patch_embed"], 0).t().reshape(C, 3, s.patch, s.patch)
    x = F.conv2d(p.input(x.permute(0, 3, 1, 2)).contiguous(), conv, w["patch_bias"].float(),
                 stride=s.patch)  # (N, C, side, side): the last pixels that fill no patch drop
    x = x.flatten(2).transpose(1, 2) + w["pos_embed"].float()[None]
    lay = w["layers"]
    N, T, _ = x.shape
    hd = s.v_head_dim
    for i in range(s.v_used_layers):
        y = _layer_norm(x, lay["ln1_scale"][i], lay["ln1_bias"][i], s.v_eps)
        q, k, v = (_mm(p, y, p.dense(lay[f"{n}_proj"][i], 0), lay[f"{n}_bias"][i])
                   .reshape(N, T, s.v_heads, hd).transpose(1, 2) for n in "qkv")
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
        x = x + _mm(p, att.transpose(1, 2).reshape(N, T, C), p.dense(lay["o_proj"][i], 0),
                    lay["o_bias"][i])
        y = _layer_norm(x, lay["ln2_scale"][i], lay["ln2_bias"][i], s.v_eps)
        y = F.gelu(_mm(p, y, p.dense(lay["fc1"][i], 0), lay["fc1_bias"][i]), approximate="tanh")
        x = x + _mm(p, y, p.dense(lay["fc2"][i], 0), lay["fc2_bias"][i])
    return x


def frame_embeds(w: Dict, s: Shapes, p: Precision, pixels: torch.Tensor) -> torch.Tensor:
    """(N, R, R, 3) uint8 -> (N, frame_tokens, H) f32: tower, projector,
    bilinear pooling."""
    pr = w["projector"]
    fc1, fc2 = p.dense(pr["fc1"], 0), p.dense(pr["fc2"], 0)
    out = []
    for j in range(0, pixels.shape[0], VISION_BLOCK):
        feats = _tower(w["vision"], s, p, pixels[j:j + VISION_BLOCK])
        x = F.gelu(_mm(p, feats, fc1, pr["fc1_bias"]), approximate="none")
        x = _mm(p, x, fc2, pr["fc2_bias"])
        n, side = x.shape[0], s.v_side
        grid = x.reshape(n, side, side, -1).permute(0, 3, 1, 2)
        out_side = -(-side // s.pool_stride)
        pooled = F.interpolate(grid, size=(out_side, out_side), mode="bilinear",
                               align_corners=False, antialias=False)
        out.append(pooled.flatten(2).transpose(1, 2))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# decoder: a stream, and answers branching off it
# ---------------------------------------------------------------------------


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, heads, hd) rotated by positions (T,) in the half-rotation layout."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = pos.double()[:, None] * inv[None]
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attend(q, k, v, q_pos, k_pos, kh):
    """q (Tq, nh, hd); k, v (Tk, kh, hd); a query sees the keys at
    positions <= its own."""
    rep = q.shape[1] // kh
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for a in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[a:a + QUERY_BLOCK].transpose(0, 1)  # (nh, tq, hd)
        sc = qb @ k.permute(1, 2, 0) / math.sqrt(q.shape[-1])  # (nh, tq, Tk)
        mask = k_pos[None, :] > q_pos[a:a + QUERY_BLOCK, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[a:a + QUERY_BLOCK] = (torch.softmax(sc, dim=-1) @ v.transpose(0, 1)).transpose(0, 1)
    return out


@dataclass
class Branch:
    """An answer: the stream position it branches at (its context is the
    stream's first ``at`` tokens), its token ids (the prompt and the served
    tokens but the last) and the index of the prompt's last row."""

    at: int
    ids: List[int]
    first_row: int


def _layer_weights(w: Dict, s: Shapes, p: Precision, i: int) -> Dict[str, torch.Tensor]:
    lay = w["decoder"]["layers"]
    out = {n: p.quantized(lay[n][i], 0)
           for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj")}
    for n in ("q_bias", "k_bias", "v_bias", "input_norm", "post_attn_norm"):
        out[n] = lay[n][i].float()
    return out


def embed_rows(w: Dict, s: Shapes, p: Precision, ids: Sequence[int], device) -> torch.Tensor:
    table = w["decoder"]["embed"]
    rows = table[torch.tensor(list(ids), dtype=torch.long, device=device)]
    return p.quantized(rows, 1)


def decoder(w: Dict, s: Shapes, p: Precision, stream: torch.Tensor, branches: List[Branch],
            score_rows: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``stream`` (N, H) f32 embeddings at positions 0..N-1. Returns the
    (rows, 2) informative and relevance probabilities at ``score_rows``
    and, for each branch, its (tokens, V) logits from its prompt's last row
    on."""
    dev = stream.device
    kh, hd = s.kv_heads, s.head_dim
    x = stream
    pos = torch.arange(x.shape[0], device=dev)
    xb = [embed_rows(w, s, p, b.ids, dev) for b in branches]
    bpos = [torch.arange(b.at, b.at + len(b.ids), device=dev) for b in branches]
    for i in range(s.layers):
        lw = _layer_weights(w, s, p, i)

        def qkv(h, at):
            y = _rms_norm(h, lw["input_norm"], s.rms_eps)
            q = _mm(p, y, lw["q_proj"], lw["q_bias"]).reshape(-1, s.heads, hd)
            k = _mm(p, y, lw["k_proj"], lw["k_bias"]).reshape(-1, kh, hd)
            v = _mm(p, y, lw["v_proj"], lw["v_bias"]).reshape(-1, kh, hd)
            return _rope(q, at, s.rope_theta), _rope(k, at, s.rope_theta), v

        def out_mlp(h, att):
            h = h + _mm(p, att.reshape(att.shape[0], -1), lw["o_proj"])
            y = _rms_norm(h, lw["post_attn_norm"], s.rms_eps)
            act = F.silu(_mm(p, y, lw["gate_proj"])) * _mm(p, y, lw["up_proj"])
            return h + _mm(p, act, lw["down_proj"])

        q, k, v = qkv(x, pos)
        k, v = p.cached(k), p.cached(v)
        for j, (b, h) in enumerate(zip(branches, xb)):
            bq, bk, bv = qkv(h, bpos[j])
            n_prompt = b.first_row + 1  # rows committed to the cache; the rest stay as they are
            bk = torch.cat([p.cached(bk[:n_prompt]), bk[n_prompt:]])
            bv = torch.cat([p.cached(bv[:n_prompt]), bv[n_prompt:]])
            att = _attend(bq, torch.cat([k[:b.at], bk]), torch.cat([v[:b.at], bv]), bpos[j],
                          torch.cat([pos[:b.at], bpos[j]]), kh)
            xb[j] = out_mlp(h, att)
        x = out_mlp(x, _attend(q, k, v, pos, pos, kh))
        del lw, q, k, v
    fin = w["decoder"]["final_norm"]
    h = _rms_norm(x[score_rows], fin, s.rms_eps)
    probs = torch.stack([torch.softmax(_mm(p, h, p.dense(w[name], 0)), dim=-1)[:, 1]
                         for name in ("informative_head", "relevance_head")], dim=1)
    head = p.quantized(w["lm_head"], 0)
    logits = [_mm(p, _rms_norm(hb[b.first_row:], fin, s.rms_eps), head)
              for b, hb in zip(branches, xb)]
    return probs, logits
