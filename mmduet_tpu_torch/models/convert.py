"""HF checkpoint -> the port's parameter tree and checkpoint directory.

Port of `mmduet_tpu/models/convert.py`. Maps the
`lmms-lab/llava-onevision-qwen2-7b-ov` layout (and the reference's
`VideoHeadLiveLlavaQwenForCausalLM` additions: the two score heads,
`video_head_live_llava_qwen.py:77-78`) plus PEFT LoRA adapter files
(`modeling_live.py:107-117`) onto the layer-stacked tree of
`models.params`, with the JAX converter's key maps and layouts:

- HF Linear stores (out, in); the tree stores (in, out): transposed;
- per-layer tensors are stacked on a leading layer axis;
- SigLIP's conv patch embed (out, C, kh, kw) flattens to the (C*kh*kw,
  out) matmul weight, the (C, ph, pw) element order of `siglip.patchify`;
- LoRA A (r, in) -> a (in, r); B (out, r) -> b (r, out).

Safetensors files are read by `_read_safetensors`, a reader of the format
itself (the GPU machine has no ``safetensors`` package): each tensor is a
view of the memory-mapped file in its own dtype, so a bf16 checkpoint is
never widened to f32 on the host (the JAX converter's ``_np`` widens torch
bf16 tensors to f32; bf16 -> f32 -> bf16 is exact, so both converters give
the same bits). The conversion stacks each leaf on ``device`` (the CLI's
default is the card), one layer at a time crossing to it, quantizes there
with `quant.quantize_params` when asked, and writes the port's checkpoint
directory (`models.io`).

``convert_clip`` maps an HF `CLIPVisionModel` state dict onto `models.clip`'s
tree; as in the JAX package, `convert_mmduet` and `config_from_hf` route
SigLIP towers only.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import re
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import MMDuetConfig, Qwen2Config, SiglipConfig

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names -> torch dtypes: the weights' and the quantized
# leaves', and I64 for the integer buffers (position ids) some checkpoints hold
_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
}


def _read_safetensors(path: str) -> StateDict:
    """Every tensor of one ``.safetensors`` file, read from the format
    itself: an 8-byte little-endian header length, a JSON header of
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (and an
    optional ``__metadata__``), then the raw little-endian bytes, the
    offsets counted from the end of the header.

    The tensors are views of a private (copy-on-write) memory map of the
    file, in the file's dtype: nothing is read until a tensor is used, and
    writing to one never reaches the file. A tensor whose offset is not a
    multiple of its element size is copied out instead."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    base = 8 + n
    data = torch.frombuffer(mm, dtype=torch.uint8) if mm is not None else None
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(_DTYPES)})")
        dtype, shape = _DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name} of {info['dtype']} {list(shape)} has "
                             f"data_offsets {[begin, end]} (file of {size} bytes)")
        raw = data[base + begin: base + end]
        if (base + begin) % itemsize:
            raw = raw.clone()
        out[name] = raw.view(dtype).view(shape)
    return out


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``t`` on ``device`` (None: its own) that owns its memory:
    no leaf of the tree keeps a view of a file's memory map."""
    return t.to(t.device if device is None else device, copy=True)


def _t(t: torch.Tensor) -> torch.Tensor:
    """The (in, out) layout of an HF (out, in) weight, contiguous."""
    return t.t().contiguous()


def _stack(sd: StateDict, fmt: str, n: int, transpose: bool, device) -> torch.Tensor:
    """Layers 0..n-1 of ``fmt`` stacked on a leading axis, on ``device``
    (one layer at a time crosses to the device)."""
    mats = [sd[fmt.format(i=i)] for i in range(n)]
    if device is not None:
        mats = [m.to(device) for m in mats]
    return torch.stack([m.t() if transpose else m for m in mats])


def convert_qwen2(sd: StateDict, cfg: Qwen2Config, prefix: str = "model.",
                  device=None) -> Dict:
    """HF Qwen2 state dict -> decoder params."""
    L, p = cfg.num_layers, prefix

    def stack(fmt: str, transpose: bool = False):
        return _stack(sd, p + fmt, L, transpose, device)

    layers = {
        "input_norm": stack("layers.{i}.input_layernorm.weight"),
        "post_attn_norm": stack("layers.{i}.post_attention_layernorm.weight"),
        "q_proj": stack("layers.{i}.self_attn.q_proj.weight", True),
        "k_proj": stack("layers.{i}.self_attn.k_proj.weight", True),
        "v_proj": stack("layers.{i}.self_attn.v_proj.weight", True),
        "o_proj": stack("layers.{i}.self_attn.o_proj.weight", True),
        "gate_proj": stack("layers.{i}.mlp.gate_proj.weight", True),
        "up_proj": stack("layers.{i}.mlp.up_proj.weight", True),
        "down_proj": stack("layers.{i}.mlp.down_proj.weight", True),
    }
    if cfg.qkv_bias:  # Qwen2 family; bias-free variants omit these keys
        layers["q_bias"] = stack("layers.{i}.self_attn.q_proj.bias")
        layers["k_bias"] = stack("layers.{i}.self_attn.k_proj.bias")
        layers["v_bias"] = stack("layers.{i}.self_attn.v_proj.bias")
    return {
        "embed": _to(sd[p + "embed_tokens.weight"], device),
        "layers": layers,
        "final_norm": _to(sd[p + "norm.weight"], device),
    }


def _vit_layers(sd: StateDict, cfg, prefix: str, device) -> Dict:
    """The encoder layers HF's SigLIP and CLIP vision models share."""
    e = prefix + "encoder.layers.{i}."

    def stack(fmt: str, transpose: bool = False):
        return _stack(sd, e + fmt, cfg.num_layers, transpose, device)

    return {
        "ln1_scale": stack("layer_norm1.weight"),
        "ln1_bias": stack("layer_norm1.bias"),
        "ln2_scale": stack("layer_norm2.weight"),
        "ln2_bias": stack("layer_norm2.bias"),
        "q_proj": stack("self_attn.q_proj.weight", True),
        "q_bias": stack("self_attn.q_proj.bias"),
        "k_proj": stack("self_attn.k_proj.weight", True),
        "k_bias": stack("self_attn.k_proj.bias"),
        "v_proj": stack("self_attn.v_proj.weight", True),
        "v_bias": stack("self_attn.v_proj.bias"),
        "o_proj": stack("self_attn.out_proj.weight", True),
        "o_bias": stack("self_attn.out_proj.bias"),
        "fc1": stack("mlp.fc1.weight", True),
        "fc1_bias": stack("mlp.fc1.bias"),
        "fc2": stack("mlp.fc2.weight", True),
        "fc2_bias": stack("mlp.fc2.bias"),
    }


def _patch_embed(sd: StateDict, prefix: str, device) -> torch.Tensor:
    """The conv patch embed (out, C, kh, kw) as the (C*kh*kw, out) matmul
    weight of `siglip.patchify`'s (C, ph, pw) order."""
    conv = _to(sd[prefix + "embeddings.patch_embedding.weight"], device)
    return _t(conv.reshape(conv.shape[0], -1))


def convert_siglip(sd: StateDict, cfg: SiglipConfig, prefix: str = "", device=None) -> Dict:
    """HF SiglipVisionModel state dict -> vision params."""
    p = prefix
    layers = _vit_layers(sd, cfg, p, device)
    return {
        "patch_embed": _patch_embed(sd, p, device),
        "patch_bias": _to(sd[p + "embeddings.patch_embedding.bias"], device),
        "pos_embed": _to(sd[p + "embeddings.position_embedding.weight"], device),
        "layers": layers,
    }


def convert_clip(sd: StateDict, cfg, prefix: str = "", device=None) -> Dict:
    """HF CLIPVisionModel state dict -> `models.clip` params (the reference's
    standalone towers, `openai/clip-vit-large-patch14-336` and
    `laion/CLIP-ViT-L-14-DataComp.XL-s13B-b90k`). ``cfg`` is a
    `config.ClipConfig`. The layout rules of `convert_siglip`, plus the CLS
    embedding, HF's ``pre_layrnorm`` (its spelling) and the pooled CLS's
    ``post_layernorm`` (kept, unused); the conv patch embed has no bias."""
    p = prefix
    layers = _vit_layers(sd, cfg, p, device)
    return {
        "class_embed": _to(sd[p + "embeddings.class_embedding"], device),
        "patch_embed": _patch_embed(sd, p, device),
        "pos_embed": _to(sd[p + "embeddings.position_embedding.weight"], device),
        "pre_ln_scale": _to(sd[p + "pre_layrnorm.weight"], device),
        "pre_ln_bias": _to(sd[p + "pre_layrnorm.bias"], device),
        "post_ln_scale": _to(sd[p + "post_layernorm.weight"], device),
        "post_ln_bias": _to(sd[p + "post_layernorm.bias"], device),
        "layers": layers,
    }


def convert_mmduet(sd: StateDict, cfg: MMDuetConfig, device=None) -> Dict:
    """Full checkpoint (llava-OV + score heads) -> MMDuet params tree."""
    if "lm_head.weight" in sd:
        lm_head = _t(_to(sd["lm_head.weight"], device))
    elif cfg.text.tie_word_embeddings:
        # tied checkpoints (e.g. the 0.5B family) omit lm_head.weight:
        # the head IS the embedding matrix
        lm_head = _t(_to(sd["model.embed_tokens.weight"], device))
    else:
        raise KeyError("lm_head.weight missing and tie_word_embeddings is false")
    params = {
        "decoder": convert_qwen2(sd, cfg.text, prefix="model.", device=device),
        "lm_head": lm_head,
    }
    for head in ("informative_head", "relevance_head"):
        key = f"{head}.weight"
        if key in sd:
            params[head] = _t(_to(sd[key], device))
        else:  # base llava checkpoint without duet heads: zero-init
            params[head] = torch.zeros((cfg.text.hidden_size, cfg.num_score_classes),
                                       dtype=lm_head.dtype, device=lm_head.device)

    # projector: llava mm_projector is Sequential(Linear, GELU, Linear)
    pj = "model.mm_projector."
    params["projector"] = {
        "fc1": _t(_to(sd[pj + "0.weight"], device)),
        "fc1_bias": _to(sd[pj + "0.bias"], device),
        "fc2": _t(_to(sd[pj + "2.weight"], device)),
        "fc2_bias": _to(sd[pj + "2.bias"], device),
    }

    # vision tower (llava nests it twice)
    for vp in ("model.vision_tower.vision_tower.vision_model.",
               "model.vision_tower.vision_model.", "vision_model."):
        if vp + "embeddings.patch_embedding.weight" in sd:
            params["vision"] = convert_siglip(sd, cfg.vision, prefix=vp, device=device)
            break
    else:
        params["vision"] = None  # feature-extraction-only checkpoints
    return params


# anchored to the DECODER path ("model.layers.N"): an adapter that also
# targets the vision tower ("...vision_tower...encoder.layers.N...") must
# not collide with decoder layers by index — those keys fall through to
# the strict leftover audit instead
_LORA_PAT = re.compile(
    r"model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+_proj)\.lora_(A|B)\.(?:default\.)?weight"
)


def convert_lora(sd: StateDict, cfg: Qwen2Config, device=None) -> Dict:
    """PEFT adapter state dict -> layer-stacked LoRA tree (lora_A/B only;
    `convert_adapter` also consumes the ``modules_to_save`` tensors)."""
    found: Dict[str, Dict[str, Dict[int, torch.Tensor]]] = {}
    for key, val in sd.items():
        m = _LORA_PAT.search(key)
        if not m:
            continue
        layer, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        found.setdefault(proj, {"a": {}, "b": {}})
        # A (r, in) -> a (in, r); B (out, r) -> b (r, out)
        found[proj]["a" if ab == "A" else "b"][layer] = _to(val, device).t()
    L = cfg.num_layers
    return {
        proj: {"a": torch.stack([ab["a"][i] for i in range(L)]),
               "b": torch.stack([ab["b"][i] for i in range(L)])}
        for proj, ab in found.items()
    }


def convert_modules_to_save(sd: StateDict, device=None) -> Tuple[Dict, set]:
    """PEFT ``modules_to_save`` tensors -> (param overrides, consumed keys).

    Reference-trained adapters carry FULLY fine-tuned projector and
    score-head weights under ``modules_to_save`` (`modeling_live.py:107-117`
    with `finetune_modules`); an adapter loader that only reads lora_A/B
    would silently run the base projector. Overrides are a subset of
    {"projector", "informative_head", "relevance_head"}. Keys that merely
    MENTION a known module but whose tensor slot is unrecognized are NOT
    marked consumed, so strict conversion still flags them."""
    overrides: Dict[str, Any] = {}
    proj: Dict[str, torch.Tensor] = {}
    consumed: set = set()
    for key, val in sd.items():
        if "modules_to_save" not in key:
            continue
        tail = key.split("modules_to_save.")[-1]
        if tail.startswith("default."):
            tail = tail[len("default."):]
        val = _to(val, device)
        if "mm_projector" in key or "connector" in key:
            # llava projector is Sequential(Linear, GELU, Linear): 0.* / 2.*
            slot = {
                "0.weight": ("fc1", True), "0.bias": ("fc1_bias", False),
                "2.weight": ("fc2", True), "2.bias": ("fc2_bias", False),
            }.get(tail)
            if slot:
                name, transpose = slot
                proj[name] = _t(val) if transpose else val
                consumed.add(key)
        elif "informative_head" in key and tail == "weight":
            overrides["informative_head"] = _t(val)
            consumed.add(key)
        elif "relevance_head" in key and tail == "weight":
            overrides["relevance_head"] = _t(val)
            consumed.add(key)
    if proj:
        overrides["projector"] = proj
    return overrides, consumed


def convert_adapter(sd: StateDict, cfg: Qwen2Config, strict: bool = True,
                    device=None) -> tuple:
    """Full PEFT adapter -> (lora tree, param overrides).

    ``strict`` raises on any adapter tensor this loader does not consume:
    an unconsumed tensor means the restored model silently differs from
    the trained one."""
    lora = convert_lora(sd, cfg, device)
    overrides, consumed = convert_modules_to_save(sd, device)
    leftover = [k for k in sd if k not in consumed and not _LORA_PAT.search(k)]
    if leftover:
        msg = f"adapter keys not consumed by conversion: {sorted(leftover)[:8]}"
        if strict:
            raise ValueError(msg + " (pass strict=False to ignore)")
        warnings.warn(msg)
    return lora, overrides


def load_hf_state_dict(model_dir: str) -> StateDict:
    """Every tensor of a local HF model directory, in its own dtype: the
    shards listed in ``model.safetensors.index.json``, else one
    ``model.safetensors``, else ``pytorch_model.bin``."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        sd: StateDict = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(_read_safetensors(os.path.join(model_dir, shard)))
        return sd
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return _read_safetensors(single)
    return torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)


def config_from_hf(hf_config: Dict[str, Any]) -> MMDuetConfig:
    """Map an HF llava-OV/Qwen2 config.json dict onto MMDuetConfig.

    Text fields come from the top-level Qwen2 entries; the vision tower
    is the fixed SigLIP-so400m-patch14-384 shape the checkpoint family
    uses (`models/arguments_live.py:10`, SURVEY.md §0)."""
    text = Qwen2Config(
        vocab_size=hf_config.get("vocab_size", 152064),
        hidden_size=hf_config.get("hidden_size", 3584),
        intermediate_size=hf_config.get("intermediate_size", 18944),
        num_layers=hf_config.get("num_hidden_layers", 28),
        num_heads=hf_config.get("num_attention_heads", 28),
        num_kv_heads=hf_config.get("num_key_value_heads", 4),
        head_dim=hf_config.get(
            "head_dim",
            hf_config.get("hidden_size", 3584)
            // hf_config.get("num_attention_heads", 28),
        ),
        rope_theta=hf_config.get("rope_theta", 1_000_000.0),
        rms_norm_eps=hf_config.get("rms_norm_eps", 1e-6),
        tie_word_embeddings=hf_config.get("tie_word_embeddings", False),
    )
    vis = hf_config.get("vision_config") or {}
    vision = SiglipConfig(
        image_size=vis.get("image_size", 384),
        patch_size=vis.get("patch_size", 14),
        hidden_size=vis.get("hidden_size", 1152),
        intermediate_size=vis.get("intermediate_size", 4304),
        num_layers=vis.get("num_hidden_layers", 27),
        num_heads=vis.get("num_attention_heads", 16),
    )
    stride = hf_config.get("video_pooling_stride", 4)
    pooled_side = -(-vision.num_patches_per_side // stride)
    return MMDuetConfig(
        text=text,
        vision=vision,
        frame_resolution=vis.get("image_size", 384),
        video_pooling_stride=stride,
        frame_num_tokens=hf_config.get("frame_num_tokens", pooled_side**2),
        # placeholder/eos ids are provisional: the tokenizer overrides
        # them at load time (reference `tokenization_live.py:122-124`)
        v_placeholder_id=text.vocab_size,
        eos_token_id=hf_config.get("eos_token_id", 151645),
    )


def _cast_floats(tree, dtype: torch.dtype):
    """Every floating leaf of ``tree`` in ``dtype`` (the scales of
    quantized leaves too, as the JAX converter casts them); integer
    leaves (int8 / packed int4 values) stay as they are."""
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if tree is None or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def convert_hf_checkpoint(
    model_dir: str,
    cfg: MMDuetConfig,
    lora_dir: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    quantize: Optional[str] = None,
    device="cuda",
):
    """Local HF llava-OV dir (+ optional PEFT adapter dir) -> (cfg, params,
    lora) on ``device``; cfg may differ from the input (``qkv_bias`` is
    derived from the checkpoint's keys).

    ``quantize="int8"`` / ``"int4"`` quantizes the decoder, embedding and
    LM head with `quant.quantize_params` (on ``device``) from the values
    in the file's dtype, before the other leaves are cast to ``dtype``, as
    the JAX converter does."""
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    sd = load_hf_state_dict(model_dir)
    # qkv_bias is a checkpoint property, not an HF-config field: derive it
    # from the actual keys so bias-free decoder variants convert cleanly
    # (the saved config then records it for the forward pass)
    has_bias = "model.layers.0.self_attn.q_proj.bias" in sd
    if cfg.text.qkv_bias != has_bias:
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, qkv_bias=has_bias))
    params = convert_mmduet(sd, cfg, device)
    del sd
    if quantize is not None:
        from .quant import quantize_params

        params = quantize_params(params, donate=True, bits=8 if quantize == "int8" else 4)
    params = _cast_floats(params, dtype)
    lora = None
    if lora_dir:
        from .lora import fold_lora_scale

        asd = _read_safetensors(os.path.join(lora_dir, "adapter_model.safetensors"))
        raw_lora, overrides = convert_adapter(asd, cfg.text, device=device)
        # PEFT applies alpha/r at load time (the reference serve path,
        # `models/modeling_live.py:121-123`); fold it into b once, here, so
        # the saved adapter is self-describing and serves at lora_scale=1.0
        acfg_path = os.path.join(lora_dir, "adapter_config.json")
        if not os.path.exists(acfg_path):
            raise FileNotFoundError(
                f"{acfg_path} missing: the adapter's lora_alpha/r are "
                "needed to scale it (a PEFT adapter dir always has one)"
            )
        with open(acfg_path) as f:
            acfg = json.load(f)
        scale = float(acfg["lora_alpha"]) / float(acfg["r"])
        # the fold in f32, as the JAX converter folds its f32 numpy leaves
        raw_lora = fold_lora_scale(_cast_floats(raw_lora, torch.float32), scale)
        lora = _cast_floats(raw_lora, dtype)
        # fully fine-tuned modules (projector / heads) replace base weights
        for name, val in overrides.items():
            params[name] = _cast_floats(val, dtype)
    return cfg, params, lora


TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "vocab.json",
    "merges.txt", "special_tokens_map.json", "added_tokens.json",
)


def main(argv=None):
    """CLI: local HF llava-OV dir (+ optional PEFT adapter dir) -> a
    checkpoint directory of the port (``config.json`` + ``params.pt``,
    `models.io`, plus the HF tokenizer's files, so the port's training and
    eval CLIs take it as ``--checkpoint``).

        python -m mmduet_tpu_torch.models.convert \\
            --hf_dir <llava-onevision-qwen2-7b-ov> \\
            [--lora_dir <mmduet-adapter>] --output <ckpt_dir> \\
            [--dtype bfloat16|float32] [--quantize int8|int4] [--device cuda]
    """
    import argparse
    import shutil

    from .io import save_checkpoint
    from .quant import param_bytes

    p = argparse.ArgumentParser(description="HF checkpoint -> mmduet_tpu_torch checkpoint")
    p.add_argument("--hf_dir", required=True)
    p.add_argument("--lora_dir", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quantize", default=None, choices=["int8", "int4"],
                   help="weight-only quantization of the decoder, embedding and LM "
                        "head (int4: group-128, nibble-packed)")
    p.add_argument("--device", default="cuda",
                   help="torch device the leaves are stacked and quantized on "
                        "(default cuda)")
    args = p.parse_args(argv)

    with open(os.path.join(args.hf_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg, params, lora = convert_hf_checkpoint(
        args.hf_dir, cfg, lora_dir=args.lora_dir, dtype=dtype,
        quantize=args.quantize, device=torch.device(args.device),
    )
    save_checkpoint(args.output, cfg, params, lora=lora)
    # ship the tokenizer alongside so HFTokenizerAdapter.from_pretrained
    # works on the output dir
    for name in TOKENIZER_FILES:
        src = os.path.join(args.hf_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.output, name))
    print(f"converted {param_bytes(params) / 1e9:.2f} GB of params -> {args.output}"
          + (" (with LoRA adapter)" if lora is not None else ""))


if __name__ == "__main__":
    main()
