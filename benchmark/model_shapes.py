"""The sizes of a configuration file (``benchmark/configs/<config>.json``)
that every decoder architecture shares, as the harness, the reference and
the arithmetic read them.

A file holds its decoder's published keys at the top level (its
``config.json``), which its architecture reads
(``benchmark/arch/<architecture>.py``, found from ``architectures[0]``:
`benchmark.spec.architecture`); the vision tower's under ``vision_config``
(SigLIP-so400m's ``config.json``), the LLaVA projector's ``mm_*`` keys,
MMDuet's streaming additions under ``mmduet``, how the benchmark serves it
under ``serving``, and the keys that describe the file and its check.
`common` reads these and raises `UnsupportedConfig` on a key or a value
that neither it nor the architecture honours (a tied head where the
architecture has none, another pooling, an unknown key), so that no file is
served as something it does not describe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .spec import UnsupportedConfig

# key -> the values the harness honours (None: read, any value); a key that
# neither this nor the architecture's DECODER_KEYS lists is refused
SHARED_KEYS = {
    "mm_vision_select_layer": None, "vision_config": None, "mmduet": None, "serving": None,
    "mm_projector_type": ("mlp2x_gelu",), "mm_vision_tower": None, "mm_hidden_size": None,
    # what describes the file and the check, and serves nothing (`architectures` and
    # `reference` find files: `benchmark.spec`)
    "name": None, "source": None, "architectures": None, "reference": None, "assumed": None,
    "limits": None,
}
VISION_KEYS = {"image_size", "patch_size", "hidden_size", "intermediate_size",
               "num_hidden_layers", "num_attention_heads", "layer_norm_eps", "source"}
MMDUET_KEYS = {"frame_num_tokens": None, "video_pooling_stride": None,
               "spatial_pool_mode": ("bilinear",), "num_score_classes": (2,),
               "score_heads": (["informative_head", "relevance_head"],), "source": None}
SERVING_KEYS = {"weights_seed": None, "weights_dtype": ("bfloat16",), "weight_bits": (None, 4),
                "kv_cache_quant": (None, "int8"), "group_size": (128,),
                "weights": None, "quantization": None}


def _honoured(group: dict, allowed: dict, where: str) -> None:
    for key, value in group.items():
        if key not in allowed:
            raise UnsupportedConfig(f"{where}{key}: a key the benchmark does not serve")
        if allowed[key] is not None and value not in allowed[key]:
            raise UnsupportedConfig(f"{where}{key} = {value!r}: the benchmark serves "
                                    f"{' or '.join(map(repr, allowed[key]))}")


@dataclass(frozen=True, kw_only=True)
class Shapes:
    """What every architecture shares; an architecture's ``Shapes`` adds its
    decoder's sizes."""

    vocab: int  # the decoder's vocabulary: the LM head's columns, the tokenizer's ids
    hidden: int  # the decoder's width: the projector's output, the score heads' input
    v_image: int
    patch: int
    v_hidden: int
    v_intermediate: int
    v_layers: int  # the tower's layers (the features are taken at select_layer)
    v_heads: int
    v_eps: float
    select_layer: int
    frame_tokens: int
    pool_stride: int
    weights_seed: int  # one model for every run: the seed of its weights
    weight_bits: Optional[int]  # None: bf16 weights; 4: group-wise int4
    group: int
    kv_quant: Optional[str]  # None or "int8"
    pool_mode: str = "bilinear"  # how a frame's patch grid pools to its tokens

    @property
    def v_head_dim(self) -> int:
        return self.v_hidden // self.v_heads

    @property
    def v_side(self) -> int:
        return self.v_image // self.patch

    @property
    def v_patches(self) -> int:
        return self.v_side ** 2

    @property
    def v_used_layers(self) -> int:
        """The tower's layers that run: all up to ``select_layer``."""
        sl = self.select_layer
        return self.v_layers + sl + 1 if sl < 0 else sl + 1


def common(cfg: dict, decoder_keys: dict) -> dict:
    """The fields of `Shapes` but ``vocab`` and ``hidden`` (the
    architecture's to read), once every top-level key is one of
    ``decoder_keys`` (the architecture's, in the form of `SHARED_KEYS`) or
    `SHARED_KEYS`, and every value one they honour."""
    v, m, s = cfg["vision_config"], cfg["mmduet"], cfg["serving"]
    _honoured(cfg, {**SHARED_KEYS, **decoder_keys}, "")
    _honoured(v, dict.fromkeys(VISION_KEYS), "vision_config.")
    _honoured(m, MMDUET_KEYS, "mmduet.")
    _honoured(s, SERVING_KEYS, "serving.")
    if cfg.get("mm_hidden_size", v["hidden_size"]) != v["hidden_size"]:
        raise UnsupportedConfig("mm_hidden_size is not the tower's hidden_size")
    return dict(
        v_image=v["image_size"], patch=v["patch_size"], v_hidden=v["hidden_size"],
        v_intermediate=v["intermediate_size"], v_layers=v["num_hidden_layers"],
        v_heads=v["num_attention_heads"], v_eps=float(v["layer_norm_eps"]),
        select_layer=cfg["mm_vision_select_layer"], frame_tokens=m["frame_num_tokens"],
        pool_stride=m["video_pooling_stride"], weights_seed=s["weights_seed"],
        weight_bits=s.get("weight_bits"), group=s.get("group_size", 128),
        kv_quant=s.get("kv_cache_quant"), pool_mode=m.get("spatial_pool_mode", "bilinear"),
    )
