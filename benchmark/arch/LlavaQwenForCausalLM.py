"""LLaVA-OneVision's Qwen2 decoder (``"architectures":
["LlavaQwenForCausalLM"]``): GQA with q/k/v biases, RoPE, RMSNorm, a SwiGLU
MLP and an untied LM head. What the harness, the weights and the operation
count know of it; its plain reference is the file a configuration's
``reference`` names (`benchmark/reference/model.py`). Loaded by path
(`benchmark.spec.architecture`).
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark import model_shapes, weights
from benchmark.flops import lm_head_row, score_heads_frame, vision_frame  # noqa: F401

# the published keys of Qwen2's `config.json` that the harness honours, in
# the form of `model_shapes.SHARED_KEYS`
DECODER_KEYS = {
    "vocab_size": None, "hidden_size": None, "intermediate_size": None,
    "num_hidden_layers": None, "num_attention_heads": None, "num_key_value_heads": None,
    "rope_theta": None, "rms_norm_eps": None, "tie_word_embeddings": (False,),
}


@dataclass(frozen=True, kw_only=True)
class Shapes(model_shapes.Shapes):
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    rope_theta: float
    rms_eps: float
    tie: bool = False  # the LM head tied to the embedding
    qkv_bias: bool = True  # the q/k/v projections carry a bias

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def shapes(cfg: dict) -> Shapes:
    return Shapes(
        **model_shapes.common(cfg, DECODER_KEYS),
        vocab=cfg["vocab_size"], hidden=cfg["hidden_size"],
        intermediate=cfg["intermediate_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
        tie=cfg.get("tie_word_embeddings", False),
    )


def leaves(s: Shapes):
    """(what quantization replaces, the rest), each in a fixed order."""
    L, h, q, kv, mi, V = s.layers, s.hidden, s.q_dim, s.kv_dim, s.intermediate, s.vocab
    quantized = [
        (("decoder", "layers", "q_proj"), (L, h, q), "dense"),
        (("decoder", "layers", "k_proj"), (L, h, kv), "dense"),
        (("decoder", "layers", "v_proj"), (L, h, kv), "dense"),
        (("decoder", "layers", "o_proj"), (L, q, h), "dense"),
        (("decoder", "layers", "gate_proj"), (L, h, mi), "dense"),
        (("decoder", "layers", "up_proj"), (L, h, mi), "dense"),
        (("decoder", "layers", "down_proj"), (L, mi, h), "dense"),
        (("decoder", "embed"), (V, h), "small"),
        (("lm_head",), (h, V), "dense"),
    ]
    rest = [
        (("decoder", "layers", "input_norm"), (L, h), "norm"),
        (("decoder", "layers", "post_attn_norm"), (L, h), "norm"),
        (("decoder", "layers", "q_bias"), (L, q), "small"),
        (("decoder", "layers", "k_bias"), (L, kv), "small"),
        (("decoder", "layers", "v_bias"), (L, kv), "small"),
        (("decoder", "final_norm"), (h,), "norm"),
    ]
    return quantized, rest + weights.shared(s)


def port_config(s: Shapes):
    """The port's configuration of what `shapes` accepted: the Qwen2
    decoder, the tower, MMDuet's bilinear pooling; nothing else is served."""
    from mmduet_tpu_torch.config import MMDuetConfig, Qwen2Config, SiglipConfig

    return MMDuetConfig(
        text=Qwen2Config(vocab_size=s.vocab, hidden_size=s.hidden,
                         intermediate_size=s.intermediate, num_layers=s.layers,
                         num_heads=s.heads, num_kv_heads=s.kv_heads, head_dim=s.head_dim,
                         rope_theta=s.rope_theta, rms_norm_eps=s.rms_eps,
                         tie_word_embeddings=s.tie, qkv_bias=s.qkv_bias),
        vision=SiglipConfig(image_size=s.v_image, patch_size=s.patch, hidden_size=s.v_hidden,
                            intermediate_size=s.v_intermediate, num_layers=s.v_layers,
                            num_heads=s.v_heads, layer_norm_eps=s.v_eps),
        frame_resolution=s.v_image, frame_num_tokens=s.frame_tokens,
        video_pooling_stride=s.pool_stride, spatial_pool_mode=s.pool_mode,
    )


# operations (`benchmark.flops`); RoPE, norms and activations are left out


def decoder_token(s: Shapes) -> float:
    """The decoder's seven projections for one token (attention apart)."""
    layer = s.hidden * s.q_dim + 2 * s.hidden * s.kv_dim + s.q_dim * s.hidden
    layer += 3 * s.hidden * s.intermediate
    return 2.0 * s.layers * layer


def attention(s: Shapes, cache_len: int, t: int) -> float:
    """A chunk of ``t`` tokens after ``cache_len`` committed ones, every
    layer: QK and PV over each visible (query, key) pair."""
    pairs = t * cache_len + t * (t + 1) // 2
    return 2 * 2.0 * s.head_dim * s.heads * pairs * s.layers


def chunk(s: Shapes, cache_len: int, t: int) -> float:
    return t * decoder_token(s) + attention(s, cache_len, t)
