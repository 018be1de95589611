"""Configuration dataclasses for MMDuet-TPU.

Mirrors the knob surface of the reference implementation
(`models/arguments_live.py`, `models/configuration_live.py` in
yellow-binary-tree/MMDuet) but as plain dataclasses: model architecture
configs are static (hashable) so they can be closed over by jitted
functions, and runtime args are simple CLI-parseable dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# ---------------------------------------------------------------------------
# Model architecture configs (static / hashable — safe to close over in jit)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder architecture.

    Defaults are the Qwen2-7B shape used by LLaVA-OneVision
    (cf. reference `models/live_llava/video_head_live_llava_qwen.py:41-45`).
    """

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    qkv_bias: bool = True  # Qwen2 uses bias on q/k/v projections only

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclass(frozen=True)
class SiglipConfig:
    """SigLIP vision tower. Defaults = so400m-patch14-384 (LLaVA-OV tower)."""

    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    layer_norm_eps: float = 1e-6

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2


@dataclass(frozen=True)
class ClipConfig:
    """CLIP vision tower (reference standalone path,
    `models/vision_live.py:34-64`). Defaults = ViT-L/14-336
    (`openai/clip-vit-large-patch14-336`); the DataComp ViT-L/14 uses
    image_size=224. Same field names as SiglipConfig so tower code can
    take either."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2


@dataclass(frozen=True)
class MMDuetConfig:
    """Full multimodal streaming model: tower + projector + decoder + heads.

    The streaming-specific fields mirror the reference
    `VideoHeadLiveConfigMixin` (`models/configuration_live.py:22-37`) and
    `VideoHeadLiveLlavaQwenConfig` (`video_head_live_llava_qwen.py:41-45`).
    """

    text: Qwen2Config = field(default_factory=Qwen2Config)
    vision: SiglipConfig = field(default_factory=SiglipConfig)

    # projector: 2-layer MLP vision_hidden -> hidden -> hidden with GELU
    projector_layers: int = 2

    # streaming / frame tokenization
    frame_resolution: int = 384
    frame_num_tokens: int = 49  # 7x7 after pooling
    video_pooling_stride: int = 4
    spatial_pool_mode: str = "bilinear"  # average | max | bilinear
    # vision tower architecture: "siglip" = the llava-path tower with
    # post-projector bilinear pooling (flagship checkpoint); "clip" = the
    # reference standalone CLIP path (`models/vision_live.py:34-64`) with
    # tower-side adaptive pooling + the two knobs below
    vision_arch: str = "siglip"
    frame_token_cls: bool = False  # prepend the CLS token (clip arch)
    frame_token_pooled: Optional[Tuple[int, int]] = None  # e.g. (7, 7)
    v_placeholder: str = "<image>"
    v_placeholder_id: int = -1  # filled in by tokenizer builder
    eos_token_id: int = -1  # filled in by tokenizer builder

    # score heads
    num_score_classes: int = 2
    video_head_stop_grad: bool = False

    # loss weights (reference hardcodes 1/1: video_head_live_llava_qwen.py:83-84)
    lm_loss_weight: float = 1.0
    video_loss_weight: float = 1.0

    def replace(self, **kw) -> "MMDuetConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(
    vocab_size: int = 512,
    hidden_size: int = 64,
    num_layers: int = 2,
    frame_num_tokens: int = 4,
) -> MMDuetConfig:
    """A tiny random-weight config for CPU tests."""
    return MMDuetConfig(
        text=Qwen2Config(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_layers=num_layers,
            num_heads=4,
            num_kv_heads=2,
            head_dim=hidden_size // 4,
        ),
        vision=SiglipConfig(
            image_size=32,
            patch_size=8,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=2,
        ),
        frame_resolution=32,
        frame_num_tokens=frame_num_tokens,
        video_pooling_stride=2,
    )


# ---------------------------------------------------------------------------
# Runtime arguments (training / inference) — reference arguments_live.py
# ---------------------------------------------------------------------------

DEFAULT_SYSTEM_PROMPT = (
    "A multimodal AI assistant is helping users with some activities."
    " Below is their conversation, interleaved with the list of video frames"
    " received by the assistant."
)


@dataclass
class TrainArgs:
    """Training knobs (reference `LiveTrainingArguments`, arguments_live.py:5-28)."""

    dataset_config: Optional[str] = None
    llm_pretrained: str = "lmms-lab/llava-onevision-qwen2-7b-ov"
    lora_pretrained: Optional[str] = None
    lora_modules: str = r"q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj"
    lora_r: int = 16
    lora_alpha: int = 32
    lora_dropout: float = 0.05
    # full-finetune modules alongside LoRA (reference bug #2 fixed: real head names)
    finetune_modules: List[str] = field(
        default_factory=lambda: ["projector", "informative_head", "relevance_head"]
    )
    frame_fps: float = 2.0
    frame_num_tokens: int = 49
    video_pooling_stride: int = 4
    frame_resolution: int = 384
    v_placeholder: str = "<image>"
    max_num_frames: int = 100
    system_prompt: str = DEFAULT_SYSTEM_PROMPT

    # optimization (reference scripts/train.sh:4-17)
    learning_rate: float = 2e-5
    lr_schedule: str = "cosine"
    warmup_ratio: float = 0.05
    num_epochs: int = 1
    per_device_batch_size: int = 1
    grad_accum_steps: int = 16
    gradient_checkpointing: bool = True
    bf16: bool = True
    seed: int = 42
    lm_loss_weight: float = 1.0
    video_loss_weight: float = 1.0

    # checkpointing
    output_dir: str = "outputs/debug"
    save_steps: int = 500
    save_total_limit: int = 5
    resume_from_checkpoint: Optional[str] = None
    logging_steps: int = 10

    # mesh
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, model); None = all data
    dataloader_num_workers: int = 4


@dataclass
class TestArgs(TrainArgs):
    """Streaming-inference knobs (reference `LiveTestArguments`, arguments_live.py:31-55)."""

    is_online_model: bool = True
    grounding_mode: bool = False  # scores only, never generate
    input_dir: str = ""
    test_fname: str = ""
    output_fname: str = ""
    repetition_penalty: Optional[float] = None
    stream_end_prob_threshold: Optional[float] = None
    stream_end_score_sum_threshold: Optional[float] = None
    threshold_z: Optional[float] = None
    first_n_frames_no_generate: int = 0
    running_list_length: int = 20
    start_idx: int = 0
    end_idx: Optional[int] = None
    remove_assistant_turns: bool = False
    score_heads: str = "informative_score"
    max_num_frames: int = 400
    max_new_tokens: int = 200
