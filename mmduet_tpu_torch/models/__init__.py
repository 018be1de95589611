from .qwen2 import KVCache, init_kv_cache, qwen2_forward, embed_tokens, lm_logits
from .siglip import siglip_encode, normalize_pixels
from .mmduet import (
    visual_embed,
    joint_embed,
    step_forward,
    frames_block_forward,
    decode_loop,
    spatial_pool,
    project,
    StepOutput,
    train_forward,
    masked_ce,
    TrainOutput,
)
from .lora import init_lora, lora_scale, fold_lora_scale, merge_lora
from .params import (init_clip_params, init_mmduet_params, params_from_numpy,
                     train_state_from_numpy)
