"""Checkpoint IO: model params + config in the port's format.

Port of `mmduet_tpu/models/io.py`. A checkpoint directory is

    <dir>/config.json  the shared `MMDuetConfig` as a nested dict (the JAX
                       package's file, read by either package)
    <dir>/params.pt    ``{"params": tree, "lora": tree or None}``, one
                       `torch.save` file

``save_config`` / ``load_config`` are copies of the JAX module's (which
imports jax), pinned equal by the tests.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

import torch

from mmduet_tpu.config import MMDuetConfig, Qwen2Config, SiglipConfig

PARAMS_FILE = "params.pt"


def save_config(cfg: MMDuetConfig, path: str) -> None:
    d = dataclasses.asdict(cfg)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_config(path: str) -> MMDuetConfig:
    with open(path) as f:
        d = json.load(f)
    d["text"] = Qwen2Config(**d["text"])
    d["vision"] = SiglipConfig(**d["vision"])
    return MMDuetConfig(**d)


def save_checkpoint(ckpt_dir: str, cfg: MMDuetConfig, params, lora=None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"{PARAMS_FILE}.{os.getpid()}.tmp")
    torch.save({"params": params, "lora": lora}, tmp)
    os.replace(tmp, os.path.join(ckpt_dir, PARAMS_FILE))
    save_config(cfg, os.path.join(ckpt_dir, "config.json"))


def load_checkpoint(ckpt_dir: str, device="cpu") -> Tuple[MMDuetConfig, Any, Optional[Any]]:
    cfg = load_config(os.path.join(ckpt_dir, "config.json"))
    tree = torch.load(os.path.join(ckpt_dir, PARAMS_FILE), map_location=device,
                      weights_only=True)
    return cfg, tree["params"], tree["lora"]
