"""Score-probability / logits parity of a checkpoint converted by the port
against its HF source: the real-weights gate of `docs/REAL_CHECKPOINT.md`
step 2, run on the PyTorch port. After
`python -m mmduet_tpu_torch.models.convert --hf_dir X --output Y [--dtype float32]`:

    python scripts/verify_checkpoint_parity_torch.py --hf_dir X --checkpoint Y \
        [--n_prompts 8] [--seq_len 64] [--atol 0.02] [--logits_atol A] \
        [--skip_vision] [--device cuda|cuda:N|cpu]

The four checks of `scripts/verify_checkpoint_parity.py`, on N seeded random
prompts and two random frames:

1. next-token logits at the last prompt position and their greedy argmax
   against HF `Qwen2ForCausalLM` in f32 (the llava-OV checkpoint loads as
   Qwen2; its vision and projector keys are unexpected and ignored);
2. the informative / relevance probabilities against HF's last hidden
   state times the score heads read from the checkpoint's files;
3. the SigLIP layer(-2) features against HF `SiglipVisionModel` rebuilt
   from the nested ``model.vision_tower.vision_tower.*`` weights;
4. the projector on those features against direct products of the
   ``mm_projector`` weights, and the pooled token count against the HF
   config's (a transposed or mis-mapped projector would otherwise pass and
   show only as wrong scores at eval time).

The oracle is HF ``transformers`` in f32 on the CPU (`hf_outputs`); it reads
the HF files with the port's own safetensors reader. The port's side
(`port_outputs`) is the port's code on ``--device``: `models.io.load_checkpoint`,
the streaming decoder forward that serving runs (`models.mmduet.step_forward`
over a fresh KV cache: the embedding, the layers, the LM head and the score
heads), `siglip_encode`, `project` and `spatial_pool`. On a CUDA device it
runs bf16 through the kernels (A for the decoder's attention, D for the
tower's); on the CPU, f32 through their plain versions, which is the
route to gate a ``--dtype float32`` conversion with. `compare` holds one
side's outputs against the other's. Exit code 0 iff every check holds.

The oracle needs ``transformers``; where it is missing the script stops
with an error that says so (`port_outputs` and `compare` do not need it).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from mmduet_tpu_torch.models.convert import _read_safetensors  # noqa: E402

HEADS = ("informative", "relevance")
VISION_PREFIX = "model.vision_tower.vision_tower."
PROJECTOR_KEYS = ("model.mm_projector.0.weight", "model.mm_projector.0.bias",
                  "model.mm_projector.2.weight", "model.mm_projector.2.bias")


def make_inputs(vocab_size: int, image_size: int, n_prompts: int, seq_len: int,
                seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray]:
    """The JAX gate's inputs from one seed: ``n_prompts`` (1, seq_len) id
    arrays, then two uint8 (image_size, image_size, 3) frames."""
    r = np.random.RandomState(seed)
    prompts = [r.randint(4, vocab_size - 8, (1, seq_len)) for _ in range(n_prompts)]
    pixels = r.randint(0, 255, (2, image_size, image_size, 3)).astype(np.uint8)
    return prompts, pixels


def _cast(tree, dtype: torch.dtype):
    """Floating leaves to ``dtype``; integer leaves (quantized weights) and
    the quantized leaves' scales as they are."""
    if isinstance(tree, dict):
        if "qs" in tree and ("qw" in tree or "qw4" in tree):
            return tree
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_tensor(tree) and tree.is_floating_point() else tree


def _guarded(out: Dict, name: str, fn) -> None:
    """``out[name] = fn()``, or the error's text (a failure of the check)."""
    try:
        out[name] = fn()
    except Exception as e:  # a mis-mapped leaf raises a shape error: the check fails
        out[name] = f"{type(e).__name__}: {e}"


def port_outputs(ckpt: str, device, prompts: Sequence[np.ndarray], pixels: np.ndarray,
                 vision: bool = True) -> Dict:
    """The port's outputs for the gate's inputs, from the checkpoint
    directory ``ckpt`` on ``device``, bf16 on a CUDA device (through the
    kernels), f32 on the CPU: per prompt its next-token logits (f32) and the
    two score probabilities, then (``vision``) the tower's layer(-2)
    features of ``pixels``, the projector's output on them and the pooled
    token count. A value that could not be computed is the error's text."""
    from mmduet_tpu_torch.models import mmduet, siglip
    from mmduet_tpu_torch.models.io import load_checkpoint
    from mmduet_tpu_torch.models.qwen2 import embed_tokens, init_kv_cache

    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg, params, _ = load_checkpoint(ckpt, device=device)
    params = _cast(params, dtype)
    tcfg = cfg.text
    out: Dict = {}
    with torch.inference_mode():
        for i, ids in enumerate(prompts):
            T = ids.shape[1]
            # a fresh cache per prompt, rounded up as the engines round theirs
            cache = init_kv_cache(tcfg, 1, -(-T // 2048) * 2048, dtype, device)

            def step():
                emb = embed_tokens(params["decoder"], torch.as_tensor(ids, device=device),
                                   tcfg.vocab_size).to(dtype)
                return mmduet.step_forward(params, cfg, emb, cache, 0, T)

            _guarded(out, f"prompt{i}", step)
            res = out.pop(f"prompt{i}")
            if isinstance(res, str):
                out[f"prompt{i} next-token logits"] = res
                continue
            out[f"prompt{i} next-token logits"] = res.last_logits[0].float().cpu().numpy()
            for head, prob in zip(HEADS, (res.informative_prob, res.relevance_prob)):
                out[f"prompt{i} {head}_prob"] = float(prob[0])
        if vision and "vision" in params:
            px = mmduet.normalize_pixels(cfg, torch.as_tensor(pixels, device=device)).to(dtype)
            _guarded(out, "vision layer(-2) features",
                     lambda: siglip.siglip_encode(params["vision"], cfg.vision, px))
            feats = out["vision layer(-2) features"]
            if torch.is_tensor(feats):
                _guarded(out, "projector output", lambda: mmduet.project(params, feats))
                proj = out["projector output"]
                if torch.is_tensor(proj):
                    _guarded(out, "pooled tokens",
                             lambda: int(mmduet.spatial_pool(proj, cfg).shape[1]))
                    out["config frame tokens"] = int(cfg.frame_num_tokens)
                    out["projector output"] = proj.float().cpu().numpy()
                out["vision layer(-2) features"] = feats.float().cpu().numpy()
    return out


def _hf_tensors(hf_dir: str, want) -> Dict[str, torch.Tensor]:
    """The f32 tensors of ``hf_dir`` whose names ``want(name)`` accepts,
    from its safetensors files (the port's reader), or from its
    ``pytorch_model*.bin`` files where it has none."""
    out: Dict[str, torch.Tensor] = {}
    files = sorted(glob.glob(os.path.join(hf_dir, "*.safetensors")))
    for path in files:
        for k, t in _read_safetensors(path).items():
            if want(k):
                out[k] = t.float()
    if not files:
        for path in sorted(glob.glob(os.path.join(hf_dir, "pytorch_model*.bin"))):
            for k, t in torch.load(path, map_location="cpu", weights_only=True).items():
                if want(k):
                    out[k] = t.float()
    return out


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise SystemExit(
            "verify_checkpoint_parity_torch: the HF oracle needs the transformers package, "
            f"which this Python lacks ({e}); run the gate where it is installed (the port's "
            "side alone is port_outputs)") from e
    return transformers


def _hf_decoder(transformers, hf_dir: str, hf_cfg: Dict):
    """HF `Qwen2ForCausalLM` in f32 from the config's Qwen2 fields and the
    directory's ``model.*`` / ``lm_head.*`` tensors (the vision tower and
    projector keys left out); every weight of the model must be found."""
    known = transformers.Qwen2Config().to_dict()
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        **{k: v for k, v in hf_cfg.items() if k in known and k != "model_type"},
        attn_implementation="eager")).float().eval()
    sd = _hf_tensors(hf_dir, lambda k: (k.startswith("model.") or k.startswith("lm_head."))
                     and not k.startswith(("model.vision_tower.", "model.mm_projector.")))
    missing, _ = model.load_state_dict(sd, strict=False)
    if model.config.tie_word_embeddings:
        missing = [k for k in missing if k != "lm_head.weight"]
    if missing:
        raise ValueError(f"{hf_dir}: the decoder's weights {missing} are not in its files")
    return model


def hf_outputs(hf_dir: str, prompts: Sequence[np.ndarray], pixels: np.ndarray,
               vision: bool = True) -> Dict:
    """The HF oracle's outputs for the gate's inputs, under the keys of
    `port_outputs`, in f32 on the CPU."""
    transformers = _transformers()
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    hf = _hf_decoder(transformers, hf_dir, hf_cfg)
    heads = _hf_tensors(hf_dir, lambda k: k in {f"{h}_head.weight" for h in HEADS})
    out: Dict = {}
    with torch.no_grad():
        for i, ids in enumerate(prompts):
            res = hf(torch.as_tensor(ids), output_hidden_states=True)
            out[f"prompt{i} next-token logits"] = res.logits[0, -1].numpy()
            hidden = res.hidden_states[-1][0, -1]  # after the final norm
            for head in HEADS:
                w = heads.get(f"{head}_head.weight")
                if w is not None:
                    out[f"prompt{i} {head}_prob"] = float(torch.softmax(w @ hidden, -1)[1])
    del hf
    if not vision:
        return out
    vis_sd = _hf_tensors(hf_dir, lambda k: k.startswith(VISION_PREFIX))
    if not vis_sd:
        print("skip vision: no nested vision tower in hf_dir")
        return out
    vcfg = hf_cfg.get("vision_config", {})
    known = transformers.SiglipVisionConfig().to_dict()
    tower = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        **{k: v for k, v in vcfg.items() if k in known}, attn_implementation="eager")).eval()
    tower.load_state_dict({k[len(VISION_PREFIX):]: v for k, v in vis_sd.items()}, strict=False)
    # SigLIP's preprocessing: rescale by 1/255, then mean and std 0.5
    norm = (torch.as_tensor(pixels).float() / 255.0 - 0.5) / 0.5
    pj = _hf_tensors(hf_dir, lambda k: k in PROJECTOR_KEYS)
    w0, b0, w2, b2 = (pj[k] for k in PROJECTOR_KEYS)
    with torch.no_grad():
        feats = tower(norm.permute(0, 3, 1, 2), output_hidden_states=True).hidden_states[-2]
        t = torch.nn.functional.gelu(feats @ w0.T + b0)
        out["vision layer(-2) features"] = feats.numpy()
        out["projector output"] = (t @ w2.T + b2).numpy()
    side = vcfg.get("image_size", 384) // vcfg.get("patch_size", 14)
    stride = hf_cfg.get("video_pooling_stride", 4)
    out["pooled tokens"] = int(hf_cfg.get("frame_num_tokens", (-(-side // stride)) ** 2))
    return out


def compare(a: Dict, b: Dict, atol: float, logits_atol: float,
            argmax_ties: float = 0.0) -> List[str]:
    """The checks of ``a`` (the side under test) against ``b`` (the
    reference), printed one a line; returns the names of those that fail.
    Every key of ``b`` is checked: max |a - b| within ``logits_atol`` for
    next-token logits, within ``atol`` for probabilities, features and the
    projector; pooled token counts equal (also to ``a``'s own config). The
    greedy argmax of every prompt must agree; a disagreement passes only
    where the reference's top two logits are within ``argmax_ties`` (0:
    never, the JAX gate's rule). A value that ``a`` could not compute (its
    error's text) or that is missing fails."""
    failures: List[str] = []

    def fail(name: str, why: str) -> None:
        print(f"FAIL {name}: {why}")
        failures.append(name)

    agree, n_prompts = 0, 0
    for name, want in b.items():
        got = a.get(name)
        if got is None or isinstance(got, str):
            fail(name, got or "not computed")
            continue
        if name == "pooled tokens":
            own = a.get("config frame tokens", got)
            if got != want or own != want:
                fail(name, f"{got} pooled tokens (config {own}), the HF config says {want}")
            else:
                print(f"ok   {name}: {got}")
            continue
        got_a, want_a = np.asarray(got, np.float32), np.asarray(want, np.float32)
        if got_a.shape != want_a.shape:
            fail(name, f"shape {got_a.shape}, want {want_a.shape}")
            continue
        tol = logits_atol if name.endswith("next-token logits") else atol
        diff = float(np.max(np.abs(got_a - want_a)))
        if diff <= tol:
            print(f"ok   {name}: max|diff|={diff:.5f} (atol {tol})")
        else:
            fail(name, f"max|diff|={diff:.5f} (atol {tol})")
        if name.endswith("next-token logits"):
            n_prompts += 1
            top2 = np.sort(want_a)[-2:]
            if int(np.argmax(got_a)) == int(np.argmax(want_a)) or top2[1] - top2[0] <= argmax_ties:
                agree += 1
    print(f"greedy argmax agreement: {agree}/{n_prompts}")
    if agree < n_prompts:
        failures.append("argmax")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_dir", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="a directory of `python -m mmduet_tpu_torch.models.convert`")
    p.add_argument("--n_prompts", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--atol", type=float, default=0.02,
                   help="max-abs tolerance on probs/features")
    p.add_argument("--logits_atol", type=float, default=None,
                   help="max-abs tolerance on next-token logits (default 10*atol). Run the "
                        "gate on a --dtype float32 conversion with --device cpu: bf16 against "
                        "HF-f32 drifts across 28 layers more than this gate can attribute")
    p.add_argument("--skip_vision", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the port's side runs (cuda, cuda:N or cpu); the oracle runs "
                        "on the CPU")
    args = p.parse_args(argv)
    _transformers()  # before the port loads 16 GB: the oracle is not optional

    from mmduet_tpu_torch.models.io import load_config

    cfg = load_config(os.path.join(args.checkpoint, "config.json"))
    prompts, pixels = make_inputs(cfg.text.vocab_size, cfg.vision.image_size,
                                  args.n_prompts, args.seq_len)
    ours = port_outputs(args.checkpoint, args.device, prompts, pixels,
                        vision=not args.skip_vision)
    theirs = hf_outputs(args.hf_dir, prompts, pixels, vision=not args.skip_vision)
    logits_atol = args.logits_atol if args.logits_atol is not None else 10 * args.atol
    failures = compare(ours, theirs, args.atol, logits_atol)
    if failures:
        print(f"PARITY FAILED: {failures}")
        return 1
    print("PARITY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
