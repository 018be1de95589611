"""MMDuet in PyTorch, for one NVIDIA Hopper GPU.

The port of `mmduet_tpu` (JAX on a TPU), which stays the reference. It
imports `torch`, never `jax`, and nothing of the JAX package: the host
code it needs (`config`, `stream`, `data`, the inference CLI's helpers,
the engines' and the training loop's helpers) is its own copy, pinned
equal to the original by `tests/test_torch_hostcode.py`.

Subpackages mirror the old layout:

- ``mmduet_tpu_torch.ops``    -- the hand-written CUDA kernels (streaming
  split attention with a bf16 or an int8 cache, training attention
  forward and backward, the int4 matrix product), each beside its plain
  PyTorch version
- ``mmduet_tpu_torch.models`` -- Qwen2 decoder (full, streaming and
  scratch-decode modes, runtime LoRA, dense or quantized weights), SigLIP
  tower, projector, pooling, score heads, parameters, quantizers,
  checkpoint IO
- ``mmduet_tpu_torch.infer``  -- single-stream `LiveInferEngine`
- ``mmduet_tpu_torch.train``  -- LoRA training step, optimizer, loop CLI
- ``mmduet_tpu_torch.eval``   -- the single-stream inference CLI
- ``mmduet_tpu_torch.config``, ``.stream``, ``.data`` -- configuration,
  chat template / tokenizers / labels, datasets and video decoding
"""
