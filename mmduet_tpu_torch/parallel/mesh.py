"""The (data, model) device mesh of the port.

Port of `mmduet_tpu/parallel/mesh.py`. A `Mesh` here is a plain descriptor:
a (data, model) grid of `torch.device`s with the two axis names of the JAX
package,

- ``data``  — the serving lanes (and, in training, the batch) are cut
  over it;
- ``model`` — attention heads are cut over it.

For now a mesh must lie in one process on ONE device: all its entries the
same `torch.device`, as the JAX package's tests lay an 8-way mesh over the
host CPU. Under such a mesh the parameters stay whole and only the
streaming attention runs per shard
(`ops.attention.flash_decode_attention_sharded`). A mesh over several
devices (parameters cut over processes, `torch.distributed` collectives)
raises `NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.attention import ShardCtx, shard_ctx_ok

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices. ``shape`` maps axis name to size,
    ``size`` is the number of entries, ``device`` the one device they all
    name."""

    devices: Tuple[Tuple[torch.device, ...], ...]  # [data][model]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def device(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, model) mesh over ``devices`` (default: the current
    CUDA device). ``shape=None`` puts every entry on the data axis. The
    entries must all be the same device.

    Without ``devices`` on a host with no CUDA device it raises
    `RuntimeError`: a mesh is laid on the CPU only when the caller names
    the CPU (``devices=["cpu"]``), never as a quiet fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device for the default mesh; pass devices= "
                "(for example devices=['cpu']) to lay it elsewhere")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        # strict, as the JAX package: idling devices silently is a
        # throughput trap; a caller who wants a subset passes that subset
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"make_mesh: a mesh over several devices ({sorted(map(str, set(devices)))}) is "
            "not yet ported; a mesh must lie on one device")
    rows = tuple(tuple(devices[i * shape[1]:(i + 1) * shape[1]]) for i in range(shape[0]))
    return Mesh(rows)


def serving_shard_ctx(mesh: Optional[Mesh], num_heads: int, num_kv_heads: int, lanes: int,
                      device) -> Optional[ShardCtx]:
    """The `ShardCtx` a serving engine runs its streaming attention under,
    from its ``mesh`` (None without one, or when nothing is cut): heads
    over the ``model`` axis, and lanes over the ``data`` axis when it
    divides them (a single stream has one lane, so only its heads are
    cut). The mesh must lie on ``device``; head counts that do not divide
    the model axis raise (there is no other attention route to fall back
    to, where the JAX engines fall back to their jnp attention)."""
    if mesh is None:
        return None
    if mesh.device != torch.device(device):
        raise ValueError(f"mesh on {mesh.device}, parameters on {device}")
    model_n, data_n = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    lane_sharded = data_n > 1 and lanes % data_n == 0
    if model_n == 1 and not lane_sharded:
        return None
    ctx = ShardCtx(
        mesh,
        lane_axis=DATA_AXIS if lane_sharded else None,
        head_axis=MODEL_AXIS if model_n > 1 else None,
    )
    if not shard_ctx_ok(ctx, num_heads, num_kv_heads, lanes):
        raise ValueError(
            f"mesh {mesh.shape}: {num_heads} heads / {num_kv_heads} kv heads do not divide "
            "the model axis")
    return ctx
