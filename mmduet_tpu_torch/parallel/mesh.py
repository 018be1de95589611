"""The (data, model) meshes of the port.

Port of `mmduet_tpu/parallel/mesh.py`, with the two axis names of the JAX
package:

- ``data``  — the serving lanes (and, in training, the batch) are cut
  over it;
- ``model`` — attention heads, the MLP's intermediate dim and the
  vocabulary are cut over it (tensor parallelism).

Two kinds of mesh:

- `ProcessMesh`, one process per device: a group of ``data x model``
  ranks of `torch.distributed` (`initialize_distributed`, as
  ``torch.distributed.run`` starts them), each holding its own shard of
  the parameters (`parallel.sharding.shard_params`) on its own device.
  The collectives of `parallel.collectives` join the shards.
  `make_mesh` builds it once the group is initialized. In batched serving
  each data rank holds the device state of its own block of lanes
  (`lane_block`) and the model ranks of a data index its kv heads.
- `Mesh`, in one process on ONE device: all its entries the same
  `torch.device`, as the JAX package's tests lay an 8-way mesh over the
  host CPU. Under such a mesh the parameters stay whole and only the
  streaming attention runs per shard
  (`ops.attention.flash_decode_attention_sharded`). A mesh over several
  devices inside one process raises `NotImplementedError`: the port runs
  one process per card by design.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.attention import ShardCtx, shard_ctx_ok
from . import collectives

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


@dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A (data, model) grid of processes, one device each: this rank's
    place in it and the process groups of its two axes.

    Ranks are laid out model-fastest, as the JAX package reshapes its
    device list: rank ``d * model + m`` sits at ``coords == (d, m)``.
    ``model_group`` joins the ranks that share this rank's data index (the
    shards of one model replica), ``data_group`` those that share its model
    index. Both are None for a mesh made without `torch.distributed`
    (`sharding.shard_params` needs only the coordinates)."""

    dims: Tuple[int, int]  # (data, model)
    coords: Tuple[int, int]  # this rank's (data, model) index
    device: torch.device
    model_group: Any = None
    data_group: Any = None
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return self.dims[0] * self.dims[1]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.axis_names.index(axis)]


def initialize_distributed(backend: str, **kwargs) -> None:
    """Join this process to its group: `torch.distributed.init_process_group`
    over ``env://`` (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, as
    ``torch.distributed.run`` sets them). The caller names the backend:
    ``nccl`` where each rank has its own card, ``gloo`` for CPU ranks and
    for ranks that share one card (NCCL refuses two ranks on one device).
    Nothing switches to the other backend when one fails."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize_distributed: backend {backend!r} (nccl or gloo)")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(
                f"initialize_distributed: {var} is not set; start one process per rank "
                "with python -m torch.distributed.run --nproc_per_node N")
    dist.init_process_group(backend=backend, init_method="env://", **kwargs)


def leave_group() -> None:
    """After a process's last collective: wait for every rank, then leave
    the group (a rank that exits while another still reads its last
    collective aborts that rank). Nothing to do without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _process_mesh(shape: Optional[Tuple[int, int]], device) -> ProcessMesh:
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world, 1) if shape is None else tuple(shape)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device for this rank; pass device= (for example "
                "device='cpu') to lay it elsewhere")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # NCCL runs on the current device
    data_n, model_n = shape
    # every rank creates every group, in the same order
    model_groups = [dist.new_group([d * model_n + m for m in range(model_n)])
                    for d in range(data_n)]
    data_groups = [dist.new_group([d * model_n + m for d in range(data_n)])
                   for m in range(model_n)]
    d, m = divmod(rank, model_n)
    mesh = ProcessMesh(shape, (d, m), device, model_groups[d], data_groups[m])
    collectives.bind_model_axis(mesh.model_group, m, model_n)
    collectives.bind_data_axis(mesh.data_group, d, data_n)
    return mesh


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Union[Mesh, ProcessMesh]:
    """Build a (data, model) mesh. ``shape=None`` puts every entry on the
    data axis.

    - Without ``devices``, in a process of an initialized
      `torch.distributed` group (`initialize_distributed`): a
      `ProcessMesh` over the group's ranks, on ``device`` (default:
      ``cuda:LOCAL_RANK``). Every rank calls it with the same ``shape``.
      It binds this process's model and data axes
      (`collectives.bind_model_axis`, `bind_data_axis`): one process is
      one rank, and every forward it runs is on its shard.
    - Otherwise: a one-device `Mesh` over ``devices`` (default: the current
      CUDA device), whose entries must all be the same device.

    With no CUDA device and no device named it raises `RuntimeError`: a
    mesh is laid on the CPU only when the caller names the CPU
    (``devices=["cpu"]`` or ``device="cpu"``), never as a quiet fallback."""
    if devices is None and dist.is_available() and dist.is_initialized():
        return _process_mesh(shape, device)
    if device is not None:
        raise ValueError("make_mesh: device= names a rank's device; it needs an initialized "
                         "torch.distributed group (initialize_distributed)")
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
            f"make_mesh: a mesh over several devices ({sorted(map(str, set(devices)))}) in one "
            "process; the port runs one process per device (a ProcessMesh under "
            "torch.distributed.run), so a one-process mesh lies on one device")
    rows = tuple(tuple(devices[i * shape[1]:(i + 1) * shape[1]]) for i in range(shape[0]))
    return Mesh(rows)


def lane_block(mesh: Union[None, Mesh, ProcessMesh], lanes: int) -> Tuple[int, int]:
    """This rank's serving lanes ``[start, stop)``: under a `ProcessMesh`
    whose data axis divides ``lanes``, data rank d's contiguous block
    ``[d * lanes / D, (d + 1) * lanes / D)`` (the block ``PartitionSpec("data")``
    gives the lane dim); otherwise, and without a process mesh, all of
    them (lanes replicated, as the JAX engines replicate them)."""
    if not isinstance(mesh, ProcessMesh):
        return 0, lanes
    data_n = mesh.shape[DATA_AXIS]
    if data_n == 1 or lanes % data_n:
        return 0, lanes
    n = lanes // data_n
    d = mesh.index(DATA_AXIS)
    return d * n, (d + 1) * n


def serving_shard_ctx(mesh: Union[None, Mesh, ProcessMesh], num_heads: int, num_kv_heads: int,
                      lanes: int, device) -> Optional[ShardCtx]:
    """The `ShardCtx` a serving engine runs its streaming attention under,
    from its ``mesh`` (None without one, or when nothing is cut): heads
    over the ``model`` axis, and lanes over the ``data`` axis when it
    divides them (a single stream has one lane, so only its heads are
    cut). The mesh must lie on ``device``; head counts that do not divide
    the model axis raise (there is no other attention route to fall back
    to, where the JAX engines fall back to their jnp attention).

    A `ProcessMesh` gives None: each rank holds its own heads' shard
    (`sharding.shard_params`) and its own lanes (`lane_block`), and
    launches kernel A on them directly. Its axes must be the ones
    `make_mesh` bound in this process."""
    if mesh is None:
        return None
    if mesh.device != torch.device(device):
        raise ValueError(f"mesh on {mesh.device}, parameters on {device}")
    model_n, data_n = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    if isinstance(mesh, ProcessMesh):
        if num_heads % model_n or num_kv_heads % model_n:
            raise ValueError(f"mesh {mesh.shape}: {num_heads} heads / {num_kv_heads} kv heads "
                             "do not divide the model axis")
        if (collectives.model_axis() != (mesh.index(MODEL_AXIS), model_n)
                or collectives.data_axis() != (mesh.index(DATA_AXIS), data_n)):
            raise ValueError("the process mesh is not this process's bound axes "
                             "(make_mesh binds them)")
        return None
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
