"""Sharding rules: which dim of each leaf is cut over which mesh axis, and
each rank's local tree.

Port of `mmduet_tpu/parallel/sharding.py`. The rules are the JAX
package's, as pure functions of leaf paths and shapes; a spec is a tuple
with one axis name or None per dim (the JAX `PartitionSpec`'s entries):

- ``mode="replicate"``: parameters replicated over ``data``, optimizer
  state cut over it (the ZeRO-2 equivalent);
- ``mode="fsdp"``: parameters also cut over ``data`` on their largest
  divisible dim (ZeRO-3 / FSDP);
- tensor parallelism over ``model`` by name: q/k/v/gate/up and the
  towers' and projector's fc1 cut on the output dim, o/down and fc2 on the
  input dim, their biases with their outputs, the embedding and the LM
  head on the vocabulary (the Megatron layout: one all-reduce after each
  attention and MLP block). Quantized ``{qw, qw4, qs}`` leaves follow
  their parent's name; LoRA adapters, ``o_bias``, ``fc2_bias`` and the
  score heads stay whole. A dim that does not divide its axis stays
  whole.

XLA derives the collectives from these specs; the port's ranks compute
on their local trees (`shard_params`) and call `parallel.collectives`.
One leaf differs from the JAX layout: an int4 leaf cut on its input dim
(o_proj, down_proj, fc2). The JAX spec cuts its packed ``g/2`` axis, whose
byte j holds input values j and j + g/2 of a group (split-halves order),
so a rank's bytes would pair with input columns of other ranks' heads;
GSPMD reshards around that, rank-local compute cannot. `shard_params`
gives each rank the repacking of its contiguous input columns instead
(`_int4_input_cut`): the same integers under the same scales.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.quant import pack_int4, unpack_int4
from .mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh

Spec = Tuple[Optional[str], ...]

# name -> the dim cut over ``model`` for layer-stacked weights (L, in, out)
_TP_LAST = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1")
_TP_SECOND = ("o_proj", "down_proj", "fc2")
_TP_BIAS = ("q_bias", "k_bias", "v_bias", "fc1_bias")


def _map(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (named
    tuples keep their type), with the JAX package's path strings: keys and
    indices joined by '/'."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree)


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", ()))


def _spec_for(path: str, shape, data_n: int, model_n: int, mode: str) -> Spec:
    dims: list = [None] * len(shape)
    parts = path.split("/")
    name = parts[-1]
    if name in ("qw", "qw4", "qs") and len(parts) >= 2:
        # a quantized leaf follows its parent weight's rule; int8's qs keeps
        # the reduced dim as 1, which stays whole (a per-column scale
        # commutes with the reduce)
        name = parts[-2]
    in_layers = "layers" in path

    def try_axis(i: int, axis: str, n: int) -> bool:
        if n > 1 and dims[i] is None and shape[i] % n == 0 and shape[i] >= n:
            dims[i] = axis
            return True
        return False

    if model_n > 1:
        if "lora" in path:
            pass  # adapters are small: whole on every rank
        elif name in _TP_LAST and len(shape) >= 2:
            try_axis(len(shape) - 1, MODEL_AXIS, model_n)
        elif name in _TP_SECOND and len(shape) >= 2:
            try_axis(len(shape) - 2, MODEL_AXIS, model_n)
        elif name in _TP_BIAS:
            try_axis(len(shape) - 1, MODEL_AXIS, model_n)
        elif name == "embed":
            try_axis(0, MODEL_AXIS, model_n)  # vocab
        elif name == "lm_head":
            try_axis(len(shape) - 1, MODEL_AXIS, model_n)  # vocab

    if mode == "fsdp" and data_n > 1 and len(shape) >= 2:
        order = sorted(range(1 if in_layers else 0, len(shape)), key=lambda i: -shape[i])
        for i in order:
            if try_axis(i, DATA_AXIS, data_n):
                break
    return tuple(dims)


def param_shardings(params: Any, mesh, mode: str = "replicate") -> Any:
    """The tree of specs for ``params`` (mode: replicate | fsdp); ``mesh``
    is anything with a ``shape`` dict of the two axes."""
    data_n, model_n = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    return _map(lambda path, x: _spec_for(path, _shape(x), data_n, model_n, mode), params)


def batch_shardings(batch: Any, mesh) -> Any:
    """Batch leaves cut over ``data`` on dim 1 (training batches carry the
    grad-accumulation axis first: B for token leaves (A, B, T), N frames
    for vision leaves (A, N, ...)); rank-1 leaves and dims that do not
    divide stay whole."""
    data_n = mesh.shape[DATA_AXIS]

    def leaf(_, x) -> Spec:
        shape = _shape(x)
        if data_n > 1 and len(shape) >= 2 and shape[1] % data_n == 0:
            return (None, DATA_AXIS)
        return ()

    return _map(leaf, batch)


def _zero_spec(shape, data_n: int) -> Spec:
    """The largest divisible dim carries ``data`` (ZeRO optimizer sharding)."""
    dims: list = [None] * len(shape)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % data_n == 0 and shape[i] >= data_n:
            dims[i] = DATA_AXIS
            break
    return tuple(dims)


def _opt_spec(x: Any, data_n: int) -> Spec:
    shape = _shape(x)
    return _zero_spec(shape, data_n) if data_n > 1 and len(shape) >= 1 else ()


def opt_state_shardings(opt_state: Any, mesh) -> Any:
    """ZeRO-2 (the reference's `configs/deepspeed/zero2.json`): every
    optimizer-state leaf cut over ``data`` on its largest divisible dim."""
    return _map(lambda _, x: _opt_spec(x, mesh.shape[DATA_AXIS]), opt_state)


def replicated(mesh=None) -> Spec:
    """The spec of a leaf whole on every rank."""
    return ()


def train_state_shardings(state: Any, mesh, param_mode: str = "replicate") -> Any:
    """Specs of a `train.step.TrainState`: the trainable leaves by the
    parameter rules, the optimizer state ZeRO-2, the step whole."""
    return type(state)(
        step=replicated(mesh),
        trainable=param_shardings(state.trainable, mesh, mode=param_mode),
        opt_state=opt_state_shardings(state.opt_state, mesh),
    )


def kv_cache_sharding(mesh, num_kv_heads: int, lanes: Optional[int] = None) -> Spec:
    """The (L, B, kh, S, hd) serving cache: kv heads over ``model`` with
    the k/v projections (so cache writes and attention stay on each rank),
    and with ``lanes`` (batched serving) the lane dim over ``data``. No
    trailing Nones, as the JAX package writes them."""
    model_n = mesh.shape[MODEL_AXIS]
    data_n = mesh.shape.get(DATA_AXIS, 1)
    tp = model_n > 1 and num_kv_heads % model_n == 0
    dp = lanes is not None and data_n > 1 and lanes % data_n == 0 and lanes >= data_n
    if tp and dp:
        return (None, DATA_AXIS, MODEL_AXIS)
    if tp:
        return (None, None, MODEL_AXIS)
    if dp:
        return (None, DATA_AXIS)
    return ()


# ---------------------------------------------------------------------------
# Each rank's local tree
# ---------------------------------------------------------------------------


def _local(x: torch.Tensor, spec: Spec, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each cut dim sliced to
    the rank's contiguous part."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n, i = mesh.shape[axis], mesh.index(axis)
            part = x.shape[dim] // n
            x = x.narrow(dim, i * part, part)
    return x


def _placed(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device``, sharing no memory with the
    input tree (which the caller frees)."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def _int4_input_cut(leaf: Dict[str, torch.Tensor], rank: int, n: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous 1/n of the input rows of an int4 leaf
    (``qw4`` (..., G, g/2, O) in split-halves order, ``qs`` (..., G, 1, O)),
    as an int4 leaf of its own that dequantizes to exactly those rows:

    - whole groups when the rank's rows are whole groups (the 7B case):
      ``qw4`` and ``qs`` cut on G;
    - inside one group when the rank's c rows are a part of a group of g:
      one local group of c values under the parent group's scale, repacked
      in split-halves order for the group size c."""
    qw4, qs = leaf["qw4"], leaf["qs"]
    G, g = qw4.shape[-3], 2 * qw4.shape[-2]
    rows = G * g
    if rows % n:
        raise ValueError(f"int4 input cut: {rows} rows over {n} ranks")
    c = rows // n
    if c % g == 0:
        span = slice(rank * c // g, (rank + 1) * c // g)
        return {"qw4": qw4[..., span, :, :], "qs": qs[..., span, :, :]}
    if g % c or c % 2:
        raise ValueError(f"int4 input cut: {c} rows a rank straddle groups of {g}")
    parent, offset = divmod(rank * c, g)
    values = unpack_int4(qw4[..., parent:parent + 1, :, :], -2)  # (..., 1, g, O)
    return {"qw4": pack_int4(values[..., offset:offset + c, :], -2),
            "qs": qs[..., parent:parent + 1, :, :]}


def shard_params(params: Any, mesh: ProcessMesh, mode: str = "replicate") -> Any:
    """This rank's local tree of ``params``: each leaf cut by
    `param_shardings` to the rank's block, contiguous, on ``mesh.device``
    (an int4 leaf cut on its input rows by `_int4_input_cut`). The input
    tree may lie anywhere; it is read, never changed, and the local tree
    shares no memory with it."""
    data_n, model_n = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]

    def walk(tree: Any, path: str) -> Any:
        name = path.split("/")[-1]
        if (isinstance(tree, dict) and "qw4" in tree and name in _TP_SECOND
                and "lora" not in path):
            spec = _spec_for(f"{path}/qw4", tuple(tree["qw4"].shape), data_n, model_n, mode)
            if MODEL_AXIS in spec:
                if DATA_AXIS in spec:
                    raise ValueError(f"{path}: an int4 serving leaf under fsdp (a training mode)")
                local = _int4_input_cut(tree, mesh.index(MODEL_AXIS), model_n)
                return {k: _placed(t, mesh.device) for k, t in local.items()}
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        if torch.is_tensor(tree):
            spec = _spec_for(path, tuple(tree.shape), data_n, model_n, mode)
            return _placed(_local(tree, spec, mesh), mesh.device)
        return tree

    return walk(params, "")


def shard_train_state(state: Any, mesh: ProcessMesh, param_mode: str = "replicate") -> Any:
    """This rank's local `train.step.TrainState`: the trainable leaves by
    the parameter rules, the optimizer state ZeRO-2, the step as it is."""
    data_n = mesh.shape[DATA_AXIS]

    def leaf(_, x):
        if not torch.is_tensor(x):
            return x
        return _placed(_local(x, _opt_spec(x, data_n), mesh), mesh.device)

    return type(state)(
        step=state.step,
        trainable=shard_params(state.trainable, mesh, mode=param_mode),
        opt_state=_map(leaf, state.opt_state),
    )
