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
on their local trees (`shard_params`, which tags each local leaf with its
spec, ``collectives.SPEC_ATTR``) and call `parallel.collectives`. Training
(`shard_train_state`) keeps the trainable leaves whole over ``data`` and
cuts each optimizer moment over ``data`` inside the rank's trainable
block (`moment_spec`), where the JAX package cuts the whole moment: it
keeps global arrays, so its cut is a layout, and the port's is the one
whose blocks line up with the rank's trainable leaves under tensor
parallelism. `gather_params` / `gather_train_state` are the inverses,
for checkpoints.
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
from .collectives import SPEC_ATTR, data_axis, gather, model_axis, sum_bits
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


def local_cache_dims(mesh, num_kv_heads: int, lanes: int) -> Tuple[int, int]:
    """A rank's (lanes, kv heads) of the (L, lanes, kh, S, hd) serving
    cache of a process mesh: each dim that `kv_cache_sharding` cuts,
    divided by its axis, so the local shape follows the spec."""
    spec = kv_cache_sharding(mesh, num_kv_heads, lanes=lanes) + (None,) * 3
    return tuple(n // (mesh.shape[axis] if axis else 1)
                 for n, axis in zip((lanes, num_kv_heads), spec[1:3]))


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


def _tagged(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``x`` with its spec as an attribute (Megatron tags its parameters
    the same way): the model gathers the leaves it finds cut over
    ``data`` (`collectives.data_gatherer`), `gather_params` every cut."""
    setattr(x, SPEC_ATTR, spec)
    return x


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
                # no spec tag: its rows are a repacking, not a block of the leaf
                return {k: _placed(t, mesh.device) for k, t in local.items()}
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        if torch.is_tensor(tree):
            spec = _spec_for(path, tuple(tree.shape), data_n, model_n, mode)
            return _tagged(_placed(_local(tree, spec, mesh), mesh.device), spec)
        return tree

    return walk(params, "")


def moment_spec(shape, data_n: int) -> Spec:
    """The ZeRO-2 cut of an optimizer moment over ``data``, taken on the
    rank's trainable block of ``shape`` (its largest divisible dim); ()
    where nothing divides or the data axis is 1."""
    return _zero_spec(shape, data_n) if data_n > 1 and len(shape) >= 1 else ()


def data_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's `moment_spec` block of ``x`` (a trainable leaf, its
    gradient or a moment, at the trainable block's shape): a view."""
    return _local(x, moment_spec(tuple(x.shape), mesh.shape[DATA_AXIS]), mesh)


def shard_train_state(state: Any, mesh: ProcessMesh, param_mode: str = "replicate") -> Any:
    """This rank's local `train.step.TrainState`: the trainable leaves by
    the parameter rules (tensor parallelism; whole over ``data``, as the
    JAX CLI keeps them), each moment the same block cut again over
    ``data`` (`moment_spec`: ZeRO-2), the count and the step as they are.

    The JAX package cuts each whole moment on its own largest dim, which
    on a (2, 2) mesh would give rank (d, m) moment columns of half d beside
    trainable columns of half m; the port cuts inside the trainable block,
    so each rank's moments pair with its trainable elements (the JAX
    arrays are global, so this is a local layout, not another result)."""
    if param_mode != "replicate" and mesh.shape[DATA_AXIS] > 1:
        raise ValueError("shard_train_state: the trainable leaves stay whole over data "
                         "(ZeRO-2); --param_mode fsdp cuts the frozen base (shard_params)")
    trainable = shard_params(state.trainable, mesh)

    def moments(tree):
        return _map(lambda _, x: _placed(data_block(x, mesh), mesh.device),
                    shard_params(tree, mesh))

    opt = {k: (moments(v) if k in ("mu", "nu") else v) for k, v in state.opt_state.items()}
    return type(state)(step=state.step, trainable=trainable, opt_state=opt)


# ---------------------------------------------------------------------------
# Whole trees from the ranks' blocks (the inverses, for checkpoints)
# ---------------------------------------------------------------------------


def _whole(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole of a local leaf under ``spec`` (a zero-filled sum over each
    axis it names, in dim order)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = gather(x, dim, axis)
    return x


def gather_params(params: Any, to=None, keep: bool = True) -> Any:
    """The whole tree of a rank's local ``params`` (`shard_params`), leaf by
    leaf: each leaf gathered over the axes its spec tag names, then moved
    to ``to`` (a device; None keeps it where it is). Every rank of the
    mesh calls it (each gather is a collective); a rank that passes
    ``keep=False`` drops each leaf after its gather (None in the tree). An
    int4 leaf cut on its input rows (serving's repacking) raises."""

    def leaf(path, x):
        if not torch.is_tensor(x):
            return x
        spec = getattr(x, SPEC_ATTR, None)
        if spec is None:
            if model_axis()[1] > 1 or data_axis()[1] > 1:
                raise ValueError(f"{path}: no spec tag (an int4 leaf cut on its input rows, "
                                 "or a tree that shard_params did not make)")
            spec = ()
        out = _whole(x, spec)
        if not keep:
            return None
        return out if to is None else out.to(to)

    return _map(leaf, params)


def _projector_whole(path: str, shape: Tuple[int, ...], width: int) -> Tuple[int, ...]:
    """A trainable leaf's whole shape: the projector's fc1 / fc1_bias
    (outputs) and fc2 (inputs) hold ``width`` values on their cut dim."""
    name = path.split("/")[-1]
    if not path.startswith("projector/") or name == "fc2_bias":
        return shape
    dim = 0 if name == "fc2" else len(shape) - 1
    return tuple(width if i == dim else n for i, n in enumerate(shape))


def trainable_specs(trainable: Any, mesh) -> Any:
    """The specs of a rank's local trainable tree (`shard_train_state`):
    the parameter rules on the whole tree's shapes. Only the projector is
    cut (over ``model``, on the text width, which ``fc2_bias`` holds
    whole); the adapters and the score heads stay whole."""
    width = trainable["projector"]["fc2_bias"].shape[-1]
    data_n, model_n = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    return _map(lambda path, x: _spec_for(path, _projector_whole(path, _shape(x), width),
                                          data_n, model_n, "replicate"), trainable)


def lora_cut_over_model(lora: Any, mesh) -> Dict[str, bool]:
    """Per adapted projection, whether its base weight is cut over
    ``model`` (the whole adapter's shapes give the weight's: (L, in, out)).
    A rank's gradient of such an adapter is its part of the whole: summed
    over ``model`` after accumulation (`train.step`)."""
    model_n = mesh.shape[MODEL_AXIS]
    return {name: MODEL_AXIS in _spec_for(
        f"decoder/layers/{name}", (ab["a"].shape[0], ab["a"].shape[1], ab["b"].shape[-1]),
        1, model_n, "replicate") for name, ab in lora.items()}


def gather_data_blocks(blocks: Any, like: Any, mesh) -> Any:
    """Whole-over-``data`` leaves of the shapes of ``like`` from this
    rank's `data_block` of each: one zero-filled sum over ``data`` per
    dtype. Blocks that are not cut (``moment_spec`` ()) are taken as they
    are."""
    data_n = mesh.shape[DATA_AXIS]
    pairs = list(zip(_leaves(blocks), _leaves(like)))
    out: Dict[int, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for i, (b, ref) in enumerate(pairs):
        if moment_spec(tuple(ref.shape), data_n):
            by_dtype.setdefault(b.dtype, []).append(i)
        else:
            out[i] = b
    for dtype, idx in by_dtype.items():
        fulls = [torch.zeros(pairs[i][1].shape, dtype=dtype, device=pairs[i][0].device)
                 for i in idx]
        for i, full in zip(idx, fulls):
            data_block(full, mesh).copy_(pairs[i][0])
        flat = sum_bits(DATA_AXIS, torch.cat([f.reshape(-1) for f in fulls]))
        for i, part in zip(idx, torch.split(flat, [f.numel() for f in fulls])):
            out[i] = part.view(pairs[i][1].shape)
    it = iter(out[i] for i in range(len(pairs)))
    return _map(lambda _, x: next(it) if torch.is_tensor(x) else x, like)


def gather_trainable(tree: Any, mesh, to=None) -> Any:
    """The whole of a tree of a rank's trainable-shaped leaves (the
    trainable leaves, their gradients, moments gathered over ``data``):
    each leaf gathered over ``model`` by `trainable_specs`, then moved to
    ``to``. Every rank calls it."""
    flat = iter(_leaves(trainable_specs(tree, mesh)))

    def leaf(_, x):
        out = _whole(x, next(flat))
        return out if to is None else out.to(to)

    return _map(leaf, tree)


def gather_train_state(state: Any, mesh, to=None) -> Any:
    """The whole `train.step.TrainState` of a rank's local one
    (`shard_train_state`): the moments gathered over ``data`` into the
    trainable block, then every trainable-shaped leaf over ``model``;
    moved to ``to`` (None keeps the device). Every rank calls it."""
    opt = {k: (gather_trainable(gather_data_blocks(v, state.trainable, mesh), mesh, to)
               if k in ("mu", "nu") else v) for k, v in state.opt_state.items()}
    return type(state)(step=state.step, trainable=gather_trainable(state.trainable, mesh, to),
                       opt_state=opt)


def _leaves(tree: Any):
    """The tensors of nested dicts, in key order (`_map`'s order)."""
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)
