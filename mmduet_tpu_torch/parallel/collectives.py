"""The collectives of the port's process meshes, over the two axes of a
`mesh.ProcessMesh`.

The JAX package gets these from XLA, which inserts them where shardings
meet; the port calls them itself. Serving takes the model axis in
Megatron's layout:

- `reduce_model`: the f32 partial products of the row-cut projections
  (attention out, MLP down, the towers' out and fc2, the projector's fc2)
  and of the vocabulary-cut embedding lookup, summed over the model
  group before the one rounding to the activation dtype;
- `gather_vocab`: whole vocabulary rows from each rank's slice of the
  LM head's logits, for the repetition penalty and the greedy choice.

Training adds the differentiable pair and the data axis:

- `copy_to_model` (Megatron's f): the identity forward, the sum over the
  model group backward, where a replicated tensor enters rank-local
  compute (the normed input of q/k/v/gate/up, of the towers' and the
  projector's fc1, and of a vocabulary-cut LM head);
- `reduce_model` of a tensor that needs a gradient (Megatron's g): the
  same sum forward, the identity backward;
- `max_model`: the largest of each rank's values (the vocabulary-parallel
  cross-entropy's row maximum);
- `sum_data`, `sum_model`: gradients and the loss's label counts summed
  over a group, in place;
- `gather_data`: a leaf cut over ``data`` (``--param_mode fsdp``) made
  whole, right before it is used (`data_gatherer`, `whole_over_data`).

Batched serving cuts its lanes over ``data`` (`mesh.lane_block`): nothing
inside a forward crosses that axis, and `gather_data` brings each data
rank's host-bound rows (a dispatch's score probabilities, a decode's
packed tokens) to every rank, bit for bit, once a dispatch.

Every collective is a SUM (a gather adds zero-filled full-width buffers,
exact in any dtype: x + 0 = x), so that the one collective works on CPU
and CUDA tensors under either backend (gloo takes ``all_reduce`` of CUDA
tensors), and every rank ends with the same bits: every host decision
(scores, triggers, tokens, the training step's skip) is taken from these
outputs, never from a rank's partial.

The host data path adds `share`: a dict of host arrays (and JSON values)
from one owner rank to the other ranks of an axis, bit for bit, in two
such sums (a small integer header, then the bytes), so that each sample is
decoded on one rank of a mesh (`train.loop.rank_real_batches`,
`eval.inference.mesh_items`).

The axes are bound once per process, by `mesh.make_mesh` when it builds a
process mesh: one process is one rank, and every forward it runs is on its
shard. Without a bound axis (size 1) every collective is the identity,
and `cut` says whether a dim holds a whole axis or this rank's part of it.
`parallel.sharding.shard_params` tags each local leaf with its spec
(``SPEC_ATTR``), which is how the model finds the leaves to gather.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SPEC_ATTR = "mesh_spec"  # a local leaf's spec: one axis name or None per dim
DATA, MODEL = "data", "model"


class _Axis:
    """One bound axis of this process: its group, this rank's index, its
    size."""

    def __init__(self, name: str):
        self.name, self.group, self.rank, self.size = name, None, 0, 1

    def bind(self, group: Any, rank: int, size: int) -> None:
        if self.size > 1 and (self.group, self.rank, self.size) != (group, rank, size):
            raise RuntimeError(f"collectives: this process's {self.name} axis is already bound")
        self.group, self.rank, self.size = group, rank, size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
        return x


_model, _data = _Axis(MODEL), _Axis(DATA)


def bind_model_axis(group: Any, rank: int, size: int) -> None:
    """Make ``group`` this process's model axis, with this rank at index
    ``rank`` of ``size``. A process binds one axis for its life."""
    _model.bind(group, rank, size)


def bind_data_axis(group: Any, rank: int, size: int) -> None:
    """The same for the data axis (the ranks holding the same model shard
    and other samples of the batch)."""
    _data.bind(group, rank, size)


def model_axis() -> Tuple[int, int]:
    """(this rank's index, the model axis's size); (0, 1) unbound."""
    return _model.rank, _model.size


def data_axis() -> Tuple[int, int]:
    """(this rank's index, the data axis's size); (0, 1) unbound."""
    return _data.rank, _data.size


def cut(local: int, full: int, what: str) -> bool:
    """Whether a dim that holds ``full`` values when whole holds this
    rank's ``full / size`` of them (True) or all (False); any other size
    raises."""
    size = _model.size
    if size == 1 or local == full:
        return False
    if local * size == full:
        return True
    raise ValueError(f"{what}: {local} of {full} values on a model axis of {size}")


class _ReduceModel(torch.autograd.Function):
    """g: the sum over the model axis forward, the identity backward (the
    sum is replicated, so its cotangent is the same on every rank)."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor) -> torch.Tensor:
        return _model.all_reduce(partial.to(torch.float32, copy=True).contiguous())

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward, the sum over the model axis backward (each
    rank's cotangent of a replicated input is its part of the whole)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _model.all_reduce(grad.clone(memory_format=torch.contiguous_format))


def reduce_model(partial: torch.Tensor) -> torch.Tensor:
    """The sum of ``partial`` over the model axis, in f32; the identity
    when no axis is bound. Callers reduce what `cut` says is a partial
    product. Under autograd (``partial`` needs a gradient) it is g, whose
    backward is the identity; otherwise it works in place when ``partial``
    is an f32 contiguous tensor."""
    if _model.size == 1:
        return partial
    if partial.requires_grad and torch.is_grad_enabled():
        return _ReduceModel.apply(partial)
    return _model.all_reduce(partial.float().contiguous())


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f: ``x`` as it is forward, its cotangent summed over the model axis
    backward. The identity when no axis is bound or no gradient flows."""
    if _model.size == 1 or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _CopyToModel.apply(x)


def gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The whole of ``x`` cut over ``axis`` ("data" or "model") on ``dim``,
    in its dtype, bit for bit; every rank of that axis calls it."""
    return _sum_gather(_data if axis == DATA else _model, x, dim, bits=True)


def sum_bits(axis: str, buf: torch.Tensor) -> torch.Tensor:
    """``buf`` (contiguous) summed over ``axis``, in place, where every
    element is zero on all ranks but one (a zero-filled gather): summed as
    integers, so every value, -0.0 and NaN payloads included, crosses bit
    for bit, in any float dtype (gloo need not sum bfloat16). A 2-byte
    dtype goes as int32 pairs, an odd last element widened to int32."""
    a = _data if axis == DATA else _model
    if a.size == 1 or not buf.is_floating_point():
        return buf if a.size == 1 else a.all_reduce(buf)
    flat = buf.view(-1)
    size = buf.element_size()
    if size != 2:
        a.all_reduce(flat.view(torch.int64 if size == 8 else torch.int32))
        return buf
    even = flat.numel() - flat.numel() % 2
    if even:
        a.all_reduce(flat[:even].view(torch.int32))
    if even < flat.numel():
        last = flat[even:].view(torch.int16).to(torch.int32)
        flat[even:].view(torch.int16).copy_(a.all_reduce(last))
    return buf


def _sum_gather(axis: _Axis, x: torch.Tensor, dim: int, dtype=None,
                bits: bool = False) -> torch.Tensor:
    """``x`` placed at this rank's block of a zero-filled buffer ``size``
    times as wide on ``dim``, summed over ``axis``: every rank's block
    (``bits``: summed as integers, `sum_bits`)."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    full = torch.zeros(shape, dtype=dtype or x.dtype, device=x.device)
    full.narrow(dim, axis.rank * n, n).copy_(x)
    return sum_bits(axis.name, full) if bits else axis.all_reduce(full)


def gather_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Whole (..., V) f32 rows from this rank's (..., V / size) slice of
    the vocabulary; the identity when the slice is the whole vocabulary."""
    if not cut(logits.shape[-1], vocab_size, "gather_vocab"):
        return logits
    return _sum_gather(_model, logits, logits.dim() - 1, torch.float32)


def max_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise largest of every model rank's ``x`` (no gradient):
    each rank's values gathered into a small buffer by a sum, then the
    local max."""
    if _model.size == 1:
        return x
    return _sum_gather(_model, x.detach()[None], 0).amax(dim=0)


def sum_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis, in place (no gradient); the
    identity when no axis is bound."""
    return x if _data.size == 1 else _data.all_reduce(x)


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis, in place (no gradient)."""
    return x if _model.size == 1 else _model.all_reduce(x)


def sum_flat(tensors: List[torch.Tensor], reduce: Callable[[torch.Tensor], torch.Tensor]
             ) -> List[torch.Tensor]:
    """The tensors summed by one collective ``reduce`` (`sum_data` or
    `sum_model`) of their f32 concatenation, each returned in f32 at its
    shape."""
    if not tensors:
        return []
    flat = reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
    return [part.view(t.shape) for part, t in
            zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of a tensor cut over the data axis on ``dim``, in its
    dtype, bit for bit (no gradient): a frozen base leaf under ``fsdp``, or
    a serving dispatch's rows of this rank's block of lanes."""
    return _sum_gather(_data, x.detach(), dim, bits=True)


def data_dim(x: Any) -> Optional[int]:
    """The dim of a local leaf that is cut over ``data`` (by its spec tag),
    or None."""
    spec = getattr(x, SPEC_ATTR, None) or ()
    return spec.index(DATA) if DATA in spec else None


def whole_over_data(leaf: Any) -> Any:
    """A local leaf (a tensor, or a quantized ``{"qw", "qs"}`` dict) with
    its parts cut over ``data`` gathered; untouched when nothing is cut."""
    if isinstance(leaf, dict):
        return {k: whole_over_data(t) for k, t in leaf.items()}
    dim = data_dim(leaf)
    return leaf if dim is None or _data.size == 1 else gather_data(leaf, dim)


def data_gatherer(layers: Dict[str, Any]) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """For a tree of layer-stacked leaves: ``whole(p)``, which gathers the
    leaves of one layer's view ``p`` (`quant.layer_view`) that are cut over
    ``data``. Call it right before the layer runs, inside a checkpointed
    layer, so the whole weights live for that layer only and are gathered
    again in its recompute."""
    cuts = {}
    for name, w in layers.items():
        parts = w.items() if isinstance(w, dict) else [(None, w)]
        for key, t in parts:
            dim = data_dim(t)
            if dim is not None and _data.size > 1:
                cuts[(name, key)] = dim - 1  # the view drops the layer dim
    if not cuts:
        return lambda p: p

    def whole(p: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(p)
        for (name, key), dim in cuts.items():
            if key is None:
                out[name] = gather_data(p[name], dim)
            else:
                out[name] = dict(out[name], **{key: gather_data(p[name][key], dim)})
        return out

    return whole


def carry_spec(new: torch.Tensor, old: Any) -> torch.Tensor:
    """``new`` with ``old``'s spec tag (a cast of a local leaf)."""
    spec = getattr(old, SPEC_ATTR, None)
    if spec is not None:
        setattr(new, SPEC_ATTR, spec)
    return new




# --- host values from one owner rank to the others of an axis --------------

# the array dtypes a share carries: numpy's by their ``dtype.str`` (native
# byte order; bool is one byte), torch's CPU tensors by name (bfloat16, which
# numpy lacks, included); a code is the entry's index + 1
_SHARE_DTYPES = tuple(("numpy", np.dtype(t).str) for t in (
    np.bool_, np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32, np.uint64, np.int64,
    np.float16, np.float32, np.float64)) + tuple(("torch", t) for t in (
        torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64, torch.float16,
        torch.bfloat16, torch.float32, torch.float64))
_SHARE_CODES = {k: c for c, k in enumerate(_SHARE_DTYPES, 1)}
_SHARE_ARRAYS, _SHARE_DIMS = 16, 6  # the header's room: arrays a share, dims an array
_SHARE_HEAD = 4  # status, arrays, the JSON blob's bytes, the payload's bytes
_SHARE_LEN = _SHARE_HEAD + _SHARE_ARRAYS * (2 + _SHARE_DIMS)  # + each array's code, ndim, shape
_PRESENT, _FAILED = 1, 2


class ShareError(RuntimeError):
    """The owner of a `share` failed to produce its value; raised on every
    other rank of the axis (the owner raises its own error)."""


def _pack(value: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the int64 header, the payload as uint8 padded to whole int32s) of a
    share's value: its arrays' bytes in order, then a JSON blob with every
    key in order and the values that are no array."""
    arrays = [(k, v) for k, v in value.items() if isinstance(v, np.ndarray) or torch.is_tensor(v)]
    if len(arrays) > _SHARE_ARRAYS:
        raise ValueError(f"share: {len(arrays)} arrays, room for {_SHARE_ARRAYS}")
    names = [k for k, _ in arrays]
    blob = json.dumps({"keys": list(value), "arrays": names,
                       "values": {k: v for k, v in value.items() if k not in names}}).encode()
    header = torch.zeros(_SHARE_LEN, dtype=torch.int64)
    parts = []
    for j, (k, a) in enumerate(arrays):
        tensor = torch.is_tensor(a)
        code = _SHARE_CODES.get(("torch", a.dtype) if tensor else ("numpy", a.dtype.str))
        if code is None or a.ndim > _SHARE_DIMS or (tensor and a.device.type != "cpu"):
            raise ValueError(f"share: {k} of dtype {a.dtype}, {a.ndim} dims"
                             + (f" on {a.device}" if tensor else ""))
        raw = (a.contiguous().reshape(-1).view(torch.uint8) if tensor
               else torch.from_numpy(np.ascontiguousarray(a).reshape(-1).view(np.uint8)))
        at = _SHARE_HEAD + j * (2 + _SHARE_DIMS)
        header[at:at + 2 + a.ndim] = torch.tensor([code, a.ndim, *a.shape])
        parts.append(raw)
    parts.append(torch.frombuffer(bytearray(blob), dtype=torch.uint8))
    n = sum(p.numel() for p in parts)
    payload = torch.zeros(-(-n // 4) * 4, dtype=torch.uint8)
    torch.cat(parts, out=payload[:n])
    header[:_SHARE_HEAD] = torch.tensor([_PRESENT, len(arrays), len(blob), n])
    return header, payload


def _unpack(header: torch.Tensor, raw: np.ndarray) -> Dict[str, Any]:
    """The value `_pack` made, from its header and payload bytes: fresh
    arrays of the sender's kinds, dtypes and shapes, and its JSON values."""
    head = header.tolist()
    off, arrays = 0, []
    for j in range(head[1]):
        at = _SHARE_HEAD + j * (2 + _SHARE_DIMS)
        code, ndim = head[at:at + 2]
        shape = tuple(head[at + 2:at + 2 + ndim])
        kind, dtype = _SHARE_DTYPES[code - 1]
        if kind == "numpy":
            dtype = np.dtype(dtype)
            nb = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            arrays.append(raw[off:off + nb].view(dtype).reshape(shape).copy())
        else:
            out = torch.empty(shape, dtype=dtype)
            nb = out.numel() * out.element_size()
            out.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(raw[off:off + nb]))
            arrays.append(out)
        off += nb
    meta = json.loads(raw[off:off + head[2]].tobytes().decode()) if head[2] else {}
    values = dict(meta["values"], **dict(zip(meta["arrays"], arrays)))
    return {k: values[k] for k in meta["keys"]}


def share(axis: str, owner: int, value: Any, device, stats: Optional[Dict[str, int]] = None
          ) -> Dict[str, Any]:
    """The value of the rank at index ``owner`` of ``axis`` ("data" or
    "model") on every rank of that axis, bit for bit; every rank of the
    axis calls it, and what the others pass is ignored.

    ``value`` is a dict with str keys. Its numpy arrays and CPU tensors
    (up to 16, of up to 6 dims; bool, the integer and the float dtypes,
    bfloat16 as a tensor) cross as their bytes, every other value as JSON.
    Two `all_reduce` sums of zero-filled buffers through ``device``: an
    int64 header (present or failed, each array's dtype code and shape,
    the byte counts), then the bytes packed into int32, which both backends
    sum on a card as `sum_bits` sums them (as integers, so every bit
    crosses; a bool array goes as its bytes). The receivers get fresh host
    arrays of the same
    kind, dtype and shape, and the JSON values as the owner's JSON reads
    back; the owner keeps its own value. The device buffers are freed
    before it returns.

    An exception as the owner's ``value`` (its producer failed), or a value
    that cannot be packed, is announced in the header: the owner raises its
    error and every other rank `ShareError`, so no rank waits on another.
    The identity on an axis of size 1. ``stats``: the bytes of the two
    buffers added to its "sent" (the owner) or "received" (the others)."""
    a = _data if axis == DATA else _model
    if a.size == 1:
        if isinstance(value, BaseException):
            raise value
        return value
    mine = a.rank == owner
    header, payload, error = torch.zeros(_SHARE_LEN, dtype=torch.int64), None, None
    if mine:
        try:
            if isinstance(value, BaseException):
                raise value
            header, payload = _pack(value)
        except Exception as e:  # announced, then raised here
            error = e
            header[0] = _FAILED
    head = a.all_reduce(header.to(device)).cpu()
    if int(head[0]) != _PRESENT:
        if mine:
            raise error
        raise ShareError(f"share over {axis}: the owner, index {owner}, failed to produce its "
                         "value")
    n = int(head[3])
    buf = (payload.to(device) if mine
           else torch.zeros(-(-n // 4) * 4, dtype=torch.uint8, device=device)).view(torch.int32)
    a.all_reduce(buf)
    if stats is not None:
        key = "sent" if mine else "received"
        stats[key] = stats.get(key, 0) + head.numel() * 8 + buf.numel() * 4
    if mine:
        del buf
        return value
    raw = buf.view(torch.uint8).cpu()
    del buf
    return _unpack(head, raw.numpy()[:n])
