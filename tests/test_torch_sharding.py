"""`mmduet_tpu_torch/parallel/sharding.py` against `mmduet_tpu/parallel/sharding.py`.

The rules: for dense, int8, int4 and LoRA trees, on (data, model) meshes
(1, 2), (2, 2), (4, 2) and (8, 1), in replicate and fsdp modes, every
leaf's spec equals the JAX package's (the JAX side on the 8 virtual CPU
devices of `tests/conftest.py`), and so do `kv_cache_sharding`,
`batch_shardings` and `opt_state_shardings`.

The local trees: `shard_params` gives each rank the block of each leaf
that the JAX package puts on that rank's device, bit for bit, with one
named exception, the int4 leaves cut on their input rows (o_proj,
down_proj): the JAX spec cuts their packed g/2 axis, the port repacks each
rank's contiguous input rows, and those local leaves dequantize to exactly
the parent's rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu import parallel as jpar
from mmduet_tpu.config import tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models import quant as jquant
from mmduet_tpu_torch.models import params_from_numpy
from mmduet_tpu_torch.models.quant import dequantize_weight, quantize_weight_int4
from mmduet_tpu_torch.parallel import (ProcessMesh, batch_shardings, initialize_distributed,
                                       kv_cache_sharding, make_mesh, opt_state_shardings,
                                       param_shardings, shard_params, shard_train_state,
                                       train_state_shardings)

CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
JP = jax_init(jax.random.PRNGKey(0), CFG)
MESHES = [(1, 2), (2, 2), (4, 2), (8, 1)]
MODES = ["replicate", "fsdp"]
INPUT_CUT = ("o_proj", "down_proj", "fc2")  # the named exception, for int4 leaves


def _lora_tree():
    lora = jlora.init_lora(jax.random.PRNGKey(1), CFG.text, rank=4)
    r = np.random.RandomState(2)
    return jax.tree.map(lambda x: jnp.asarray(r.randn(*x.shape) * 0.05, x.dtype), lora)


TREES = {
    "dense": JP,
    "int8": jquant.quantize_params(JP, bits=8),
    "int4": jquant.quantize_params(JP, bits=4),
    # adapters beside the base tree: the rules keep every "lora" leaf whole
    "lora": {"decoder": JP["decoder"], "lora": _lora_tree()},
}


def _flat(tree, prefix=""):
    """{path: leaf} with the rules' '/'-joined paths."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _port_tree(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _meshes(shape):
    n = shape[0] * shape[1]
    return (jpar.make_mesh(shape, devices=jax.devices()[:n]),
            make_mesh(shape, devices=["cpu"] * n))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", list(TREES))
def test_param_specs_equal_the_jax_rules(kind, mode, shape):
    jmesh, pmesh = _meshes(shape)
    want = _flat(jax.tree.map(lambda s: tuple(s.spec),
                              jpar.param_shardings(TREES[kind], jmesh, mode=mode)))
    got = _flat(param_shardings(_port_tree(TREES[kind]), pmesh, mode=mode))
    assert got.keys() == want.keys()
    assert {p: s for p, s in got.items() if s != want[p]} == {}
    if shape[1] > 1:  # the model axis cuts something of every kind
        assert any("model" in s for s in got.values())


def _bits(x) -> np.ndarray:
    """A leaf's values as numpy; bf16 as its raw 16 bits (numpy has no bf16)."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _is_input_cut_int4(path: str, flat: dict) -> bool:
    parts = path.split("/")
    return (len(parts) >= 2 and parts[-2] in INPUT_CUT
            and "/".join(parts[:-1] + ["qw4"]) in flat)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
# int4 leaves are serving weights, which fsdp (a training mode) does not cut
@pytest.mark.parametrize("kind,mode", [(k, m) for k in TREES for m in MODES
                                       if (k, m) != ("int4", "fsdp")])
def test_local_trees_are_the_jax_device_blocks(kind, mode, shape):
    """Rank (d, m)'s local leaf is the block the JAX package places on the
    device at (d, m) of its mesh; int4 input-cut leaves are the exception
    (their own test below)."""
    jmesh, _ = _meshes(shape)
    jsharded = _flat(jpar.shard_params(TREES[kind], jmesh, mode=mode))
    full = _port_tree(TREES[kind])
    flat_full = _flat(full)
    for d in range(shape[0]):
        for m in range(shape[1]):
            local = _flat(shard_params(full, ProcessMesh(shape, (d, m), torch.device("cpu")),
                                       mode=mode))
            dev = jmesh.devices[d, m]
            for path, arr in jsharded.items():
                if _is_input_cut_int4(path, flat_full) and shape[1] > 1:
                    continue
                block = next(s.data for s in arr.addressable_shards if s.device == dev)
                np.testing.assert_array_equal(_bits(local[path]), _bits(block),
                                              err_msg=f"{path} at {(d, m)}")
                assert local[path].is_contiguous()


@pytest.mark.parametrize("n", [2, 4])
def test_int4_input_cut_is_the_parents_rows_exactly(n):
    """The named exception: each rank's int4 o_proj / down_proj (tiny
    config: one group over the whole input, so a rank's rows are part of a
    group) dequantizes to exactly its contiguous rows of the parent."""
    full = _port_tree(TREES["int4"])
    layers = full["decoder"]["layers"]
    for name in ("o_proj", "down_proj"):
        parent = dequantize_weight(layers[name], torch.float32)  # (L, in, out)
        rows = parent.shape[1] // n
        assert layers[name]["qw4"].shape[1] == 1, "the case: one group, cut inside it"
        for m in range(n):
            local = shard_params(full, ProcessMesh((1, n), (0, m), torch.device("cpu")))
            leaf = local["decoder"]["layers"][name]
            assert leaf["qw4"].shape[-2] * 2 == rows  # a local group of the rank's rows
            assert torch.equal(leaf["qs"], layers[name]["qs"])  # the parent's scale
            torch.testing.assert_close(dequantize_weight(leaf, torch.float32),
                                       parent[:, m * rows:(m + 1) * rows], rtol=0, atol=0)


def test_int4_input_cut_keeps_whole_groups_where_they_divide():
    """The 7B case (o_proj 28 groups of 128 over 2 ranks): whole groups,
    qw4 and qs cut on G."""
    w = torch.randn(1, 1024, 96)
    leaf = {k: v[None] for k, v in quantize_weight_int4(w[0], 0).items()}  # G 8 of 128
    tree = {"layers": {"o_proj": leaf}}
    parent = dequantize_weight(leaf, torch.float32)
    for m in range(2):
        local = shard_params(tree, ProcessMesh((1, 2), (0, m), torch.device("cpu")))
        got = local["layers"]["o_proj"]
        assert tuple(got["qw4"].shape) == (1, 4, 64, 96)
        assert torch.equal(got["qs"], leaf["qs"][:, 4 * m:4 * (m + 1)])
        torch.testing.assert_close(dequantize_weight(got, torch.float32),
                                   parent[:, 512 * m:512 * (m + 1)], rtol=0, atol=0)


@pytest.mark.parametrize("shape", MESHES + [(2, 1), (1, 4)])
def test_kv_cache_batch_and_opt_state_specs_equal_the_jax_rules(shape):
    jmesh, pmesh = _meshes(shape)
    for kh in (1, 2, 4, 3):
        for lanes in (None, 1, 2, 4, 8, 6):
            want = tuple(jpar.sharding.kv_cache_sharding(jmesh, kh, lanes=lanes).spec)
            assert kv_cache_sharding(pmesh, kh, lanes=lanes) == want, (kh, lanes)
    r = np.random.RandomState(0)
    batch = {"input_ids": r.randint(0, 9, (2, 4, 16)), "frames": r.rand(2, 8, 3, 3, 3),
             "lengths": np.arange(4), "odd": r.rand(1, 3, 5)}
    want = jax.tree.map(lambda s: tuple(s.spec), jpar.batch_shardings(batch, jmesh))
    assert batch_shardings({k: torch.from_numpy(v) for k, v in batch.items()}, pmesh) == want
    opt = {"mu": {"a": np.zeros((6, 8, 4)), "b": np.zeros((3,))},
           "nu": {"a": np.zeros((6, 8, 4)), "b": np.zeros((3,))}, "count": np.zeros(())}
    want = jax.tree.map(lambda s: tuple(s.spec), jpar.opt_state_shardings(opt, jmesh))
    assert opt_state_shardings(jax.tree.map(torch.from_numpy, opt), pmesh) == want


def test_train_state_specs_and_local_state():
    """`train_state_shardings` / `shard_train_state` on the port's
    TrainState: the trainable leaves by the parameter rules, the optimizer
    state ZeRO-2 (cut over data on its largest divisible dim), the step
    whole."""
    from mmduet_tpu_torch.models import init_lora
    from mmduet_tpu_torch.train import init_train_state, make_optimizer
    from mmduet_tpu_torch.config import TrainArgs

    from mmduet_tpu_torch.models.io import config_from_dict

    params = _port_tree(JP)
    cfg = config_from_dict(dataclasses.asdict(CFG))
    lora = init_lora(torch.Generator().manual_seed(0), cfg.text, rank=4)
    tx, _ = make_optimizer(TrainArgs(), total_steps=4)
    state = init_train_state(params, lora, tx)
    mesh = ProcessMesh((2, 1), (1, 0), torch.device("cpu"))
    specs = train_state_shardings(state, mesh)
    assert specs.step == ()
    assert specs.trainable == param_shardings(state.trainable, mesh)
    assert specs.opt_state == opt_state_shardings(state.opt_state, mesh)
    local = shard_train_state(state, mesh)
    flat_opt, flat_local = _flat(dict(o=state.opt_state)), _flat(dict(o=local.opt_state))
    flat_spec = _flat(dict(o=specs.opt_state))
    for path, x in flat_opt.items():
        if not torch.is_tensor(x):
            continue
        spec = flat_spec[path]
        if "data" in spec:
            dim = spec.index("data")
            half = x.shape[dim] // 2
            torch.testing.assert_close(flat_local[path], x.narrow(dim, half, half),
                                       rtol=0, atol=0)
        else:
            torch.testing.assert_close(flat_local[path], x, rtol=0, atol=0)


def test_process_meshes_need_their_group_and_a_named_device(monkeypatch):
    """Without an initialized group, ``device=`` (a rank's device) raises;
    `initialize_distributed` names its backend and needs the variables
    ``torch.distributed.run`` sets; a mesh over several devices in one
    process still raises."""
    with pytest.raises(ValueError, match="initialized"):
        make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("mpi")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        initialize_distributed("gloo")
    with pytest.raises(NotImplementedError, match="several devices"):
        make_mesh((1, 2), devices=["cpu", "meta"])
    mesh = ProcessMesh((2, 3), (1, 2), torch.device("cpu"))
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert (mesh.index("data"), mesh.index("model")) == (1, 2)


def test_quantizing_a_shard_equals_cutting_the_quantized_tree_at_whole_groups():
    """Where every rank's input rows are whole groups of 128 (hidden 512:
    o_proj 4 groups, down_proj 8, over 2 ranks; the 7B widths too), a
    rank may quantize its bf16 shard itself: the int4 leaves are the ones
    `shard_params` cuts from the quantized whole tree, bit for bit."""
    from mmduet_tpu_torch.models import init_mmduet_params
    from mmduet_tpu_torch.models.io import config_from_dict
    from mmduet_tpu_torch.models.quant import quantize_params

    cfg = config_from_dict(dataclasses.asdict(tiny_config(hidden_size=512)))
    full = init_mmduet_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"),
                              torch.bfloat16)
    whole_q = quantize_params(full, bits=4)
    for m in range(2):
        mesh = ProcessMesh((1, 2), (0, m), torch.device("cpu"))
        got = _flat(quantize_params(shard_params(full, mesh), bits=4))
        want = _flat(shard_params(whole_q, mesh))
        assert got.keys() == want.keys()
        assert [p for p in got if not torch.equal(got[p], want[p])] == []


def test_load_checkpoint_with_a_mesh_gives_the_ranks_local_tree(tmp_path):
    """`load_checkpoint(dir, mesh=)` maps the file and keeps only the rank's
    shard (int4 leaves included) on the mesh's device; the adapter whole."""
    from mmduet_tpu_torch.models.io import config_from_dict, load_checkpoint, save_checkpoint

    cfg = config_from_dict(dataclasses.asdict(CFG))
    params = _port_tree(TREES["int4"])
    lora = _port_tree(_lora_tree())
    save_checkpoint(str(tmp_path), cfg, params, lora)
    mesh = ProcessMesh((1, 2), (0, 1), torch.device("cpu"))
    got_cfg, got, got_lora = load_checkpoint(str(tmp_path), mesh=mesh)
    assert got_cfg == cfg
    want = _flat(shard_params(params, mesh))
    got = _flat(got)
    assert got.keys() == want.keys()
    assert [p for p in got if not torch.equal(got[p], want[p])] == []
    assert all(torch.equal(a, b) for a, b in zip(_flat(got_lora).values(),
                                                  _flat(lora).values()))
