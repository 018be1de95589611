"""The port's training mesh (`train.step.make_train_step(mesh=)`,
`parallel.sharding.shard_train_state`, the collectives of
`parallel.collectives`, `train.checkpoint` and the CLI under
``torch.distributed.run``) against the JAX package on `tiny_config()`.

Gloo ranks on the CPU, one launch per layout (`tests/torch_train_mesh_worker.py`):
(2, 1) replicate (ZeRO-2), (1, 2) tensor parallelism, (2, 2) fsdp + TP +
ZeRO-2. Each launch takes 3 steps of A = 2 micro-batches of B = 2 samples
whose label counts and frame counts differ (so the global token mean and
each rank's frames are exercised), each rank staging only its share of
each batch (`train.step.rank_batch`, cut on the host, as the loop and
`chip_smoke.py` stage theirs); each test compares one case against the
JAX single-device `make_train_step` and the JAX mesh step of the same shape
on the virtual CPU devices. f32 on both sides, so differences are
summation order: losses to 1e-4 relative (as
`tests/test_train.py::TestMultiDevice::test_sharded_matches_single_device`),
the other metrics, the averaged gradients and the trainable leaves to 1e-5
absolute, the Adam moments as `tests/test_torch_train.py` holds them
(1e-7 absolute, 1e-4 relative). Then the checkpoint of the (2, 2) ranks
resumed in one process and on (2, 1); each launch's ranks reading
`torch_train_mesh_worker.LoaderData` alone (`loop.rank_real_batches`),
bit for bit `rank_batch` of the steps `real_batches` collates whole here,
each sample fetched by one rank of the mesh, also where the last rank
alone fails to read an item; `collectives.share` of every dtype over each
axis; and the CLI under ``torch.distributed.run`` (two more launches)
against the one-process CLI."""

import dataclasses
import json
import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_mesh_worker as worker

from mmduet_tpu import parallel as jpar
from mmduet_tpu.config import TrainArgs, tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models.lora import lora_scale
from mmduet_tpu.train import init_train_state as j_init_state
from mmduet_tpu.train import make_optimizer as j_make_optimizer
from mmduet_tpu.train import make_train_step as j_make_step
from mmduet_tpu.train import step as jstep
from mmduet_tpu_torch.models import io as tio
from mmduet_tpu_torch.models import params_from_numpy, train_state_from_numpy
from mmduet_tpu_torch.parallel import ProcessMesh, shard_train_state
from mmduet_tpu_torch.parallel.sharding import data_block, opt_state_shardings, shard_params
from mmduet_tpu_torch.train import checkpoint as tckpt
from mmduet_tpu_torch.train import loop as tloop
from mmduet_tpu_torch.train import optimizer as topt
from mmduet_tpu_torch.train import step as tstep

REPO = Path(__file__).resolve().parents[1]
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
JP = jax_init(jax.random.PRNGKey(0), CFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
ARGS = TrainArgs(learning_rate=1e-2, lora_r=4, lora_alpha=8, warmup_ratio=0.3)
TOTAL = 10
LAYOUTS = {"2x1_replicate": ((2, 1), "replicate"), "1x2_tp": ((1, 2), "replicate"),
           "2x2_fsdp_tp": ((2, 2), "fsdp")}
LAUNCH_TIMEOUT = 240
METRICS = ("loss", "lm_loss", "video_loss", "grad_norm", "lr", "skipped_nonfinite")


def _lora():
    tree = jlora.init_lora(jax.random.PRNGKey(13), CFG.text, 4)
    r = np.random.RandomState(13)  # b = 0 at init: give the adapter an effect
    return {n: {"a": ab["a"], "b": jnp.asarray(r.randn(*ab["b"].shape) * 0.05, jnp.float32)}
            for n, ab in tree.items()}


def _batch(seed, A=2, B=2, T=16):
    """Sample 0 holds two frames and 6 labels, sample 1 one frame, 2 labels
    and 3 pad tokens; 4 frame slots (one padding)."""
    r = np.random.RandomState(seed)
    vid, ft = CFG.v_placeholder_id, CFG.frame_num_tokens
    ids = r.randint(0, 200, (A, B, T))
    ids[:, 0, 2:2 + 2 * ft] = vid
    ids[:, 1, 2:2 + ft] = vid
    mask = np.ones((A, B, T), bool)
    mask[:, 1, T - 3:] = False
    labels = np.full((A, B, T), -100)
    labels[:, 0, 10:14] = ids[:, 0, 10:14]
    labels[:, 1, 7:9] = ids[:, 1, 7:9]
    inf = np.full((A, B, T), -100)
    inf[:, 0, 1 + ft] = 1
    inf[:, 0, 1 + 2 * ft] = r.randint(0, 2)
    inf[:, 1, 1 + ft] = r.randint(0, 2)
    rel = np.full((A, B, T), -100)
    rel[:, 0, 1 + 2 * ft] = 1
    return {"input_ids": ids.astype(np.int32), "attn_mask": mask,
            "labels": labels.astype(np.int32), "informative_labels": inf.astype(np.int32),
            "relevance_labels": rel.astype(np.int32),
            "vision_feats": r.randn(A, 4, CFG.vision.num_patches,
                                    CFG.vision.hidden_size).astype(np.float32)}


BATCHES = [_batch(20 + i) for i in range(3)]
NAN_BATCH = dict(_batch(30))
NAN_BATCH["vision_feats"] = NAN_BATCH["vision_feats"].copy()
NAN_BATCH["vision_feats"][:, 0] = np.nan  # sample 0's first frame: data rank 0's


def _jax_state():
    jtx, jsched = j_make_optimizer(ARGS, TOTAL)
    return jtx, jsched, j_init_state(JP, _lora(), jtx)


def _close(got, want, atol=1e-5, rtol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------


def _jax_run(mesh=None, mode="replicate"):
    """Metrics and trainable leaves after each of the 3 steps, and the Adam
    state after the first, of the JAX step (on ``mesh`` if given)."""
    jtx, jsched, state = _jax_state()
    params = JP
    step = j_make_step(CFG, ARGS, jtx, jsched, mesh=mesh)
    if mesh is not None:
        params = jpar.shard_params(JP, mesh, mode=mode)
        state = jpar.shard_train_state(state, mesh)
    out = {"metrics": [], "trainable": []}
    for i, batch in enumerate(BATCHES):
        batch = jax.tree.map(jnp.asarray, batch)
        if mesh is not None:
            batch = jax.tree.map(jax.device_put, batch, jpar.batch_shardings(batch, mesh))
        state, metrics = step(state, params, batch)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["trainable"].append(_flat(jax.tree.map(np.asarray, state.trainable)))
        if i == 0:
            adam = state.opt_state[1][0]
            out["adam"] = {"count": int(adam.count),
                           "mu": _flat(jax.tree.map(np.asarray, adam.mu)),
                           "nu": _flat(jax.tree.map(np.asarray, adam.nu))}
    return out


@pytest.fixture(scope="module")
def jax_single():
    return _jax_run()


@pytest.fixture(scope="module")
def jax_mesh():
    out = {}
    for name, (shape, mode) in LAYOUTS.items():
        devices = jax.devices()[:shape[0] * shape[1]]
        out[name] = _jax_run(jpar.make_mesh(shape, devices=devices), mode)
    return out


@pytest.fixture(scope="module")
def jax_grads():
    """The first batch's gradients, averaged over its micro-batches."""
    _, _, state = _jax_state()
    fn = jax.grad(jstep._loss_fn, has_aux=True)
    scale = lora_scale(ARGS.lora_r, ARGS.lora_alpha)
    grads = [fn(state.trainable, JP, CFG, jax.tree.map(lambda x: jnp.asarray(x[a]), BATCHES[0]),
                scale, ARGS.gradient_checkpointing, False)[0] for a in range(2)]
    return _flat(jax.tree.map(lambda *g: np.asarray(sum(g) / len(g)), *grads))


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n: int, *argv) -> subprocess.Popen:
    """``n`` ranks of ``argv`` under torch.distributed.run, on 127.0.0.1."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), *argv]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


def _worker(root: Path, name: str, **case) -> subprocess.Popen:
    shape, mode = LAYOUTS[name]
    d = root / name
    d.mkdir()
    (d / "case.json").write_text(json.dumps(dict(
        case, shape=list(shape), mode=mode, total_steps=TOTAL,
        args=dict(learning_rate=ARGS.learning_rate, lora_r=ARGS.lora_r,
                  lora_alpha=ARGS.lora_alpha, warmup_ratio=ARGS.warmup_ratio))))
    os.link(root / "inputs.pt", d / "inputs.pt")
    return _start(shape[0] * shape[1], "tests/torch_train_mesh_worker.py", str(d))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the three launches: (1, 2) and (2, 2) at
    once, then (2, 1), which also resumes the (2, 2) ranks' checkpoint of
    step 2 and takes a step with a NaN in data rank 0's features."""
    root = tmp_path_factory.mktemp("mesh")
    _, _, state = _jax_state()
    torch.save({"params": TP, "state": train_state_from_numpy(
                    jax.tree.map(np.asarray, state), "cpu")._asdict(),
                "batches": [_torch(b) for b in BATCHES], "nan_batch": _torch(NAN_BATCH)},
               root / "inputs.pt")
    first = [_worker(root, "1x2_tp"), _worker(root, "2x2_fsdp_tp", save_at=2)]
    for proc in first:
        _finish(proc)
    ckpt = root / "2x2_fsdp_tp" / "ckpt" / "checkpoint-2"
    _finish(_worker(root, "2x1_replicate", nan=True, resume=str(ckpt)))
    out = {}
    for name, (shape, _) in LAYOUTS.items():
        out[name] = [torch.load(root / name / f"rank{r}.pt", weights_only=True)
                     for r in range(shape[0] * shape[1])]
    out["ckpt"] = ckpt
    return out


@pytest.mark.parametrize("ref", ["single_device", "mesh"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_metrics_match_the_jax_steps(ranks, jax_single, jax_mesh, name, ref):
    want = jax_single if ref == "single_device" else jax_mesh[name]
    for i, (got, w) in enumerate(zip(ranks[name][0]["metrics"], want["metrics"])):
        assert set(got) == set(w)
        _close(got["loss"], w["loss"], atol=0, rtol=1e-4, msg=f"step {i + 1} loss")
        for k in ("lm_loss", "video_loss", "grad_norm"):
            _close(got[k], w[k], msg=f"step {i + 1} {k}")
        _close(got["lr"], w["lr"], atol=0, rtol=1e-6)
        assert got["skipped_nonfinite"] == w["skipped_nonfinite"] == 0.0


@pytest.mark.parametrize("ref", ["single_device", "mesh"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_trainable_leaves_match_the_jax_steps(ranks, jax_single, jax_mesh, name, ref):
    want = jax_single if ref == "single_device" else jax_mesh[name]
    for i, (got, w) in enumerate(zip(ranks[name][0]["trainable"], want["trainable"])):
        got = _flat(got)
        assert set(got) == set(w)
        for key in w:
            _close(got[key], w[key], msg=f"step {i + 1} {key}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_rank_reports_the_same_bits(ranks, name):
    first = ranks[name][0]
    for other in ranks[name][1:]:
        assert other["metrics"] == first["metrics"]
        for got, want in zip(other["trainable"], first["trainable"]):
            for key, leaf in _flat(want).items():
                assert torch.equal(_flat(got)[key], leaf), key


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_first_averaged_gradients_match_jax_leaf_by_leaf(ranks, jax_grads, name):
    """Which leaves are summed over ``model`` (the adapters of cut
    projections) and which are not (the score heads, ``fc2_bias``, the
    projector's own blocks): a leaf summed once too often or not at all is
    off by a factor."""
    got = _flat(ranks[name][0]["grads"])
    assert set(got) == set(jax_grads)
    for key, want in jax_grads.items():
        _close(got[key], want, rtol=1e-4, msg=key)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moment_blocks_are_the_data_cut_of_the_trainable_blocks(ranks, jax_single, name):
    """Every rank's moment blocks hold 1 / data of its trainable block's
    elements (`moment_spec`), and gathered after the first step they are
    the JAX optimizer state."""
    (data_n, _), _ = LAYOUTS[name]
    for r in ranks[name]:
        for t, m in zip(r["trainable_shapes"], r["moment_shapes"]):
            assert np.prod(m) * data_n == np.prod(t) or (m == t and np.prod(t) % data_n), (t, m)
    opt = ranks[name][0]["opt_state"]
    assert opt["count"] == jax_single["adam"]["count"] == 1
    for k in ("mu", "nu"):
        for key, want in jax_single["adam"][k].items():
            _close(_flat(opt[k])[key], want, atol=1e-7, rtol=1e-4, msg=f"{k} {key}")


def test_shard_train_state_cuts_moments_inside_the_trainable_block():
    """The deliberate difference from the JAX layout, on a (2, 2) mesh: the
    JAX rule cuts each whole moment on its largest dim (the projector's fc2
    on its inputs, the dim ``model`` already cuts), the port cuts the
    rank's trainable block again, so rank (d, m)'s moment elements are its
    trainable elements."""
    jtx, _, jstate = _jax_state()
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    state = state._replace(opt_state=dict(state.opt_state, mu=state.trainable))
    jspec = opt_state_shardings(state.opt_state, ProcessMesh((2, 2), (0, 0), "cpu"))
    assert jspec["mu"]["projector"]["fc2"] == ("data", None)
    for d in range(2):
        for m in range(2):
            mesh = ProcessMesh((2, 2), (d, m), torch.device("cpu"))
            local = shard_train_state(state, mesh)
            for key, t in _flat(local.trainable).items():
                assert torch.equal(_flat(local.opt_state["mu"])[key], data_block(t, mesh)), key
    fc2 = shard_params(state.trainable, ProcessMesh((2, 2), (1, 0), "cpu"))["projector"]["fc2"]
    assert tuple(fc2.shape) == (CFG.text.hidden_size // 2, CFG.text.hidden_size)


def test_nonfinite_features_on_one_data_rank_skip_every_rank(ranks):
    for r in ranks["2x1_replicate"]:
        nan = r["nan"]
        assert nan["metrics"]["skipped_nonfinite"] == 1.0
        assert not np.isfinite(nan["metrics"]["loss"])
        assert nan["kept"] and nan["count"] == nan["count_before"] == 3
        assert nan["step"] == 4


def test_checkpoint_of_2x2_resumes_in_one_process(ranks, jax_single):
    """The (2, 2) ranks' whole state at step 2, restored on one process,
    takes step 3 to the uninterrupted runs' (the (2, 2) ranks' and JAX's)."""
    ttx, tsched = topt.make_optimizer(ARGS, TOTAL)
    template = train_state_from_numpy(jax.tree.map(np.asarray, _jax_state()[2]), "cpu")
    state = tckpt.restore_train_state(str(ranks["ckpt"]), template)
    assert state.step == 2 and state.opt_state["count"] == 2
    for key, leaf in _flat(ranks["2x2_fsdp_tp"][0]["trainable"][1]).items():
        assert torch.equal(_flat(state.trainable)[key], leaf), key
    state, metrics = tstep.make_train_step(CFG, ARGS, ttx, tsched)(state, TP, _torch(BATCHES[2]))
    for want in (ranks["2x2_fsdp_tp"][0]["metrics"][2], jax_single["metrics"][2]):
        for k in METRICS:
            _close(metrics[k], want[k], rtol=1e-4)
    for key, want in jax_single["trainable"][2].items():
        _close(_flat(state.trainable)[key], want, msg=key)


def test_checkpoint_of_2x2_resumes_on_2x1(ranks, jax_single):
    for r in ranks["2x1_replicate"]:
        resumed = r["resumed"]
        assert resumed["step"] == 3
        for k in METRICS:
            _close(resumed["metrics"][k], jax_single["metrics"][2][k], rtol=1e-4)
        for key, want in jax_single["trainable"][2].items():
            _close(_flat(resumed["trainable"])[key], want, msg=key)


def test_ranks_load_nothing_of_jax(ranks):
    assert [r["modules"] for name in LAYOUTS for r in ranks[name]] == \
        [[] for name in LAYOUTS for _ in ranks[name]]


# ---------------------------------------------------------------------------
# the rank's share of a batch, cut on the host (`rank_batch`)
# ---------------------------------------------------------------------------


def _share(batch, shape, d):
    """Data rank ``d``'s rows and, a micro-batch at a time, its frames,
    from the batch's own placeholder counts (one zero slot where it holds
    none); the whole batch where data is 1."""
    if shape[0] == 1:
        return batch
    ids = batch["input_ids"]
    per = ids.shape[1] // shape[0]
    counts = (ids == CFG.v_placeholder_id).sum(-1) // CFG.frame_num_tokens
    out = {k: v[:, d * per:(d + 1) * per] for k, v in batch.items() if k != "vision_feats"}
    frames = []
    for a, row in enumerate(counts.tolist()):
        start, n = sum(row[:d * per]), sum(row[d * per:(d + 1) * per])
        frames.append(batch["vision_feats"][a, start:start + n] if n
                      else np.zeros_like(batch["vision_feats"][a, :1]))
    return dict(out, vision_feats=frames)


def _ragged_batch(A=3, B=4, T=24, slots=6):
    """Frame counts that differ over A and over the samples; data rank 0 of
    two holds no frame in micro-batch 1."""
    counts = [[2, 1, 0, 3], [0, 0, 1, 1], [1, 2, 2, 0]]
    r = np.random.RandomState(5)
    ids = r.randint(0, 200, (A, B, T)).astype(np.int32)
    for a in range(A):
        for b in range(B):
            ids[a, b, 1:1 + counts[a][b] * CFG.frame_num_tokens] = CFG.v_placeholder_id
    batch = {"input_ids": ids, "attn_mask": r.rand(A, B, T) > 0.2,
             "labels": r.randint(0, 200, (A, B, T)).astype(np.int32),
             "vision_feats": r.randn(A, slots, CFG.vision.num_patches, 3).astype(np.float32)}
    return batch, counts


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_rank_batch_stages_the_rank_share(shape):
    """Each rank's rows and frame slots, one array a micro-batch where the
    counts are ragged; a rank whose samples hold no frame keeps one zero
    slot; the model ranks of a data rank stage the same share; joined in
    data-rank order the shares give back the global rows and every used
    frame slot; a share is not cut again."""
    batch, counts = _ragged_batch()
    shares = {}
    for d in range(shape[0]):
        for m in range(shape[1]):
            got = tstep.rank_batch(batch, CFG, ProcessMesh(shape, (d, m), torch.device("cpu")))
            want = _share(batch, shape, d)
            assert set(got) == set(want)
            for k, v in want.items():
                if shape[0] == 1:
                    assert got[k] is v, k
                elif k == "vision_feats":
                    assert isinstance(got[k], tuple) and len(got[k]) == len(v)
                    for g, w in zip(got[k], v):
                        np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_array_equal(got[k], v)
            shares[d, m] = got
    if shape[0] == 1:
        return
    assert [len(f) for f in shares[0, 0]["vision_feats"]] == [3, 1, 3]  # micro 1: unused slot
    assert [len(f) for f in shares[1, 0]["vision_feats"]] == [3, 2, 2]
    for k in ("input_ids", "attn_mask", "labels"):
        np.testing.assert_array_equal(np.concatenate([shares[d, 0][k] for d in range(2)], 1),
                                      batch[k])
    for a, row in enumerate(counts):
        used = [shares[d, 0]["vision_feats"][a] for d in range(2) if sum(row[2 * d:2 * d + 2])]
        np.testing.assert_array_equal(np.concatenate(used), batch["vision_feats"][a, :sum(row)])
    with pytest.raises(ValueError, match="3 samples over a data axis of 2"):
        tstep.rank_batch({k: v[:, :3] for k, v in batch.items()}, CFG,
                         ProcessMesh(shape, (0, 0), torch.device("cpu")))
    with pytest.raises(ValueError, match="already a rank's share"):
        tstep.rank_batch(shares[0, 0], CFG, ProcessMesh(shape, (0, 0), torch.device("cpu")))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_rank_staged_its_own_share(ranks, name):
    """What each launched rank stepped on (the first batch): its sample's
    rows and its slots, 2 frames for data rank 0, 1 for data rank 1 (slot
    3 pads), the whole batch where data is 1."""
    (data_n, model_n), _ = LAYOUTS[name]
    for r, out in enumerate(ranks[name]):
        want = _share(BATCHES[0], (data_n, model_n), r // model_n)
        got = out["staged"]
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "vision_feats" and data_n > 1:
                assert [tuple(f.shape[:1]) for f in got[k]] == [((2, 1)[r // model_n],)] * 2
                for g, w in zip(got[k], v):
                    _close(g, w, atol=0)
            else:
                _close(got[k], v, atol=0, msg=k)


class _Staged(Exception):
    pass


@pytest.mark.parametrize("d", [0, 1])
def test_loop_moves_only_the_rank_share_to_the_device(tmp_path, monkeypatch, d):
    """The CLI's loop on data rank ``d`` of (2, 1) hands `_to_device` its
    share of the global batch that the one process (per-device batch 2)
    stages whole: its sample's rows and its one frame slot a micro-batch."""
    staged = []

    def record(batch, device):
        staged.append(batch)
        raise _Staged

    monkeypatch.setattr(tloop, "_to_device", record)
    argv = ["--tiny_random", "--device", "cpu", "--synthetic_steps", "1", "--grad_accum_steps",
            "2", "--output_dir", str(tmp_path)]
    for per_device, mesh in ((2, None), (1, ProcessMesh((2, 1), (d, 0), torch.device("cpu")))):
        args = tloop.build_argparser().parse_args(argv + ["--per_device_batch_size",
                                                          str(per_device)])
        with pytest.raises(_Staged):
            tloop._train(args, mesh)
    whole, got = staged
    assert whole["input_ids"].shape[:2] == (2, 2) and whole["vision_feats"].shape[1] == 2
    for k, v in whole.items():
        if k == "vision_feats":
            assert len(got[k]) == 2
            for a in range(2):
                np.testing.assert_array_equal(got[k][a], v[a, d:d + 1])
        else:
            np.testing.assert_array_equal(got[k], v[:, d:d + 1])


def test_chip_smoke_training_mesh_stages_the_rank_share():
    """`chip_smoke.py`'s training-mesh batches as its ranks stage them
    (`_stage` on the CPU): each data rank's sample and its 26 or 18 frame
    slots a micro-batch, the same bytes as `memory_budget_torch`'s staged
    batch term for that rank; the one process stages all 48 slots."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    cfg, tok = chip_smoke.full_width_config()
    batches = chip_smoke.tm_batches(cfg, tok)
    cfg = cfg.replace(text=dataclasses.replace(cfg.text, num_layers=chip_smoke.TM_LAYERS))
    params = chip_smoke.budget.model_params(cfg)
    cpu = torch.device("cpu")

    def staged_term(shape, mode, r):
        c = chip_smoke.tm_budget_config(cfg, shape, mode, r, 48, params)
        return dict((n, b) for n, b, _ in chip_smoke.budget.training_budget(c).persistent)[
            "staged batch"]

    whole = chip_smoke._stage(batches[1], cpu)
    assert whole["frames"].shape[:2] == (chip_smoke.TM_ACCUM, 48)
    assert chip_smoke.budget.tree_bytes(whole) == staged_term((1, 1), "replicate", 0)
    for shape, mode in chip_smoke.TM_LAYOUTS:
        for r in range(shape[0] * shape[1]):
            d = r // shape[1]
            got = chip_smoke._stage(batches[1], cpu, cfg, ProcessMesh(shape, divmod(r, shape[1]),
                                                                      cpu))
            n = sum(chip_smoke.TM_TURNS[d])
            start = sum(chip_smoke.TM_TURNS[0]) if d else 0
            assert torch.equal(got["input_ids"], batches[1]["input_ids"][:, d:d + 1])
            assert [tuple(f.shape[:1]) for f in got["frames"]] == [(n,)] * chip_smoke.TM_ACCUM
            for a, f in enumerate(got["frames"]):
                assert torch.equal(f, batches[1]["frames"][a, start:start + n])
            assert chip_smoke.budget.tree_bytes(got) == staged_term(shape, mode, r)


# ---------------------------------------------------------------------------
# a rank's own reading of a dataset (`loop.rank_real_batches`)
# ---------------------------------------------------------------------------

HOST_KEYS = ("num_frames", "n_real_tokens")  # the whole batch's on every rank


@pytest.fixture(scope="module")
def whole_steps():
    """The one process's steps over `worker.LoaderData` (`real_batches`,
    collated whole) and what it fetched."""
    data = worker.LoaderData()
    steps = list(tloop.real_batches(data, worker.loader_collator(data), **worker.LOADER_ARGS))
    return steps, data.fetched


def _stream():
    """The (epoch, index) at each position of the loader's stream after
    the resume skip: a shuffle an epoch, as `real_batches` orders it."""
    args, order, out = worker.LOADER_ARGS, list(range(len(worker.LoaderData()))), []
    rng = random.Random(args["seed"])
    for epoch in range(args["epochs"]):
        rng.shuffle(order)
        out += [(epoch, i) for i in order]
    return out[args["skip_batches"] * args["B"] * args["A"]:]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rank_loader_reads_the_rank_share_of_each_step(ranks, whole_steps, name):
    """Every rank's steps, read alone, are bit for bit `rank_batch`'s cut
    of the one process's steps (its rows padded to the whole batch's
    length bucket, its frames, one zero slot where it holds none), with
    the whole batch's frame and real-token counts."""
    shape, _ = LAYOUTS[name]
    steps, _ = whole_steps
    for r, out in enumerate(ranks[name]):
        mesh = ProcessMesh(shape, divmod(r, shape[1]), torch.device("cpu"))
        got = out["loader"]["steps"]
        assert len(got) == len(steps)
        for i, (g, step) in enumerate(zip(got, steps)):
            want = tstep.rank_batch({k: v for k, v in step.items() if k not in HOST_KEYS},
                                    CFG, mesh)
            want.update({k: step[k] for k in HOST_KEYS})
            assert set(g) == set(want), i
            for k, w in want.items():
                for gx, wx in (zip(g[k], w) if isinstance(w, tuple) else [(g[k], w)]):
                    assert gx.numpy().dtype == wx.dtype, (i, k)
                    np.testing.assert_array_equal(gx.numpy(), wx, err_msg=f"step {i} {k}")
            assert isinstance(g["frames"], tuple) == (shape[0] > 1)
            if shape[0] == 1:  # `real_batches`' steps themselves, in its key order
                assert list(g) == list(step), i


def _owner(p: int, shape) -> int:
    """The rank that fetches position ``p`` of the stream on a (D, M)
    mesh: model index ``i mod M`` of micro-batch ``i = p // B``, data
    index of the block of B / D positions that holds ``p``."""
    (data_n, model_n), B = shape, worker.LOADER_ARGS["B"]
    return p % B // (B // data_n) * model_n + p // B % model_n


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rank_loader_fetches_only_the_rank_positions(ranks, whole_steps, name):
    """Model rank ``m`` of data rank ``d`` fetches exactly the positions
    ``[d B / D, (d + 1) B / D)`` of the whole micro-batches ``i = m (mod
    M)``, and nothing of the dropped partial tail: the model ranks of a
    data rank fetch disjoint sets whose union is its share, and the mesh
    fetches each position once, as the one process does. A rank that
    shares over ``model`` sends and receives; a (D, 1) rank shares
    nothing."""
    shape, _ = LAYOUTS[name]
    (data_n, model_n), (stream, B) = shape, (_stream(), worker.LOADER_ARGS["B"])
    assert sorted(whole_steps[1]) == sorted(stream)
    whole = len(stream) // B * B
    fetched = [sorted(map(tuple, out["loader"]["fetched"])) for out in ranks[name]]
    for r, got in enumerate(fetched):
        assert got == sorted(stream[p] for p in range(whole) if _owner(p, shape) == r), r
        stats = ranks[name][r]["loader"]["stats"]
        assert (stats["sent"] > 0 and stats["received"] > 0) if model_n > 1 else stats == {}
    for d in range(data_n):
        share = sorted(stream[p] for p in range(whole) if p % B // (B // data_n) == d)
        union = sorted(x for got in fetched[d * model_n:(d + 1) * model_n] for x in got)
        assert union == share, d  # disjoint: no position twice in the union
    assert sorted(x for got in fetched for x in got) == sorted(stream[:whole])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_rank_loader_steps_agree_when_one_rank_fails_a_read(ranks, name):
    """The last rank alone fails to read item LOADER_FLAKY (in every epoch)
    and replaces it as `StreamDataset` does (on (2, 2) it is a TP partner).
    Only the rank that owns a position reads it, so the mesh's steps are
    `rank_batch` of the one process's steps where the item fails at the
    positions the last rank owns and nowhere else, bit for bit on every rank: the model ranks of a data rank hold
    the same bits. The data holds both kinds of position in every layout,
    and the failures change the steps."""
    shape, _ = LAYOUTS[name]
    stream, B = _stream(), worker.LOADER_ARGS["B"]
    flaky = [p for p, (_, i) in enumerate(stream[:len(stream) // B * B])
             if i == worker.LOADER_FLAKY]
    fails = [stream[p] for p in flaky if _owner(p, shape) == shape[0] * shape[1] - 1]
    assert fails and len(fails) < len(flaky)
    data = worker.LoaderData(fails)
    steps = list(tloop.real_batches(data, worker.loader_collator(data), **worker.LOADER_ARGS))
    clean = list(tloop.real_batches(worker.LoaderData(), worker.loader_collator(data),
                                    **worker.LOADER_ARGS))
    assert any(not np.array_equal(a["sample_idxs"], b["sample_idxs"])
               for a, b in zip(steps, clean))
    for r, out in enumerate(ranks[name]):
        mesh = ProcessMesh(shape, divmod(r, shape[1]), torch.device("cpu"))
        got = out["flaky_loader"]["steps"]
        assert len(got) == len(steps), r
        for i, (g, step) in enumerate(zip(got, steps)):
            want = tstep.rank_batch({k: v for k, v in step.items() if k not in HOST_KEYS},
                                    CFG, mesh)
            want.update({k: step[k] for k in HOST_KEYS})
            assert set(g) == set(want), i
            for k, w in want.items():
                for gx, wx in (zip(g[k], w) if isinstance(w, tuple) else [(g[k], w)]):
                    assert gx.numpy().dtype == wx.dtype, (r, i, k)
                    np.testing.assert_array_equal(gx.numpy(), wx, err_msg=f"rank {r} step {i} {k}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_share_crosses_every_value_bit_for_bit(ranks, name):
    """`collectives.share` from each owner index of each axis: every other
    rank of the axis gets `share_value(owner)` bit for bit (bf16 and f32
    -0.0 and NaN payloads, bool, uint8, an empty frame array, 0-d and int32
    arrays, each of its kind, dtype and shape; the JSON values), the owner
    keeps its own value; an owner's error raises there and `ShareError` on
    the others. On an axis of size 1 it is the identity. Over both axes
    (`eval.inference.mesh_items`) an item arrives bit for bit on every
    rank, and an item whose owner fails to fetch it raises on every rank,
    none left waiting."""
    shape, _ = LAYOUTS[name]
    for r, out in enumerate(ranks[name]):
        coords = dict(zip(("data", "model"), divmod(r, shape[1])))
        for axis, size in zip(("data", "model"), shape):
            for owner in range(size):
                case = out["share"][f"{axis}{owner}"]
                want = worker._as_record(worker.share_value(owner))
                mine = coords[axis] == owner
                assert case["kept"] == mine, (r, axis, owner)
                assert case["raised"] == ("ValueError" if mine else "ShareError"), (r, axis)
                assert list(case["got"]) == list(want)
                for k, w in want.items():
                    g = case["got"][k]
                    if isinstance(w, str):
                        assert g == w, k
                    else:
                        assert tuple(g[:3]) == tuple(w[:3]) and torch.equal(g[3], w[3]), k
        items = out["share"]["items"]  # `mesh_items`: item 0 arrives, item 1's owner (rank 1) fails
        assert items["raised"] == ("ValueError" if r == 1 else "ShareError"), r
        assert len(items["got"]) == 1
        want = worker._as_record(worker.share_value(0))
        assert [k for k in items["got"][0]] == list(want)
        for k, w in want.items():
            g = items["got"][0][k]
            assert g == w if isinstance(w, str) else (
                tuple(g[:3]) == tuple(w[:3]) and torch.equal(g[3], w[3])), k


def test_rank_loader_steps_agree_over_layouts(ranks, whole_steps):
    """The data ranks' samples joined in data order are the one
    process's, step by step, in every layout; and the data holds each case
    the loader must get right: two length buckets whose steps interleave,
    frame counts ragged over A, a data rank with no frame in a
    micro-batch, a truncated sample, a replaced item, a dropped tail."""
    steps, _ = whole_steps
    want = [s["sample_idxs"] for s in steps]
    for name, ((data_n, model_n), _) in LAYOUTS.items():
        got = [np.concatenate([ranks[name][d * model_n]["loader"]["steps"][i]["sample_idxs"]
                               .numpy() for d in range(data_n)], axis=1)
               for i in range(len(steps))]
        assert len(ranks[name][0]["loader"]["steps"]) == len(steps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    args = worker.LOADER_ARGS
    lengths = [s["input_ids"].shape[-1] for s in steps]
    assert sorted(set(lengths)) == [384, 512] and lengths != sorted(lengths)
    counts = [(s["input_ids"] == CFG.v_placeholder_id).sum(-1) // 4 for s in steps]
    assert any(len(set(c.sum(-1).tolist())) > 1 for c in counts)  # ragged over A
    assert any((c[:, 2:].sum(-1) == 0).any() for c in counts)  # data rank 1 of 2: no frame
    used = np.concatenate([s["sample_idxs"].ravel() for s in steps])
    assert worker.LOADER_BROKEN not in used
    assert any(c.max() == 8 for c in counts)  # 10 frames cut to 8 at 512 tokens
    micros = len(_stream()) // args["B"]
    assert len(_stream()) % args["B"] and micros > args["A"] * len(steps)  # tails dropped


# ---------------------------------------------------------------------------
# the CLI under torch.distributed.run
# ---------------------------------------------------------------------------

CLI = ["--tiny_random", "--device", "cpu", "--synthetic_steps", "3", "--grad_accum_steps", "2",
       "--logging_steps", "1", "--save_steps", "2"]


def _log(out: Path):
    with open(out / "log.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli") / "one"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the launched ranks (OMP_NUM_THREADS=1), beside other workers
    try:
        tloop.main(CLI + ["--per_device_batch_size", "2", "--output_dir", str(out)])
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("launch", [(2, ["--mesh_data", "2"]),
                                    (4, ["--mesh_model", "2", "--param_mode", "fsdp"])],
                         ids=["mesh_data_2", "fsdp_mesh_model_2"])
def test_cli_under_torchrun_matches_the_one_process_cli(one_process_cli, tmp_path, launch):
    """The global batch (per-device 1 x data 2) is the one process's batch
    of 2: the same losses to 1e-4, the same checkpoint of step 2 and the
    same ``final/`` (the base bit for bit, the trained leaves to 1e-5)."""
    n, flags = launch
    out = tmp_path / "mesh"
    _finish(_start(n, "-m", "mmduet_tpu_torch.train.loop", *CLI, *flags,
                   "--dist_backend", "gloo", "--output_dir", str(out)))
    got, want = _log(out), _log(one_process_cli)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in METRICS:
            _close(g[k], w[k], atol=1e-4, rtol=1e-4)
    for name in ("checkpoint-2", "final"):
        assert sorted(os.listdir(out / name)) == sorted(os.listdir(one_process_cli / name))
    s_got = torch.load(out / "checkpoint-2" / tckpt.STATE_FILE, weights_only=True)
    s_want = torch.load(one_process_cli / "checkpoint-2" / tckpt.STATE_FILE, weights_only=True)
    assert s_got["step"] == s_want["step"] == 2
    for key, leaf in _flat(s_want["trainable"]).items():
        _close(_flat(s_got["trainable"])[key], leaf.numpy(), msg=key)
    _, p_got, l_got = tio.load_checkpoint(str(out / "final"), device="cpu")
    _, p_want, l_want = tio.load_checkpoint(str(one_process_cli / "final"), device="cpu")
    trained = ("projector", "informative_head", "relevance_head")
    for key, leaf in _flat(p_want).items():
        if key.split("/")[0] in trained:
            _close(_flat(p_got)[key], leaf.numpy(), msg=key)
        else:
            assert torch.equal(_flat(p_got)[key], leaf), key
    for key, leaf in _flat(l_want).items():
        _close(_flat(l_got)[key], leaf.numpy(), msg=key)
