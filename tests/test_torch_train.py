"""The port's training path (`mmduet_tpu_torch.train`, kernel C's plain
version, full mode and LoRA in `models.qwen2`, `models.mmduet.train_forward`)
against the JAX package on `tiny_config()`: one numpy state and numpy inputs
from a seed feed both.

f32 on both sides, so differences are summation order: hidden states and
attention outputs agree to 1e-4 absolute, losses and gradient norms to
1e-5 relative, and parameters after three Adam steps to 1e-6 absolute at
lr 1e-2 (Adam divides by sqrt(nu), so an update is about lr in size and
inherits the gradients' relative error)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmduet_tpu.config import TrainArgs, tiny_config
from mmduet_tpu.models import init_mmduet_params as jax_init
from mmduet_tpu.models import io as jio
from mmduet_tpu.models import lora as jlora
from mmduet_tpu.models import mmduet as jmm
from mmduet_tpu.models import qwen2 as jq
from mmduet_tpu.ops import attention as jatt
from mmduet_tpu.train import init_train_state as j_init_state
from mmduet_tpu.train import loop as jloop
from mmduet_tpu.train import make_optimizer as j_make_optimizer
from mmduet_tpu.train import make_train_step as j_make_step
from mmduet_tpu.train.optimizer import make_lr_schedule as j_make_sched
from mmduet_tpu_torch.models import io as tio
from mmduet_tpu_torch.models import lora as tlora
from mmduet_tpu_torch.models import mmduet as tmm
from mmduet_tpu_torch.models import params_from_numpy, train_state_from_numpy
from mmduet_tpu_torch.models import qwen2 as tq
from mmduet_tpu_torch.ops import attention as tatt
from mmduet_tpu_torch.train import checkpoint as tckpt
from mmduet_tpu_torch.train import loop as tloop
from mmduet_tpu_torch.train import optimizer as topt
from mmduet_tpu_torch.train import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
CFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
JP = jax_init(jax.random.PRNGKey(0), CFG)
NP = jax.tree.map(np.asarray, JP)
TP = params_from_numpy(NP, "cpu")


def _rng(seed):
    return np.random.RandomState(seed)


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _lora_np(seed, cfg=CFG, rank=4):
    """A LoRA tree with nonzero ``b`` (a fresh adapter is a no-op)."""
    tree = jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(seed), cfg.text, rank))
    r = _rng(seed)
    return {n: {"a": ab["a"], "b": (r.randn(*ab["b"].shape) * 0.05).astype(np.float32)}
            for n, ab in tree.items()}


def _mask(B, T, pad_side, n_real):
    m = np.ones((B, T), bool)
    for b, n in enumerate(n_real):
        if pad_side == "left":
            m[b, : T - n] = False
        elif pad_side == "right":
            m[b, n:] = False
    return m


# ---------------------------------------------------------------------------
# kernel C's plain version against the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_side", ["left", "right", "none"])
@pytest.mark.parametrize("T", [48, 200])
def test_flash_full_ref_matches_jax_oracle(pad_side, T):
    """Forward and the gradients of q, k and v, every row: the JAX wrapper
    with the stock kernel's jnp reference (`mha_reference` forward,
    `mha_reference_no_custom_vjp` for autodiff) has the same segment
    semantics, pad rows included."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        mha_reference, mha_reference_no_custom_vjp)

    B, nh, kh, hd = 2, 4, 2, 128
    r = _rng(T + len(pad_side))
    q, k, v, dout = (r.randn(B, T, h, hd).astype(np.float32) * 0.3
                     for h in (nh, kh, kh, nh))
    mask = None if pad_side == "none" else _mask(B, T, pad_side, (T - 5, T - 17))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)

    want = jatt.flash_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                     _impl=mha_reference)
    tq_, tk_, tv_ = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = tatt.flash_full_attention(tq_, tk_, tv_, tm)
    _close(got, want, atol=2e-5)

    def jloss(q, k, v):
        out = jatt.flash_full_attention(q, k, v, jm, _impl=mha_reference_no_custom_vjp)
        return jnp.sum(out * dout)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    (got * torch.tensor(dout)).sum().backward()
    for t, j in zip((tq_, tk_, tv_), jg):
        _close(t.grad, j, atol=2e-5)


# ---------------------------------------------------------------------------
# qwen2: full mode, LoRA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
def test_qwen2_full_forward_matches_jax(with_lora, use_flash):
    """Left-padded batch; JAX takes its masked plain path (its flash path
    needs a TPU). The port's plain path matches it on every row, the plain
    kernel-C path on real rows (pad rows follow segment semantics)."""
    B, T = 2, 24
    mask = _mask(B, T, "left", (24, 15))
    pos = np.cumsum(mask, 1).astype(np.int32) - 1
    emb = _rng(1).randn(B, T, CFG.text.hidden_size).astype(np.float32)
    lo = _lora_np(5) if with_lora else None
    jh, _ = jq.qwen2_forward(
        JP["decoder"], CFG.text, jnp.asarray(emb), jnp.asarray(pos),
        attn_mask=jnp.asarray(mask), lora=lo, lora_scale=2.0, use_flash=False)
    th, cache = tq.qwen2_forward(
        TP["decoder"], CFG.text, torch.tensor(emb), torch.tensor(pos),
        attn_mask=torch.tensor(mask), lora=None if lo is None else params_from_numpy(lo, "cpu"),
        lora_scale=2.0, use_flash=use_flash, remat=use_flash)
    assert cache is None
    rows = mask if use_flash else np.ones_like(mask)
    _close(th.numpy()[rows], np.asarray(jh)[rows])


def test_qwen2_full_auto_takes_the_plain_path_on_cpu():
    """``use_flash=None`` on CPU tensors is the masked plain attention (no
    NaN guard, repeated positions allowed), as JAX's auto off the TPU."""
    B, T = 1, 16
    pos = np.repeat(np.arange(T // 2, dtype=np.int32), 2)[None]  # repeated positions
    emb = _rng(2).randn(B, T, CFG.text.hidden_size).astype(np.float32)
    jh, _ = jq.qwen2_forward(JP["decoder"], CFG.text, jnp.asarray(emb), jnp.asarray(pos))
    th, _ = tq.qwen2_forward(TP["decoder"], CFG.text, torch.tensor(emb), torch.tensor(pos))
    _close(th, jh)


def test_qwen2_streaming_with_lora_matches_jax():
    B, T, S = 2, 8, 64
    t = CFG.text
    cl, tr = np.array([5, 20], np.int32), np.array([8, 3], np.int32)
    emb = _rng(1).randn(B, T, t.hidden_size).astype(np.float32)
    pos = cl[:, None] + np.arange(T)[None]
    shape = (t.num_layers, B, t.num_kv_heads, S, t.head_dim)
    k = (_rng(2).randn(*shape) * 0.5).astype(np.float32)
    v = (_rng(3).randn(*shape) * 0.5).astype(np.float32)
    lo = _lora_np(7)
    jh, _ = jq.qwen2_forward(
        JP["decoder"], t, jnp.asarray(emb), jnp.asarray(pos),
        kv_cache=jq.KVCache(jnp.asarray(k), jnp.asarray(v)), cache_len=jnp.asarray(cl),
        t_real=jnp.asarray(tr), lora=lo, lora_scale=2.0, use_flash=False)
    th, _ = tq.qwen2_forward(
        TP["decoder"], t, torch.tensor(emb), torch.tensor(pos),
        kv_cache=tq.KVCache(torch.tensor(k), torch.tensor(v)), cache_len=cl.tolist(),
        t_real=tr.tolist(), lora=params_from_numpy(lo, "cpu"), lora_scale=2.0)
    for b in range(B):
        _close(th[b, : tr[b]], jh[b, : tr[b]])


def test_fold_and_merge_lora_match_jax():
    lo = _lora_np(9)
    tlo = params_from_numpy(lo, "cpu")
    for (jk, jv), (tk, tv) in zip(sorted(_flat(jlora.fold_lora_scale(lo, 2.0)).items()),
                                  sorted(_flat(tlora.fold_lora_scale(tlo, 2.0)).items())):
        assert jk == tk
        _close(tv, jv, atol=1e-7)
    jm = jlora.merge_lora(JP["decoder"], lo, 2.0)
    tm = tlora.merge_lora(TP["decoder"], tlo, 2.0)
    for name in tlora.DEFAULT_TARGETS:
        _close(tm["layers"][name], jm["layers"][name], atol=1e-6)
    assert tm["embed"] is TP["decoder"]["embed"]
    # a fresh adapter (b = 0) is a no-op, at the JAX init's shapes
    fresh = tlora.init_lora(torch.Generator().manual_seed(0), CFG.text, rank=4)
    ref = jlora.init_lora(jax.random.PRNGKey(0), CFG.text, rank=4)
    for name, ab in fresh.items():
        assert ab["a"].shape == ref[name]["a"].shape and not ab["b"].any()
        assert ab["b"].shape == ref[name]["b"].shape


# ---------------------------------------------------------------------------
# train_forward and the train step
# ---------------------------------------------------------------------------


def _batch(A=2, B=2, T=16, mode="vision_feats", seed=0, pad=True):
    """Duet-shaped batch: one frame per sample at position 2, right padding
    on the second sample when ``pad``."""
    r = _rng(seed)
    vid, ft = CFG.v_placeholder_id, CFG.frame_num_tokens
    ids = r.randint(0, 200, (A, B, T))
    ids[:, :, 2:2 + ft] = vid
    mask = np.ones((A, B, T), bool)
    if pad:
        mask[:, 1, T - 4:] = False
    labels = np.full((A, B, T), -100)
    labels[:, :, 8:11] = ids[:, :, 8:11]
    inf = np.full((A, B, T), -100)
    inf[:, :, 2 + ft - 1] = r.randint(0, 2, (A, B))
    rel = np.full((A, B, T), -100)
    rel[:, 0, 2 + ft - 1] = 1
    batch = {
        "input_ids": ids.astype(np.int32), "attn_mask": mask,
        "labels": labels.astype(np.int32), "informative_labels": inf.astype(np.int32),
        "relevance_labels": rel.astype(np.int32),
    }
    if mode == "vision_feats":
        batch["vision_feats"] = r.randn(
            A, B, CFG.vision.num_patches, CFG.vision.hidden_size).astype(np.float32)
    else:
        batch["frames"] = r.randint(0, 256, (A, B, 32, 32, 3)).astype(np.uint8)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_train_forward_matches_jax():
    batch = _batch(A=1, seed=4)
    micro = {k: v[0] for k, v in batch.items()}
    lo = _lora_np(11)
    feats = micro["vision_feats"]
    jfe = jmm.spatial_pool(jmm.project(JP, jnp.asarray(feats)), CFG)
    tfe = tmm.spatial_pool(tmm.project(TP, torch.tensor(feats)), CFG)
    args = [micro[k] for k in ("input_ids", "attn_mask")]
    lab = [micro[k] for k in ("labels", "informative_labels", "relevance_labels")]
    jout = jmm.train_forward(JP, CFG, *map(jnp.asarray, args), jfe, *map(jnp.asarray, lab),
                             lora=lo, lora_scale=2.0, remat=False, use_flash=False)
    tout = tmm.train_forward(TP, CFG, *map(torch.tensor, args), tfe, *map(torch.tensor, lab),
                             lora=params_from_numpy(lo, "cpu"), lora_scale=2.0, remat=True)
    for name in ("loss", "lm_loss", "video_loss"):
        _close(getattr(tout, name), getattr(jout, name), atol=0, rtol=1e-5)
    real = micro["attn_mask"]
    _close(tout.lm_logits.numpy()[real], np.asarray(jout.lm_logits)[real])


def _steps(mode, n_steps=3, lr=1e-2, poison_step=None):
    """The same state through ``n_steps`` JAX and port train steps; yields
    (jax state, jax metrics, port state, port metrics) after each."""
    args = TrainArgs(learning_rate=lr, lora_r=4, lora_alpha=8, warmup_ratio=0.3)
    jtx, jsched = j_make_optimizer(args, total_steps=10)
    jstate = j_init_state(JP, jax.tree.map(jnp.asarray, _lora_np(13)), jtx)
    jstep = j_make_step(CFG, args, jtx, jsched)
    ttx, tsched = topt.make_optimizer(args, total_steps=10)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tstep_fn = tstep.make_train_step(CFG, args, ttx, tsched)
    for i in range(n_steps):
        batch = _batch(mode=mode, seed=20 + i)
        if i == poison_step:
            batch["vision_feats"] = batch["vision_feats"] * np.nan
        jstate, jm = jstep(jstate, JP, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep_fn(tstate, TP, _torch_batch(batch))
        yield jstate, jm, tstate, tm


@pytest.mark.parametrize("mode", ["vision_feats", "frames"])
def test_train_step_matches_jax_over_three_steps(mode):
    """A = 2 micro-batches a step, cosine schedule with one warmup step
    (the first update runs at lr 0): the trainable leaves, the Adam
    moments, grad_norm, lr and the losses agree at every step."""
    for i, (js, jm, ts, tm) in enumerate(_steps(mode)):
        assert ts.step == int(js.step) == i + 1
        assert set(tm) == set(jm)
        for k in ("loss", "lm_loss", "video_loss", "grad_norm"):
            _close(tm[k], float(jm[k]), atol=0, rtol=1e-5)
        _close(tm["lr"], float(jm["lr"]), atol=0, rtol=1e-6)
        assert tm["skipped_nonfinite"] == float(jm["skipped_nonfinite"]) == 0.0
        jt, tt = _flat(jax.tree.map(np.asarray, js.trainable)), _flat(ts.trainable)
        assert set(jt) == set(tt)
        for key in jt:
            _close(tt[key], jt[key], atol=1e-6)
        adam = js.opt_state[1][0]
        assert ts.opt_state["count"] == int(adam.count)
        for key, want in _flat(jax.tree.map(np.asarray, adam.mu)).items():
            _close(_flat(ts.opt_state["mu"])[key], want, atol=1e-7, rtol=1e-4)
    assert tm["lr"] > 0


def test_nonfinite_step_keeps_state_and_counters_part_as_in_jax():
    """A NaN in step 2's features: trainable leaves and the optimizer
    state, its count included, are kept; ``step`` advances, so the next
    step's lr is read at ``step`` while Adam's count lags by one."""
    hist = list(_steps("vision_feats", n_steps=3, poison_step=1))
    (_, _, t1, _), (js2, jm2, t2, tm2), (js3, jm3, t3, tm3) = hist
    assert tm2["skipped_nonfinite"] == float(jm2["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(tm2["loss"]) and not np.isfinite(float(jm2["loss"]))
    for key, leaf in _flat(t1.trainable).items():
        assert torch.equal(_flat(t2.trainable)[key], leaf)
    assert t2.opt_state["count"] == t1.opt_state["count"] == 1
    assert int(js2.opt_state[1][0].count) == 1
    assert t2.step == int(js2.step) == 2
    assert t3.step == 3 and t3.opt_state["count"] == int(js3.opt_state[1][0].count) == 2
    _close(tm3["lr"], float(jm3["lr"]), atol=0, rtol=1e-6)
    for key, want in _flat(jax.tree.map(np.asarray, js3.trainable)).items():
        _close(_flat(t3.trainable)[key], want, atol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("total", [1, 7, 40])
def test_lr_schedules_match_optax(kind, total):
    args = TrainArgs(learning_rate=3e-4, lr_schedule=kind, warmup_ratio=0.1)
    want = j_make_sched(args, total)
    got = topt.make_lr_schedule(args, total)
    # optax computes in f32, the port in f64: near the end of the cosine
    # the f32 cos has a large relative error, so compare at the lr's scale
    for step in range(total + 3):
        _close(got(step), float(want(step)), atol=1e-6 * args.learning_rate)


def test_optimizer_update_matches_optax_with_clipping():
    """One update with a gradient norm above 1 (clipped) and one below,
    on a tree with a bf16 leaf: optax promotes its moments to f32 and
    rounds ``p + u`` to the leaf's dtype, as the port does."""
    r = _rng(8)
    params = {"w": r.randn(5, 3).astype(np.float32), "h": r.randn(4).astype(np.float32)}
    tparams = {"w": torch.tensor(params["w"]),
               "h": torch.tensor(params["h"]).to(torch.bfloat16)}
    jparams = {"w": jnp.asarray(params["w"]), "h": jnp.asarray(params["h"], jnp.bfloat16)}
    args = TrainArgs(learning_rate=1e-2, lr_schedule="constant")
    jtx, _ = j_make_optimizer(args, 10)
    ttx, _ = topt.make_optimizer(args, 10)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for scale in (3.0, 0.01):
        g = {k: (r.randn(*v.shape) * scale).astype(np.float32) for k, v in params.items()}
        tg = {k: torch.tensor(v) for k, v in g.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tparams, tstate = ttx.update(tg, tstate, tparams, topt.global_norm(tg))
        for k in params:
            assert tparams[k].dtype == (torch.bfloat16 if k == "h" else torch.float32)
            _close(tparams[k].float(), np.asarray(jparams[k], np.float32), atol=1e-6)
            _close(tstate["nu"][k], np.asarray(jstate[1][0].nu[k], np.float32),
                   atol=0, rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints, the CLI, the copied host code
# ---------------------------------------------------------------------------


def test_save_restore_resume_equals_uninterrupted(tmp_path):
    args = TrainArgs(learning_rate=1e-2, lora_r=4, lora_alpha=8, lr_schedule="constant")
    tx, sched = topt.make_optimizer(args, 10)
    step = tstep.make_train_step(CFG, args, tx, sched)
    lora = tlora.init_lora(torch.Generator().manual_seed(1), CFG.text, rank=4)
    batches = [_torch_batch(_batch(seed=40 + i)) for i in range(4)]

    state = tstep.init_train_state(TP, lora, tx)
    for b in batches:
        state, _ = step(state, TP, b)

    resumed = tstep.init_train_state(TP, lora, tx)
    for b in batches[:2]:
        resumed, _ = step(resumed, TP, b)
    out = str(tmp_path / "run")
    tckpt.save_train_state(out, 1, resumed, save_total_limit=2)  # rotated away
    tckpt.save_train_state(out, 2, resumed, save_total_limit=2)
    tckpt.save_train_state(out, 3, resumed, save_total_limit=2)
    os.remove(os.path.join(out, "checkpoint-3", tckpt.STATE_FILE))  # killed mid-save
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-3"]
    path = tckpt.latest_checkpoint(out)
    assert path.endswith("checkpoint-2")
    template = tstep.init_train_state(TP, lora, tx)
    resumed = tckpt.restore_train_state(path, template)
    assert resumed.step == 2 and resumed.opt_state["count"] == 2
    for b in batches[2:]:
        resumed, _ = step(resumed, TP, b)
    assert resumed.step == state.step == 4
    for tree in ("trainable",):
        for key, leaf in _flat(getattr(state, tree)).items():
            assert torch.equal(_flat(getattr(resumed, tree))[key], leaf), key
    for key, leaf in _flat(state.opt_state["nu"]).items():
        assert torch.equal(_flat(resumed.opt_state["nu"])[key], leaf), key


def _cli(out, *extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "mmduet_tpu_torch.train.loop", "--tiny_random",
         "--device", "cpu", "--output_dir", out, "--grad_accum_steps", "2",
         "--logging_steps", "1", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f], r.stdout


def test_cli_tiny_random_writes_the_jax_clis_log_keys_and_a_final_checkpoint(tmp_path):
    rows, _ = _cli(str(tmp_path / "torch"), "--synthetic_steps", "3")
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in rows)
    jax_out = str(tmp_path / "jax")
    jloop.main(["--tiny_random", "--synthetic_steps", "1", "--output_dir", jax_out,
                "--grad_accum_steps", "2", "--logging_steps", "1", "--mesh_data", "1"])
    with open(os.path.join(jax_out, "log.jsonl")) as f:
        (jrow,) = [json.loads(line) for line in f]
    assert set(rows[0]) == set(jrow)
    cfg, params, lo = tio.load_checkpoint(str(tmp_path / "torch" / "final"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jio.load_config(str(tmp_path / "torch" / "final" / "config.json")))
    assert set(params) == set(TP) and set(lo) == set(tlora.DEFAULT_TARGETS)


def test_cli_resume_continues_to_the_uninterrupted_result(tmp_path):
    whole, _ = _cli(str(tmp_path / "a"), "--synthetic_steps", "4")
    part = str(tmp_path / "b")
    _cli(part, "--synthetic_steps", "4", "--save_steps", "2")
    for name in ("checkpoint-4", "final"):  # as if killed after step 2's save
        subprocess.run(["rm", "-rf", os.path.join(part, name)], check=True)
    rows, stdout = _cli(part, "--synthetic_steps", "4", "--resume_from_checkpoint", "auto")
    assert "resuming from" in stdout and "skipping 2" in stdout
    assert rows[-1]["step"] == 4
    assert rows[-1]["loss"] == whole[-1]["loss"]
    _, pa, la = tio.load_checkpoint(str(tmp_path / "a" / "final"))
    _, pb, lb = tio.load_checkpoint(os.path.join(part, "final"))
    for key, leaf in _flat(la).items():
        assert torch.equal(_flat(lb)[key], leaf), key


JAX_FREE = """
import sys
from mmduet_tpu_torch.train import checkpoint, loop, optimizer, step
from mmduet_tpu_torch.models import io, lora
loop.main(["--tiny_random", "--synthetic_steps", "1", "--grad_accum_steps", "1",
           "--device", "cpu", "--output_dir", sys.argv[1]])
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "mmduet_tpu")))
"""


def test_training_path_never_imports_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", JAX_FREE, str(tmp_path / "run")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_a_mesh():
    for argv in (["--mesh_data", "2"], ["--mesh_model", "2"], ["--param_mode", "fsdp"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            tloop.main(["--tiny_random", "--device", "cpu"] + argv)


@pytest.mark.parametrize("error", ["kernel", "other"])
def test_cli_skips_a_failing_batch_but_not_a_kernel_error(error, tmp_path, monkeypatch):
    """The loop's fault guard skips a batch whose step raises, as the JAX
    loop does, but a `KernelError` (a kernel refused its operands or failed
    to launch) ends the run before the final save."""
    exc = tatt.KernelRefused("refused") if error == "kernel" else RuntimeError("bad batch")

    def fail(*args, **kw):
        raise exc

    monkeypatch.setattr(tq, "attend", fail)
    out = tmp_path / "run"
    argv = ["--tiny_random", "--synthetic_steps", "2", "--grad_accum_steps", "1",
            "--device", "cpu", "--output_dir", str(out)]
    if error == "kernel":
        with pytest.raises(tatt.KernelRefused):
            tloop.main(argv)
        assert not (out / "final").exists()
    else:
        tloop.main(argv)
        assert open(out / "log.jsonl").read() == ""  # every batch was skipped
        assert (out / "final").exists()


def test_cli_refuses_f32_base_params_on_the_gpu(tmp_path):
    """Kernel C takes bf16 only, so ``--bf16 false`` with ``--device cuda``
    ends at argument checking, before any device work."""
    with pytest.raises(SystemExit, match="bf16"):
        tloop.main(["--tiny_random", "--bf16", "false", "--device", "cuda",
                    "--output_dir", str(tmp_path / "run")])


@pytest.mark.parametrize("side", ["left", "right"])
def test_bound_helpers_plain_gradients(side):
    """`ops.bounds.full_attention_dropped` with an empty tile is kernel C's
    plain forward and gradients (autograd through `flash_full_attention_ref`,
    f32); a tile moves o and dq only on rows that see its keys, dk and dv
    only on keys its query rows see; `full_attention_rms` is finite and
    positive on real rows."""
    from mmduet_tpu_torch.ops import bounds

    B, T, nh, kh, hd = 1, 150, 4, 2, 128
    r = _rng(11)
    q, k, v, dout = (torch.tensor(r.randn(B, T, h, hd).astype(np.float32) * 0.3)
                     for h in (nh, kh, kh, nh))
    mask = torch.tensor(_mask(B, T, side, (130,)))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tatt.flash_full_attention_ref(*leaves, mask)
    out.backward(dout)
    want = [out.detach()] + [x.grad for x in leaves]
    for got, w in zip(bounds.full_attention_dropped(q, k, v, mask, dout, slice(0, 0)), want):
        _close(got, w, atol=1e-5)
    tile = slice(64, 96)
    dropped = bounds.full_attention_dropped(q, k, v, mask, dout, tile)
    moved = [(d - w).abs().amax(dim=(0, 2, 3)) > 1e-6 for d, w in zip(dropped, want)]
    seg = mask[0]
    sees_tile = torch.tensor([bool((seg[tile] == seg[t]).any()) and t >= 64 for t in range(T)])
    seen_by_tile = torch.tensor([bool((seg[tile] == seg[s]).any()) and s < 96 for s in range(T)])
    assert torch.equal(moved[0], sees_tile) and torch.equal(moved[1], sees_tile)
    assert torch.equal(moved[2] | moved[3], seen_by_tile)
    for rms in bounds.full_attention_rms(q, k, v, mask, dout, want[0]):
        assert torch.isfinite(rms).all() and (rms[:, mask[0]] > 0).all()


def test_duet_batches_train_in_pixel_mode():
    """`train.duet.duet_batches`: collated duet samples padded to a length
    bucket, with frames, that one train step takes in pixel mode."""
    from mmduet_tpu.stream import CharTokenizer
    from mmduet_tpu_torch.train.duet import duet_batches

    tok = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
    (batch,) = duet_batches(tok, CFG, 1, 2, "cpu", turn_frames=(3, 4), seq_len=1024,
                            max_frames=16)
    A, B, T = batch["input_ids"].shape
    assert (A, B) == (2, 1) and T in tloop.parse_length_buckets("auto", 1024)
    assert batch["frames"].shape[:2] == (2, 8) and batch["frames"].dtype == torch.uint8
    real = batch["attn_mask"].sum(-1)
    assert (real < T).all() and (real > T // 2).all()
    assert ((batch["input_ids"] == CFG.v_placeholder_id).sum(-1)
            == 7 * CFG.frame_num_tokens).all()
    assert ((batch["informative_labels"] != -100).sum() > 0
            and (batch["labels"] != -100).sum() > 0)
    args = TrainArgs(lr_schedule="constant", learning_rate=1e-3, lora_r=4)
    tx, _ = topt.make_optimizer(args, 10)
    lora = tlora.init_lora(torch.Generator().manual_seed(0), CFG.text, rank=4)
    state, metrics = tstep.make_train_step(CFG, args, tx)(
        tstep.init_train_state(TP, lora, tx), TP, batch)
    assert state.step == 1 and metrics["skipped_nonfinite"] == 0.0
    assert all(np.isfinite(metrics[k]) for k in ("loss", "lm_loss", "video_loss", "grad_norm"))


def test_kernel_build_runs_one_compiler_per_source_at_once(tmp_path, monkeypatch):
    """`ops._build.build` starts one compiler per missing library, all
    before waiting on any, keeps built libraries, and raises with the
    compiler's output when a source fails."""
    from mmduet_tpu_torch.ops import _build

    csrc, log = tmp_path / "csrc", tmp_path / "calls.log"
    csrc.mkdir()
    for name in ("one", "two", "bad"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "fake_nvcc"
    # each call logs its start, then waits (up to 5 s) for a second start:
    # a library holds "lib together" only if its compile overlapped another
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import sys, time\n"
        "src, out = sys.argv[-1], sys.argv[sys.argv.index('-o') + 1]\n"
        f"log = {str(log)!r}\n"
        "open(log, 'a').write(f'start {src}\\n')\n"
        "t0 = time.time()\n"
        "while len(open(log).readlines()) < 2 and time.time() - t0 < 5:\n"
        "    time.sleep(0.02)\n"
        "if 'bad' in src:\n"
        "    print('bad.cu(1): error: nothing here'); sys.exit(1)\n"
        "together = len(open(log).readlines()) >= 2\n"
        "open(out, 'w').write('lib together' if together else 'lib alone')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    _build.build("one", "two")
    assert all(_build.library_path(n).read_text() == "lib together" for n in ("one", "two"))
    _build.build("one", "two")  # nothing to do
    assert len(log.read_text().splitlines()) == 2
    with pytest.raises(RuntimeError, match="nothing here"):
        _build.build()
    assert not _build.library_path("bad").exists()
