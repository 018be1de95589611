"""The port's offline preprocessing (`mmduet_tpu_torch.data.preprocess`)
against the JAX package's: re-encoding and its shards, features from the
port's SigLIP tower against the JAX `extract_features` on the same numpy
weights (f32 on the CPU: 1e-5, summation order only), engine scores from
features against scores from pixels (1e-4, the engines' tolerance), the
files `sharded_extract` writes (names, sidecars, and the ``--bf16`` file
byte for byte), `load_features` on either package's files, the cluster
sharding, and the ``encode`` CLI on a checkpoint of the port."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from mmduet_tpu.config import tiny_config  # noqa: E402
from mmduet_tpu.data import preprocess as jpre  # noqa: E402
from mmduet_tpu.models import init_mmduet_params as jax_init  # noqa: E402
from mmduet_tpu.stream import CharTokenizer  # noqa: E402
from mmduet_tpu_torch.config import TestArgs as InferArgs  # noqa: E402
from mmduet_tpu_torch.data import preprocess as tpre  # noqa: E402
from mmduet_tpu_torch.data.video import decode_video  # noqa: E402
from mmduet_tpu_torch.infer import LiveInferEngine  # noqa: E402
from mmduet_tpu_torch.models import params_from_numpy, siglip  # noqa: E402
from mmduet_tpu_torch.models.io import config_from_dict, save_checkpoint  # noqa: E402

JCFG = tiny_config().replace(v_placeholder_id=511, eos_token_id=257)
CFG = config_from_dict(dataclasses.asdict(JCFG))
JP = jax_init(jax.random.PRNGKey(0), JCFG)
TP = params_from_numpy(jax.tree.map(np.asarray, JP), "cpu")
NO_FFMPEG = "definitely-missing-ffmpeg"


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre") / "videos"
    sub = root / "subdir"
    sub.mkdir(parents=True)
    r = np.random.RandomState(0)
    for path, n in ((root / "a.mp4", 30), (sub / "b.mp4", 20)):
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 40))
        for _ in range(n):  # 3 s and 2 s at 10 fps
            writer.write(r.randint(0, 255, (40, 48, 3), np.uint8))
        writer.release()
    return str(root)


def _copy(video_tree, tmp_path):
    root = str(tmp_path / "videos")
    shutil.copytree(video_tree, root)
    return root


def test_sharded_reencode_shards_disjointly(video_tree, tmp_path):
    root = _copy(video_tree, tmp_path)
    d0 = tpre.sharded_reencode(root, fps=2, resolution=32, num_shards=2, shard_index=0,
                               ffmpeg_bin=NO_FFMPEG)
    assert d0 == jpre.dst_root_for(root, 2, 32)
    first = tpre.list_videos(d0)
    tpre.sharded_reencode(root, fps=2, resolution=32, num_shards=2, shard_index=1,
                          ffmpeg_bin=NO_FFMPEG)
    both = tpre.list_videos(d0)
    assert len(first) == 1 and len(both) == 2 and any("subdir" in o for o in both)
    frames, fps, _ = decode_video(both[0], output_fps=2, resolution=32)
    assert frames.shape[1:] == (32, 32, 3) and abs(fps - 2) < 1e-6 and 3 <= len(frames) <= 7


def test_extract_features_matches_jax(video_tree):
    src = tpre.list_videos(video_tree)[0]
    kw = dict(output_fps=2.0, resolution=32, batch_size=4)  # 6 frames: a padded second batch
    got, fps, dur = tpre.extract_features(src, TP["vision"], CFG.vision, **kw)
    want, j_fps, j_dur = jpre.extract_features(src, JP["vision"], JCFG.vision, **kw)
    assert (fps, dur) == (j_fps, j_dur)
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 16, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encode_frames_runs_f32_on_the_cpu():
    """On the CPU the tower runs in f32 (as the JAX default): the features
    are the f32 tower's output on the normalized pixels exactly."""
    frames = np.random.RandomState(5).randint(0, 256, (5, 32, 32, 3), np.uint8)
    got = tpre._encode_frames(frames, TP["vision"], CFG.vision, batch_size=4)
    px = siglip.normalize_pixels(torch.from_numpy(frames))
    with torch.inference_mode():
        want = torch.cat([siglip.siglip_encode(TP["vision"], CFG.vision, px[i:i + 4])
                          for i in (0, 4)])
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="no frames"):
        tpre._encode_frames(frames[:0], TP["vision"], CFG.vision)


def test_engine_scores_from_features_match_pixels(video_tree):
    src = tpre.list_videos(video_tree)[0]
    feats, _, _ = tpre.extract_features(src, TP["vision"], CFG.vision, output_fps=2.0,
                                        resolution=32, batch_size=4)
    frames, _, _ = decode_video(src, output_fps=2.0, resolution=32)
    tok = CharTokenizer(frame_num_tokens=CFG.frame_num_tokens)
    args = InferArgs(stream_end_prob_threshold=1.0, grounding_mode=True)
    scores = []
    for feed in (lambda e: e.input_video_stream(frames), lambda e: e.input_vision_feats(feats)):
        engine = LiveInferEngine(TP, CFG, tok, args, block_frames=4)
        engine.set_fps(2.0)
        feed(engine)
        engine.inference()
        scores.append([d["informative_score"] for d in engine.debug_data_list])
    assert len(scores[0]) == len(scores[1]) == len(frames)
    np.testing.assert_allclose(scores[1], scores[0], atol=1e-4, rtol=0)


def _tree(dst):
    return sorted(os.path.relpath(os.path.join(r, f), dst)
                  for r, _, fs in os.walk(dst) for f in fs)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_sharded_extract_writes_what_the_jax_one_writes(video_tree, tmp_path, bf16):
    out = {}
    for name, mod, params, cfg in (("jax", jpre, JP, JCFG), ("port", tpre, TP, CFG)):
        root = str(tmp_path / name / "videos")
        shutil.copytree(video_tree, root)
        dst = mod.sharded_extract(root, params["vision"], cfg.vision, output_fps=2.0,
                                  resolution=32, model_tag="org/tiny", batch_size=4,
                                  save_bf16=bf16)
        assert dst == root + "_local_org--tiny"
        out[name] = dst
    assert _tree(out["port"]) == _tree(out["jax"]) == [
        "a.json", "a.npy", "subdir/b.json", "subdir/b.npy"]
    for rel in ("a", "subdir/b"):
        with open(os.path.join(out["port"], rel + ".json")) as f, \
                open(os.path.join(out["jax"], rel + ".json")) as g:
            assert json.load(f) == json.load(g)
        got = tpre.load_features(os.path.join(out["port"], rel + ".npy"))
        want = tpre.load_features(os.path.join(out["jax"], rel + ".npy"))  # either's file
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        # bf16: the f32 features agree to 1e-5, so their bf16 roundings to one ulp
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=2.0**-7 if bf16 else 0)


def test_bf16_file_is_byte_equal_to_the_ml_dtypes_file(tmp_path):
    """The ``--bf16`` file without ``ml_dtypes`` is the JAX package's file
    byte for byte, rounding to nearest even included; the port's
    `load_features` reads it, where the JAX `load_features` cannot read its
    own (a reference hazard, guarded on the port's side)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    r = np.random.RandomState(6)
    x = (r.randn(3, 5, 7) * np.exp(r.uniform(-20, 20, (3, 5, 7)))).astype(np.float32)
    bits = x.view(np.uint32)
    bits[0, 0, :4] = [0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF]  # ties and a carry
    x.flat[-1], x.flat[-2] = np.inf, -0.0
    tpre.write_bf16_npy(str(tmp_path / "port.npy"), x)
    np.save(str(tmp_path / "jax.npy"), x.astype(ml_dtypes.bfloat16))
    port, jax_file = (open(tmp_path / n, "rb").read() for n in ("port.npy", "jax.npy"))
    assert port == jax_file
    got = tpre.load_features(str(tmp_path / "port.npy"))
    np.testing.assert_array_equal(got, x.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.save(str(tmp_path / "u16.npy"), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(tpre.load_features(str(tmp_path / "u16.npy")), got)
    with pytest.raises(ValueError, match="sequence"):
        jpre.load_features(str(tmp_path / "jax.npy"))


def test_slurm_env_sharding(monkeypatch):
    for var in ("SLURM_ARRAY_TASK_COUNT", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_ARRAY_TASK_COUNT", "4")
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "7")
    monkeypatch.setenv("SLURM_ARRAY_TASK_MIN", "5")
    for mod in (tpre, jpre):
        assert mod._resolve_cluster_shard(1, 0) == (4, 2)
        assert mod._resolve_cluster_shard(8, 3) == (8, 3)  # explicit wins
    monkeypatch.delenv("SLURM_ARRAY_TASK_COUNT")
    monkeypatch.setenv("SLURM_NTASKS", "3")
    monkeypatch.setenv("SLURM_PROCID", "1")
    assert tpre._resolve_cluster_shard(1, 0) == jpre._resolve_cluster_shard(1, 0) == (3, 1)
    monkeypatch.delenv("SLURM_NTASKS")
    assert tpre._resolve_cluster_shard(1, 0) == (1, 0)


def test_torch_distributed_sharding(monkeypatch):
    """An initialized process group shards by rank; an uninitialized one is
    left alone (never initialized here), and SLURM comes first."""
    dist = torch.distributed
    for var in ("SLURM_ARRAY_TASK_COUNT", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)

    def no_init(*a, **k):
        raise AssertionError("preprocess initialized a process group")

    monkeypatch.setattr(dist, "init_process_group", no_init)
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert tpre._resolve_cluster_shard(1, 0) == (1, 0)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 3)
    assert tpre._resolve_cluster_shard(1, 0) == (4, 3)
    assert tpre._resolve_cluster_shard(2, 1) == (2, 1)
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert tpre._resolve_cluster_shard(1, 0) == (2, 0)
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    assert tpre._resolve_cluster_shard(1, 0) == (1, 0)
    monkeypatch.setattr(dist, "is_available", lambda: False)
    monkeypatch.setattr(dist, "is_initialized", no_init)
    assert tpre._resolve_cluster_shard(1, 0) == (1, 0)


def test_cli_reencodes_and_encodes_on_the_cpu(video_tree, tmp_path, capsys, monkeypatch):
    for var in ("SLURM_ARRAY_TASK_COUNT", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    root = _copy(video_tree, tmp_path)
    tpre.main(["reencode", "--src_root", root, "--fps", "2", "--resolution", "32",
               "--ffmpeg_bin", NO_FFMPEG])
    small = jpre.dst_root_for(root, 2, 32)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, CFG, TP)
    tpre.main(["encode", "--src_root", small, "--checkpoint", ckpt, "--fps", "2",
               "--batch_size", "4", "--bf16", "--device", "cpu"])
    dst = small + "_local_siglip"
    assert f"done -> {dst}" in capsys.readouterr().out
    feats = tpre.load_features(os.path.join(dst, "a.npy"))
    frames, _, _ = decode_video(os.path.join(small, "a.mp4"), output_fps=2, resolution=32)
    want = tpre._encode_frames(frames, TP["vision"], CFG.vision, batch_size=4)
    np.testing.assert_allclose(feats, want, atol=0, rtol=2.0**-8)
    # --device defaults to cuda: without a card the CLI fails, it never runs on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpre.main(["encode", "--src_root", small, "--checkpoint", ckpt, "--fps", "2"])
