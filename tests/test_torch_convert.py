"""The port's HF converter (`mmduet_tpu_torch.models.convert`) against the
JAX package's, on HF-format directories built here from tiny random
`transformers` models (no download): equal leaves, bit for bit, for the
three layouts (sharded safetensors with an index, one safetensors file,
``pytorch_model.bin``), both output dtypes, ``--quantize int8|int4``, a
bf16 file, a bias-free decoder, and the PEFT adapter cases (the alpha/r
fold applied once, strict keys, ``modules_to_save``, a missing
``adapter_config.json``); `config_from_hf`; the safetensors reader against
the ``safetensors`` package; `chip_smoke.py`'s writer read back by the
package; and the rows of the port's inference CLI on the converted
checkpoint against the JAX CLI's on the JAX converter's. Also here:
`models.io.load_checkpoint` never lands on the CPU unless it is named."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from mmduet_tpu.models import convert as jconvert  # noqa: E402
from mmduet_tpu_torch.models import convert as tconvert  # noqa: E402
from mmduet_tpu_torch.models import io as tio  # noqa: E402
from mmduet_tpu_torch.models.params import _as_is  # noqa: E402
from mmduet_tpu_torch.models.convert import _read_safetensors  # noqa: E402
from test_bpe_tokenizer import build_qwen2_style_tokenizer  # noqa: E402

H, VH, R, ALPHA = 64, 32, 4, 16


def hf_tensors(vocab: int = 256, seed: int = 0) -> dict:
    """A tiny llava-OV state dict (f32 torch tensors): a random
    `Qwen2ForCausalLM`, a `SiglipVisionModel` nested as llava nests it,
    the projector and the two score heads."""
    from transformers import (Qwen2Config as HFQ, Qwen2ForCausalLM, SiglipVisionConfig,
                              SiglipVisionModel)

    torch.manual_seed(seed)
    m = Qwen2ForCausalLM(HFQ(
        vocab_size=vocab, hidden_size=H, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, rope_theta=10000.0,
        attn_implementation="eager"))
    v = SiglipVisionModel(SiglipVisionConfig(
        hidden_size=VH, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=28, patch_size=14, attn_implementation="eager"))
    sd = dict(m.state_dict())
    sd.update({f"model.vision_tower.vision_tower.{k}": t for k, t in v.state_dict().items()})
    g = torch.Generator().manual_seed(seed + 1)
    for name, shape in (("model.mm_projector.0.weight", (H, VH)), ("model.mm_projector.0.bias", (H,)),
                        ("model.mm_projector.2.weight", (H, H)), ("model.mm_projector.2.bias", (H,)),
                        ("informative_head.weight", (2, H)), ("relevance_head.weight", (2, H))):
        sd[name] = 0.1 * torch.randn(shape, generator=g)
    return {k: t.detach().contiguous() for k, t in sd.items()}


def hf_config(vocab: int = 256, eos: int = 7) -> dict:
    return {
        "vocab_size": vocab, "hidden_size": H, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "eos_token_id": eos,
        "video_pooling_stride": 1,  # 2x2 patch grid -> 4 tokens per frame
        "vision_config": {"image_size": 28, "patch_size": 14, "hidden_size": VH,
                          "intermediate_size": 64, "num_hidden_layers": 2,
                          "num_attention_heads": 2},
    }


def write_hf_dir(d, sd: dict, cfg: dict, layout: str = "single", tokenizer=None) -> str:
    """``sd`` in one of the three layouts the converters read."""
    from safetensors.torch import save_file

    os.makedirs(d, exist_ok=True)
    if layout == "index":
        names = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": names[::2],
                  "model-00002-of-00002.safetensors": names[1::2]}
        for fname, keys in shards.items():
            save_file({k: sd[k] for k in keys}, os.path.join(d, fname))
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {k: fn for fn, ks in shards.items() for k in ks}}, f)
    elif layout == "single":
        save_file(sd, os.path.join(d, "model.safetensors"))
    else:
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    if tokenizer is not None:
        tokenizer.save_pretrained(str(d))
    return str(d)


def jax_leaves(tree):
    """The JAX converter's tree as tensors of the same dtypes (bf16 stays
    bf16, int8 stays int8)."""
    if tree is None or isinstance(tree, dict):
        return tree if tree is None else {k: jax_leaves(v) for k, v in tree.items()}
    return _as_is(np.asarray(tree), "cpu")


def assert_trees_equal(got, want, path="") -> None:
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert torch.equal(got, want), path


@pytest.fixture(scope="module")
def sd():
    return hf_tensors()


def convert_both(hf_dir, out_dtype: str, quantize=None, lora_dir=None, jax_dir=None):
    """(port cfg, params, lora) and (JAX cfg, params, lora) of one HF dir."""
    jdtype = {"bfloat16": jax.numpy.bfloat16, "float32": jax.numpy.float32}[out_dtype]
    tdtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[out_dtype]
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    t = tconvert.convert_hf_checkpoint(hf_dir, tconvert.config_from_hf(hf_cfg), lora_dir=lora_dir,
                                       dtype=tdtype, quantize=quantize, device="cpu")
    j = jconvert.convert_hf_checkpoint(jax_dir or hf_dir, jconvert.config_from_hf(hf_cfg),
                                       lora_dir=lora_dir, dtype=jdtype, quantize=quantize)
    return t, j


def assert_same_conversion(t, j) -> None:
    assert dataclasses.asdict(t[0]) == dataclasses.asdict(j[0])
    assert_trees_equal(t[1], jax_leaves(j[1]))
    assert_trees_equal(t[2], None if j[2] is None else jax_leaves(j[2]))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["index", "single", "bin"])
def test_leaves_equal_the_jax_converters(sd, tmp_path, layout, out_dtype):
    hf_dir = write_hf_dir(tmp_path / "hf", sd, hf_config(), layout)
    t, j = convert_both(hf_dir, out_dtype)
    assert_same_conversion(t, j)
    assert t[0].text.qkv_bias and t[1]["vision"] is not None


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_leaves_equal_the_jax_converters(sd, tmp_path, quantize):
    hf_dir = write_hf_dir(tmp_path / "hf", sd, hf_config(), "single")
    t, j = convert_both(hf_dir, "bfloat16", quantize=quantize)
    assert_same_conversion(t, j)
    key = "qw4" if quantize == "int4" else "qw"
    assert t[1]["decoder"]["layers"]["q_proj"][key].dtype == torch.int8
    assert t[1]["lm_head"]["qs"].dtype == torch.bfloat16


def test_bf16_file_is_read_in_bf16_and_equals_the_jax_converter(sd, tmp_path):
    """A bf16 checkpoint (the published one's dtype): the port reads each
    tensor in bf16, a view of the mapped file, with no f32 copy."""
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    hf_dir = write_hf_dir(tmp_path / "hf", bf, hf_config(), "index")
    read = tconvert.load_hf_state_dict(hf_dir)
    assert set(read) == set(bf)
    assert all(read[k].dtype == torch.bfloat16 and torch.equal(read[k], bf[k]) for k in bf)
    for out_dtype in ("bfloat16", "float32"):
        assert_same_conversion(*convert_both(hf_dir, out_dtype))


def test_qkv_bias_is_derived_from_the_keys(sd, tmp_path):
    no_bias = {k: v for k, v in sd.items() if not k.endswith(("q_proj.bias", "k_proj.bias",
                                                                "v_proj.bias")) or "vision" in k}
    hf_dir = write_hf_dir(tmp_path / "hf", no_bias, hf_config(), "single")
    t, j = convert_both(hf_dir, "float32")
    assert not t[0].text.qkv_bias and "q_bias" not in t[1]["decoder"]["layers"]
    assert_same_conversion(t, j)


@pytest.mark.parametrize("hf_cfg", [
    hf_config(),
    {"vocab_size": 1000, "hidden_size": 256, "num_attention_heads": 8, "tie_word_embeddings": True,
     "frame_num_tokens": 16},
    {},
], ids=["tiny", "no_head_dim", "defaults"])
def test_config_from_hf_equals_the_jax_function(hf_cfg):
    assert (dataclasses.asdict(tconvert.config_from_hf(hf_cfg))
            == dataclasses.asdict(jconvert.config_from_hf(hf_cfg)))


# ---------------------------------------------------------------------------
# the PEFT adapter
# ---------------------------------------------------------------------------


def adapter_tensors(with_modules: bool = True) -> dict:
    g = torch.Generator().manual_seed(3)
    sd = {}
    for i in range(2):
        for proj, dout in (("self_attn.q_proj", 64), ("self_attn.v_proj", 32), ("mlp.up_proj", 128)):
            sd[f"base_model.model.model.layers.{i}.{proj}.lora_A.weight"] = torch.randn(R, H, generator=g)
            sd[f"base_model.model.model.layers.{i}.{proj}.lora_B.weight"] = torch.randn(dout, R, generator=g)
    if with_modules:
        mp = "base_model.model.model.mm_projector.modules_to_save.default."
        for name, shape in (("0.weight", (H, VH)), ("0.bias", (H,)), ("2.weight", (H, H)),
                            ("2.bias", (H,))):
            sd[mp + name] = torch.randn(shape, generator=g)
        for head in ("informative_head", "relevance_head"):
            sd[f"base_model.model.{head}.modules_to_save.default.weight"] = torch.randn(2, H, generator=g)
    return sd


def write_adapter(d, asd: dict, config: bool = True) -> str:
    from safetensors.torch import save_file

    os.makedirs(d, exist_ok=True)
    save_file(asd, os.path.join(d, "adapter_model.safetensors"))
    if config:
        with open(os.path.join(d, "adapter_config.json"), "w") as f:
            json.dump({"r": R, "lora_alpha": ALPHA, "peft_type": "LORA"}, f)
    return str(d)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_adapter_is_folded_once_as_the_jax_converter_folds_it(sd, tmp_path, out_dtype):
    hf_dir = write_hf_dir(tmp_path / "hf", sd, hf_config(), "single")
    asd = adapter_tensors()
    adir = write_adapter(tmp_path / "adapter", asd)
    t, j = convert_both(hf_dir, out_dtype, lora_dir=adir)
    assert_same_conversion(t, j)
    lora, params = t[2], t[1]
    assert set(lora) == {"q_proj", "v_proj", "up_proj"}
    # a is raw, b carries alpha/r once (the PEFT scale; 4.0 here)
    dt = lora["q_proj"]["a"].dtype
    raw_a = asd["base_model.model.model.layers.1.self_attn.q_proj.lora_A.weight"]
    raw_b = asd["base_model.model.model.layers.1.self_attn.q_proj.lora_B.weight"]
    assert torch.equal(lora["q_proj"]["a"][1], raw_a.t().to(dt))
    assert torch.equal(lora["q_proj"]["b"][1], (raw_b.t() * (ALPHA / R)).to(dt))
    # modules_to_save replace the base projector and heads
    mp = "base_model.model.model.mm_projector.modules_to_save.default."
    assert torch.equal(params["projector"]["fc1"], asd[mp + "0.weight"].t().to(dt))
    assert torch.equal(params["informative_head"], asd[
        "base_model.model.informative_head.modules_to_save.default.weight"].t().to(dt))
    # and through the CLI: the saved adapter serves at lora_scale 1.0
    out = str(tmp_path / "ckpt")
    tconvert.main(["--hf_dir", hf_dir, "--lora_dir", adir, "--output", out,
                   "--dtype", out_dtype, "--device", "cpu"])
    _, _, saved = tio.load_checkpoint(out, device="cpu")
    assert_trees_equal(saved, lora)


def test_adapter_strict_keys_and_missing_config_raise_as_in_jax(sd, tmp_path):
    from mmduet_tpu.config import Qwen2Config as JQ
    from mmduet_tpu_torch.config import Qwen2Config as TQ

    asd = adapter_tensors()
    asd["base_model.model.lm_head.modules_to_save.default.weight"] = torch.randn(8, 8)
    jcfg = JQ(vocab_size=256, hidden_size=H, intermediate_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16)
    tcfg = TQ(**dataclasses.asdict(jcfg))
    for fn, cfg in ((tconvert.convert_adapter, tcfg), (jconvert.convert_adapter, jcfg)):
        with pytest.raises(ValueError, match="not consumed"):
            fn(asd, cfg)
        with pytest.warns(UserWarning, match="not consumed"):
            lora, overrides = fn(asd, cfg, strict=False)
        assert set(overrides) == {"projector", "informative_head", "relevance_head"}
    hf_dir = write_hf_dir(tmp_path / "hf", sd, hf_config(), "single")
    adir = write_adapter(tmp_path / "adapter", adapter_tensors(), config=False)
    for main, extra in ((tconvert.main, ["--device", "cpu"]), (jconvert.main, [])):
        with pytest.raises(FileNotFoundError, match="adapter_config"):
            main(["--hf_dir", hf_dir, "--lora_dir", adir,
                  "--output", str(tmp_path / "bad")] + extra)


# ---------------------------------------------------------------------------
# the reader and the writer
# ---------------------------------------------------------------------------


def test_reader_equals_the_safetensors_package(tmp_path):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(5)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 127, (9,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = _read_safetensors(path), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    for k, arr in safetensors_numpy.load_file(str(_without_bf16(tmp_path, tensors))).items():
        np.testing.assert_array_equal(got[k].numpy(), arr)
    got["f32"].add_(1.0)  # a private map: the file is not written
    assert torch.equal(_read_safetensors(path)["f32"], want["f32"])


def _without_bf16(tmp_path, tensors):
    from safetensors.torch import save_file

    path = tmp_path / "np.safetensors"
    save_file({k: v for k, v in tensors.items() if v.dtype != torch.bfloat16}, str(path))
    return path


@pytest.mark.parametrize("fault", ["dtype", "truncated"])
def test_reader_refuses_what_it_cannot_read(tmp_path, fault):
    from safetensors.torch import save_file

    path = str(tmp_path / "bad.safetensors")
    save_file({"a": torch.zeros(4, 4, dtype=torch.float64 if fault == "dtype" else torch.float32)},
              path)
    if fault == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="does not take" if fault == "dtype" else "data_offsets"):
        _read_safetensors(path)


def test_chip_smoke_writer_is_read_back_by_the_package(sd, tmp_path):
    """`chip_smoke.write_safetensors` (the GPU machine has no safetensors
    package) gives files the package reads back exactly, and
    `chip_smoke.write_hf_dir` of a tree gives a directory that both
    converters turn back into that tree."""
    from safetensors.torch import load_file

    from mmduet_tpu_torch.config import tiny_config
    from mmduet_tpu_torch.models import init_mmduet_params

    mixed = {"a": torch.randn(3, 5).bfloat16(), "b": torch.randint(-5, 5, (7,), dtype=torch.int8),
             "c": torch.randn(4).half(), "d": torch.randn(2, 3).t(), "e": torch.arange(6, dtype=torch.int32)}
    path = str(tmp_path / "w.safetensors")
    n = chip_smoke.write_safetensors(path, mixed)
    assert n == os.path.getsize(path)
    back = load_file(path)
    for k, v in mixed.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    cfg = tiny_config()
    params = init_mmduet_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    for path_ in (("informative_head",), ("decoder", "layers", "q_bias")):  # nonzero leaves
        tree = params
        for k in path_[:-1]:
            tree = tree[k]
        tree[path_[-1]] = torch.randn(tree[path_[-1]].shape, generator=g).bfloat16()
    hf_dir = str(tmp_path / "hf")
    chip_smoke.write_hf_dir(hf_dir, params, cfg)
    t, j = convert_both(hf_dir, "bfloat16")
    assert_same_conversion(t, j)
    assert_trees_equal(t[1], params)
    assert dataclasses.asdict(t[0]) == dataclasses.asdict(
        cfg.replace(v_placeholder_id=cfg.text.vocab_size))


# ---------------------------------------------------------------------------
# the rows of the inference CLI on the converted checkpoint
# ---------------------------------------------------------------------------


def video_dataset(d) -> list:
    """Two 3-second mp4s and an eval file with a query each."""
    vids = d / "videos"
    vids.mkdir(parents=True)
    r = np.random.RandomState(0)
    for name in ("a.mp4", "b.mp4"):
        w = cv2.VideoWriter(str(vids / name), cv2.VideoWriter_fourcc(*"mp4v"), 10, (36, 28))
        for _ in range(30):
            w.write(r.randint(0, 255, (28, 36, 3), np.uint8))
        w.release()
    anno = [{"question_id": f"q{i}", "video": name,
             "conversation": [{"role": "user", "content": "what moves?", "time": t}]}
            for i, (name, t) in enumerate((("a.mp4", 0), ("b.mp4", 1.0)))]
    (d / "eval.json").write_text(json.dumps(anno))
    return ["--input_dir", str(vids), "--test_fname", str(d / "eval.json"), "--frame_fps", "2",
            "--max_num_frames", "6", "--max_new_tokens", "4", "--no_prefetch"]


def assert_same_rows(got: list, want: list) -> None:
    """Rows of the two CLIs: equal keys, responses and times; debug scores
    (written rounded to 3 decimals) within one rounding step."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if "debug_data" in w:
            assert g["model_response_list"] == w["model_response_list"]
            assert [d["time"] for d in g["debug_data"]] == [d["time"] for d in w["debug_data"]]
            for key in ("informative_score", "relevance_score"):
                np.testing.assert_allclose([d[key] for d in g["debug_data"]],
                                           [d[key] for d in w["debug_data"]], atol=1e-3 + 1e-9)
        else:
            assert g == w


@pytest.mark.parametrize("mode", ["generation", "offline_baseline"])
def test_cli_rows_on_the_converted_checkpoint_equal_the_jax_clis(sd, tmp_path, mode):
    from mmduet_tpu.eval.inference import main as jax_main
    from mmduet_tpu_torch.eval.inference import main as torch_main

    tok = build_qwen2_style_tokenizer()
    vocab = len(tok) + 8
    hf_dir = write_hf_dir(tmp_path / "hf", hf_tensors(vocab), hf_config(vocab, tok.eos_token_id),
                          "index", tokenizer=tok)
    tconvert.main(["--hf_dir", hf_dir, "--output", str(tmp_path / "t"), "--dtype", "float32",
                   "--device", "cpu"])
    jconvert.main(["--hf_dir", hf_dir, "--output", str(tmp_path / "j"), "--dtype", "float32"])
    assert os.path.exists(tmp_path / "t" / "tokenizer.json")
    common = video_dataset(tmp_path / "data")
    common += (["--stream_end_prob_threshold", "0.3"] if mode == "generation"
               else ["--is_online_model", "false"])
    jax_main(common + ["--checkpoint", str(tmp_path / "j"), "--output_fname", str(tmp_path / "j.jsonl")])
    torch_main(common + ["--checkpoint", str(tmp_path / "t"), "--output_fname",
                         str(tmp_path / "t.jsonl"), "--device", "cpu"])
    rows = [[json.loads(line) for line in open(tmp_path / f"{s}.jsonl")] for s in "tj"]
    if mode == "offline_baseline":
        assert set(rows[0][0]) == {"question_id", "model_response", "question", "video_duration"}
    assert_same_rows(*rows)


# ---------------------------------------------------------------------------
# load_checkpoint's device
# ---------------------------------------------------------------------------


def test_load_checkpoint_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    """With no ``device`` the checkpoint loads onto the current CUDA
    device; with none it raises, and the CPU is taken only when named."""
    from mmduet_tpu_torch.config import tiny_config
    from mmduet_tpu_torch.models import init_mmduet_params

    cfg = tiny_config()
    params = init_mmduet_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tio.save_checkpoint(str(tmp_path), cfg, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_checkpoint(str(tmp_path))
    _, loaded, _ = tio.load_checkpoint(str(tmp_path), device="cpu")
    assert loaded["decoder"]["final_norm"].device == torch.device("cpu")
