"""The decoder architecture and the reference found by name: the committed
configurations' weights and reference outputs as they were before the
dispatch (pinned from the harness that built them directly), and a second
architecture added as files alone under a temporary root, served on the
CPU and judged by its own reference."""

import copy
import hashlib
import json
import time

import pytest
import torch

from benchmark import harness, spec as specs, traffic
from benchmark.reference.template import answer_prompt_ids, query_ids
from benchmark.tests import tiny
from benchmark.tests.conftest import ROOT

SEED = 2 ** 31 + 389

# sha256 of the served weight tree of the tiny configuration (bf16) and of
# its quantized form (w4kv8) from seed 0, by `digest`
DIGESTS = {
    "bf16": "45796294682d21d17e565e20e4f24903c1e8f8b53c3e6db671db5cc856eabbac",
    "w4kv8": "d8ed5e8a54fbf402346705f913f5d4eacdb697b477a679ba7dc52fa4eb12e2a6",
}
# the reference's score-head probabilities at five frames and an answer's
# logits (each row's largest and its token) in the served and the control
# precision, on the stream of `test_reference_outputs_are_unchanged`
OUTPUTS = {
    ("bf16", "served"): (
        [[0.27297720313072205, 0.44917017221450806], [0.2534562349319458, 0.38457411527633667],
         [0.501451849937439, 0.5815571546554565], [0.34221789240837097, 0.39927762746810913],
         [0.561700165271759, 0.38895323872566223]],
        [2.9844837188720703, 3.472198486328125, 2.9300858974456787, 3.2357177734375],
        [141, 473, 181, 151]),
    ("bf16", "control"): (
        [[0.2038928121328354, 0.4274955093860626], [0.2040569931268692, 0.36473506689071655],
         [0.3880293369293213, 0.51984703540802], [0.28313320875167847, 0.3316362202167511],
         [0.44517332315444946, 0.3216807544231415]],
        [2.9836390018463135, 3.490664005279541, 2.998847246170044, 3.1067910194396973],
        [388, 473, 181, 151]),
    ("w4kv8", "served"): (
        [[0.32442906498908997, 0.2738497257232666], [0.3525444269180298, 0.4306003153324127],
         [0.5249221324920654, 0.6088502407073975], [0.3339201807975769, 0.37416836619377136],
         [0.5907576084136963, 0.4530550241470337]],
        [3.085031032562256, 3.236145496368408, 3.473975896835327, 3.028409719467163],
        [141, 226, 412, 133]),
    ("w4kv8", "control"): (
        [[0.1774301379919052, 0.2613072693347931], [0.1777035892009735, 0.4183478355407715],
         [0.36318570375442505, 0.5969476699829102], [0.2172386199235916, 0.29311689734458923],
         [0.3794965445995331, 0.39266249537467957]],
        [2.8136401176452637, 3.3391032218933105, 3.2173264026641846, 3.2507152557373047],
        [388, 226, 412, 133]),
}


def digest(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, in sorted
    path order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, torch.Tensor):
            h.update(repr((path, str(node.dtype), tuple(node.shape))).encode())
            h.update(node.contiguous().view(torch.uint8).numpy().tobytes() if node.numel()
                     else b"")
        else:
            h.update(repr((path, node)).encode())

    walk(tree, ())
    return h.hexdigest()


def _tiny(kind):
    cfg = copy.deepcopy(tiny.CONFIG)
    if kind == "w4kv8":
        cfg["serving"].update(weight_bits=4, group_size=128, kv_cache_quant="int8")
    arch = specs.architecture(cfg)
    return cfg, arch, arch.shapes(cfg)


def test_the_committed_configurations_find_their_files():
    spec = specs.load()
    for c in spec["configs"]:
        cfg = specs.config_of(spec, c["name"])
        assert specs.arch_file(cfg) == ROOT / "benchmark" / "arch" / "LlavaQwenForCausalLM.py"
        assert specs.reference_file(cfg) == ROOT / "benchmark" / "reference" / "model.py"


@pytest.mark.parametrize("kind", ["bf16", "w4kv8"])
def test_served_weights_are_bit_identical(kind):
    _, arch, s = _tiny(kind)
    _, params, _ = harness.build(arch, s, "cpu")
    assert digest(params) == DIGESTS[kind]
    made = harness.weights.make(arch.leaves(s), s.weights_seed, "cpu")
    assert digest(made) == DIGESTS["bf16"]


@pytest.mark.parametrize("precision", ["served", "control"])
@pytest.mark.parametrize("kind", ["bf16", "w4kv8"])
def test_reference_outputs_are_unchanged(kind, precision):
    """Five frames of the tiny mix's first video after a query, and one
    answer branching after the third frame, through the configuration's
    reference."""
    cfg, arch, s = _tiny(kind)
    ref = specs.reference(cfg)
    w = harness.weights.make(arch.leaves(s), s.weights_seed, "cpu")
    pixels = torch.from_numpy(traffic.pixel_pool(tiny.MIX, "cpu")[0, :5].copy())
    q, prompt, ft = query_ids("Describe the steps."), answer_prompt_ids(), s.frame_tokens
    branches = [ref.Branch(len(q) + 3 * ft, prompt + [65, 66, 67], len(prompt) - 1)]
    rows = torch.tensor([len(q) + (j + 1) * ft - 1 for j in range(5)])
    p = getattr(ref, precision)(s)
    ref.no_tf32()
    with torch.no_grad():
        frames = ref.frame_embeds(w, s, p, pixels)
        stream = torch.cat([ref.embed_rows(w, s, p, q, "cpu"),
                            frames.reshape(-1, frames.shape[-1])])
        probs, logits = ref.decoder(w, s, p, stream, branches, rows)
    want_probs, want_max, want_argmax = OUTPUTS[kind, precision]
    torch.testing.assert_close(probs, torch.tensor(want_probs), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(logits[0].max(-1).values, torch.tensor(want_max), rtol=1e-5,
                               atol=1e-6)
    assert logits[0].argmax(-1).tolist() == want_argmax


# a test's architecture: Qwen2's layout without q/k/v biases, which the port
# serves through `Qwen2Config.qkv_bias=False`, reusing the committed file
NO_BIAS_ARCH = '''"""Qwen2's layout without q/k/v biases (a test's architecture)."""
import dataclasses
from pathlib import Path

from benchmark import spec

_qwen = spec.load_module(Path(__file__).with_name("LlavaQwenForCausalLM.py"),
                         "benchmark_arch_qwen_for_no_bias")
DECODER_KEYS, Shapes, port_config = _qwen.DECODER_KEYS, _qwen.Shapes, _qwen.port_config
chunk, lm_head_row = _qwen.chunk, _qwen.lm_head_row
score_heads_frame, vision_frame = _qwen.score_heads_frame, _qwen.vision_frame


def shapes(cfg):
    return dataclasses.replace(_qwen.shapes(cfg), qkv_bias=False)


def leaves(s):
    quantized, rest = _qwen.leaves(s)
    return quantized, [leaf for leaf in rest if leaf[0] not in (
        ("decoder", "layers", "q_bias"), ("decoder", "layers", "k_bias"),
        ("decoder", "layers", "v_bias"))]
'''

# its reference: the Qwen2 reference with every q/k/v bias ``SCALE`` x
# N(0, 1): 0, none; 0.1, biases this layout lacks. (At the benchmark's own
# bias scale, 0.02, the tiny run reads a score gap of 0.0195-0.0245 against
# its limit of 0.02: that small a bias is at the edge of what the tiny
# limits see.)
NO_BIAS_REFERENCE = '''"""The Qwen2 reference of a layout without q/k/v biases (a test's)."""
from pathlib import Path

import torch

from benchmark import spec

SCALE = {scale}
_base = spec.load_module(Path(__file__).with_name("model.py"),
                         "benchmark_reference_qwen_for_no_bias")
no_tf32, served, control, Branch = _base.no_tf32, _base.served, _base.control, _base.Branch
frame_embeds, embed_rows, decoder = _base.frame_embeds, _base.embed_rows, _base.decoder
_qwen_layer = _base._layer_weights


def _layer_weights(w, s, p, i):
    gen = torch.Generator().manual_seed(1)
    lay = dict(w["decoder"]["layers"])
    for n, dim in (("q_bias", s.q_dim), ("k_bias", s.kv_dim), ("v_bias", s.kv_dim)):
        lay[n] = SCALE * torch.randn(s.layers, dim, generator=gen)
    return _qwen_layer(dict(w, decoder=dict(w["decoder"], layers=lay)), s, p, i)


_base._layer_weights = _layer_weights
'''


@pytest.mark.parametrize("scale, correct", [(0.0, True), (0.1, False)],
                         ids=["own-reference", "reference-with-bias"])
def test_a_second_architecture_is_added_as_files(tmp_path, scale, correct):
    name = "QwenNoBiasForCausalLM"
    cfg = dict(copy.deepcopy(tiny.CONFIG), name="tiny-nobias", architectures=[name],
               reference="benchmark/reference/nobias.py")
    files = {f"benchmark/arch/{name}.py": NO_BIAS_ARCH,
             "benchmark/reference/nobias.py": NO_BIAS_REFERENCE.format(scale=scale)}
    root, spec, cell = tiny.make_root(tmp_path, config=cfg, files=files)
    arch = specs.architecture(cfg, root)
    s = arch.shapes(cfg)
    assert not arch.port_config(s).text.qkv_bias
    assert not any(path[-1] in ("q_bias", "k_bias", "v_bias") and path[0] == "decoder"
                   for group in arch.leaves(s) for path, _, _ in group)
    r = harness.run_cell(spec, cell, SEED, 2.0, False, "cpu", time.perf_counter(), root)
    assert r["correct"] is correct, json.dumps(r["checks"])
