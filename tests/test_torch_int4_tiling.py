"""How kernel B cuts its work, emulated on the CPU against the JAX package.

`ops/quant_matmul.py::int4_plan` gives the cut that `csrc/int4_matmul.cu`
launches: the GEMV's 256-column blocks over a range of groups (R <= 4), or
the tensor cores' tiles of 64 or 104 rows by 192 columns over a range of
k-steps of max(g, 64) values, with rows and columns past the operands'
ends read as zeros. Per group a fresh f32 sum is multiplied by the group's scale and
added to the block's total; a tile whose steps are split over ``ks``
blocks adds their partials in split order. `emulate` does that in f32 with
torch, and is held to 2e-5 (absolute) against the JAX package's
`int4_matmul` in interpret mode and against `int4_matmul_ref`: the two sum
the same exact f32 products in other orders, well inside that."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmduet_tpu.models import quant as jquant
from mmduet_tpu.ops.quant_matmul import int4_matmul as pallas_int4_matmul
from mmduet_tpu_torch.ops import quant_matmul as tqm

ATOL = 2e-5
ROWS = (1, 4, 5, 64, 127, 128, 129, 392)
COLS = (48, 272, 512)
# H per group size: whole groups, and for g < 64 a last step of the
# tensor cores that holds fewer than 64 / g groups
H_OF = {16: 208, 32: 224, 64: 320, 128: 640}


def emulate(y: torch.Tensor, qw4: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Kernel B's arithmetic, block by block, as `int4_plan` cuts it."""
    R, H = y.shape
    G, g2, O = qw4.shape
    g = 2 * g2
    plan = tqm.int4_plan(R, H, O, g)
    q = tqm.unpack_groups(qw4).float()   # (G, g, O)
    s = qs.float()[:, 0]                  # (G, O)
    rows = -(-R // plan.rows) * plan.rows
    cols = plan.grid[0] * plan.cols
    yp = torch.zeros((rows, plan.units * plan.step))  # zeros past R and H
    yp[:R, :H] = y.float()
    qp = torch.zeros((G, g, cols))                     # zeros past O
    qp[..., :O] = q
    sp = torch.zeros((G, cols))
    sp[:, :O] = s
    per_step = plan.step // g                          # groups of a step
    out = torch.zeros((rows, cols))
    for r0 in range(0, rows, plan.rows):
        for c0 in range(0, cols, plan.cols):
            tile = slice(c0, c0 + plan.cols)
            partials = []
            for split in range(plan.ks):
                total = torch.zeros((plan.rows, plan.cols))
                for step in range(split * plan.per, min(plan.units, (split + 1) * plan.per)):
                    for gi in range(step * per_step, min(G, (step + 1) * per_step)):
                        acc = yp[r0:r0 + plan.rows, gi * g:(gi + 1) * g] @ qp[gi][:, tile]
                        total = total + acc * sp[gi, tile]
                partials.append(total)
            summed = partials[0]
            for p in partials[1:]:
                summed = summed + p
            out[r0:r0 + plan.rows, tile] = summed
    return out[:R, :O]


@functools.lru_cache(maxsize=None)
def _operands(O: int, g: int, H: int, R_max: int = max(ROWS)):
    """numpy-seeded weights quantized by the JAX package (and the same
    leaf as torch tensors), activations, and the JAX kernel's product in
    interpret mode at the most rows (rows are independent: a smaller R is
    its first rows)."""
    rng = np.random.RandomState(O * 1000 + g + H)
    w = (rng.randn(H, O) * 0.05).astype(np.float32)
    y = (rng.randn(R_max, H) * 0.3).astype(np.float32)
    qd = jquant.quantize_weight_int4(w, 0, g)
    want = np.asarray(pallas_int4_matmul(jnp.asarray(y), qd["qw4"], qd["qs"], interpret=True))
    qw4 = torch.tensor(np.asarray(qd["qw4"]))
    qs = torch.tensor(np.asarray(qd["qs"]).astype(np.float32))
    return torch.tensor(y), qw4, qs, want


@pytest.mark.parametrize("g", sorted(H_OF))
@pytest.mark.parametrize("O", COLS)
@pytest.mark.parametrize("R", ROWS)
def test_cut_matches_jax_and_plain(R, O, g):
    y, qw4, qs, want = _operands(O, g, H_OF[g])
    got = emulate(y[:R], qw4, qs)
    np.testing.assert_allclose(got.numpy(), want[:R], rtol=0, atol=ATOL)
    ref = tqm.int4_matmul_ref(y[:R], qw4, qs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=ATOL)


# steps split over blocks of several steps each (every group size), and
# unsplit tiles
@pytest.mark.parametrize("R,H,O,g,ks", [
    (392, 2048, 512, 64, 4),     # 32 steps, 8 a block
    (53, 8192, 512, 128, 8),     # 64 steps, 8 a block
    (53, 4096, 272, 16, 8),      # 64 steps of 4 groups, 8 a block
    (70, 1024, 48, 32, 4),       # 16 steps of 2 groups, 4 a block
    (2, 4096, 272, 128, 32),     # GEMV: 32 groups, one a block
    (129, 256, 4352, 16, 1),     # 46 tiles: no split
    (3, 128, 512, 128, 1),       # GEMV: one group, no split
])
def test_cut_with_other_splits(R, H, O, g, ks):
    assert tqm.int4_plan(R, H, O, g).ks == ks
    y, qw4, qs, want = _operands(O, g, H, R_max=R)
    got = emulate(y, qw4, qs)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# (R, H, O) -> (path, ks, grid) at the 7B decoder's and LM head's widths
SERVING_PLANS = {
    (1, 3584, 3584): ("gemv", 28, (14, 1, 28)),
    (1, 3584, 512): ("gemv", 28, (2, 1, 28)),
    (1, 3584, 18944): ("gemv", 7, (74, 1, 7)),
    (1, 18944, 3584): ("gemv", 37, (14, 1, 37)),
    (1, 3584, 152064): ("gemv", 1, (594, 1, 1)),
    (392, 3584, 3584): ("wgmma", 1, (19, 4, 1)),
    (392, 3584, 512): ("wgmma", 4, (3, 4, 4)),
    (392, 3584, 18944): ("wgmma", 1, (99, 4, 1)),      # 396 blocks: 3 whole waves
    (392, 18944, 3584): ("wgmma", 5, (19, 4, 5)),
    (392, 3584, 152064): ("wgmma", 1, (792, 4, 1)),
    (1568, 3584, 3584): ("wgmma", 1, (19, 16, 1)),
    (1568, 3584, 512): ("wgmma", 2, (3, 16, 2)),
    (1568, 3584, 18944): ("wgmma", 1, (99, 16, 1)),    # 12 whole waves
    (1568, 18944, 3584): ("wgmma", 3, (19, 16, 3)),
    (1568, 3584, 152064): ("wgmma", 1, (792, 16, 1)),
}


@pytest.mark.parametrize("shape", sorted(SERVING_PLANS))
def test_plan_of_the_serving_shapes(shape):
    plan = tqm.int4_plan(*shape, 128)
    assert (plan.path, plan.ks, plan.grid) == SERVING_PLANS[shape]
    assert plan.per * (plan.ks - 1) < plan.units <= plan.per * plan.ks
