"""K2 on the CPU: the tile and split-K plan of ``csrc/geglu_ff_sm90.cu``,
and a torch emulation of what the kernel computes under that plan.

``geglu_plan`` decides, for each of K2's two GEMMs, the output tiles (128
rows by ``bn`` columns; GEMM1 with as many gate columns beside) and the runs
of 64-deep k-steps each work unit sums; the card runs exactly that plan.
Here the plan must cover every output row and column once and every k-step
in exactly one split, at the plan's counts and at forced ones, and an
emulation of the kernel's arithmetic (f32 partials over each split's
k-steps, the splits summed in split order, the bias added in f32, the
GEGLU in f32, the hidden rounded to the input dtype) must agree with the
JAX package's Pallas kernel in interpret mode and with the port's plain
twin.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu.ops.mlp import _ff_pallas
from complex_prompt_diffusion_tpu_torch.ops import mlp as K2
from complex_prompt_diffusion_tpu_torch.ops.mlp import (
    _forced_plan,
    geglu_ff,
    geglu_ff_plain,
    geglu_plan,
)

BK = 64
BM = {1: 128, 2: 128}  # rows a work unit of GEMM1 and GEMM2

# the eight (M, C) of the SD-1.5 512x512 render: every transformer level at
# UNet batch 8 (batch 4 with CFG), then at UNet batch 2 (batch 1)
SD_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280),
             (8192, 320), (2048, 640), (512, 1280), (128, 1280)]
RAGGED = [(1, 320), (77, 320), (200, 640), (4097, 320), (130, 1280), (3, 32)]

# bf16: both sides round the same f32 sums to bf16 (the hidden, then the
# output), so they differ by a bf16 step (2^-8 relative) where a sum
# straddles a rounding edge, carried through the second product: 2e-2 of
# max |out|. f32: sums of C and 4C products in another order, ~1e-5.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _coverage(m, n, g, bm):
    rows = np.zeros(m, np.int64)
    cols = np.zeros(n, np.int64)
    for mt in range(g.m_tiles):
        rows[mt * bm:(mt + 1) * bm] += 1  # numpy clips at the edge
    for nt in range(g.n_tiles):
        cols[nt * g.bn:(nt + 1) * g.bn] += 1
    steps = np.zeros(g.ksteps, np.int64)
    for s in range(g.splits):
        for t in g.k_range(s):
            steps[t] += 1
    return rows, cols, steps


@pytest.mark.parametrize("m,c", SD_SHAPES + RAGGED)
def test_plan_covers_every_output_and_k_step_once(m, c):
    h4 = 4 * c
    plan = geglu_plan(m, c, h4)
    for g, n, k, widths, bm in ((plan.gemm1, h4, c, K2.GEGLU1_WIDTHS, BM[1]),
                                (plan.gemm2, c, h4, K2.GEGLU2_WIDTHS, BM[2])):
        assert g.bn in widths and g.ksteps == -(-k // BK)
        assert g.m_tiles * bm >= m > (g.m_tiles - 1) * bm
        assert all(len(g.k_range(s)) > 0 for s in range(g.splits))
        rows, cols, steps = _coverage(m, n, g, bm)
        assert (rows == 1).all() and (cols == 1).all() and (steps == 1).all()
    assert plan.launches == 2 + (plan.gemm1.splits > 1) + (plan.gemm2.splits > 1)


@pytest.mark.parametrize("m,c", [(2048, 1280), (128, 1280), (77, 320)])
def test_every_forced_split_count_covers_each_k_step_once(m, c):
    h4 = 4 * c
    k1, k2 = -(-c // BK), -(-h4 // BK)
    for s in range(1, max(k1, k2) + 1):
        plan = _forced_plan(m, c, h4, splits1=min(s, k1), splits2=min(s, k2))
        for g, bm in zip(plan, (BM[1], BM[2])):
            _, _, steps = _coverage(m, 1, g, bm)
            assert (steps == 1).all() and g.splits <= s
            assert all(len(g.k_range(i)) > 0 for i in range(g.splits))


def test_plan_is_the_same_on_every_call():
    first = [geglu_plan(m, c, 4 * c) for m, c in SD_SHAPES]
    assert [geglu_plan(m, c, 4 * c) for m, c in SD_SHAPES] == first
    assert geglu_plan(512, 1280, 5120) is geglu_plan(512, 1280, 5120)  # cached
    geglu_plan.cache_clear()
    assert [geglu_plan(m, c, 4 * c) for m, c in SD_SHAPES] == first


def test_small_grids_split_k():
    """Where the tiles leave most of the 132 SMs idle, the plan splits K."""
    plan = geglu_plan(128, 1280, 5120)
    units2 = plan.gemm2.m_tiles * plan.gemm2.n_tiles
    assert units2 < 132 and plan.gemm2.splits > 1
    big = geglu_plan(32768, 320, 1280)
    assert big.gemm1.splits == big.gemm2.splits == 1


def test_plan_rejects_what_k2_does_not_take():
    with pytest.raises(ValueError):
        geglu_plan(16, 36, 144)  # C % 8
    with pytest.raises(ValueError):
        geglu_plan(0, 320, 1280)
    with pytest.raises(ValueError):
        _forced_plan(16, 320, 1280, bn1=96)
    with pytest.raises(ValueError):
        _forced_plan(16, 320, 1280, splits2=21)  # 1280 / 64 = 20 k-steps


def _emulate(x, w1, b1, w2, b2, plan):
    """The kernel's arithmetic under ``plan``, in torch on the CPU."""
    dt = x.dtype
    m, c = x.shape
    h4 = w2.shape[0]

    def gemm(a, b, g):
        parts = []
        for s in range(g.splits):
            ks = g.k_range(s)
            lo, hi = ks.start * BK, min(ks.stop * BK, a.shape[1])
            parts.append(a[:, lo:hi].float() @ b[lo:hi].float())
        acc = parts[0]
        for p in parts[1:]:  # split order
            acc = acc + p
        return acc

    v = gemm(x, w1[:, :h4], plan.gemm1) + b1[:h4].float()
    z = gemm(x, w1[:, h4:], plan.gemm1) + b1[h4:].float()
    hidden = (v * F.gelu(z)).to(dt)
    return (gemm(hidden, w2, plan.gemm2) + b2.float()).to(dt)


def _inputs(m, c, dtype, seed):
    rng = np.random.default_rng(seed)
    h4 = 4 * c
    arrs = (rng.standard_normal((m, c)), rng.uniform(-c**-0.5, c**-0.5, (c, 2 * h4)),
            rng.uniform(-0.1, 0.1, 2 * h4), rng.uniform(-h4**-0.5, h4**-0.5, (h4, c)),
            rng.uniform(-0.1, 0.1, c))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrs]


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_emulation_matches_pallas_ff_kernel_in_bf16(c):
    m = 48
    args = _inputs(m, c, torch.bfloat16, c)
    plan = _forced_plan(m, c, 4 * c, splits1=3, splits2=4)
    got = _emulate(*args, plan)
    jargs = [np.asarray(a.float().numpy()) for a in args]
    import jax.numpy as jnp

    want = _ff_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in jargs), block_m=16,
                      block_j=4 * c, interpret=True)
    assert _rel(got, torch.from_numpy(np.array(want, np.float32))) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("m,c", RAGGED[:4])
def test_emulation_at_every_split_matches_the_plain_twin_in_f32(m, c):
    args = _inputs(m, c, torch.float32, m + c)
    want = geglu_ff_plain(*args)
    k1, k2 = -(-c // BK), -(-4 * c // BK)
    for s in (1, 2, 3, 7):
        plan = _forced_plan(m, c, 4 * c, splits1=min(s, k1), splits2=min(s, k2))
        assert _rel(_emulate(*args, plan), want) <= TOL[torch.float32]


def test_cpu_wrapper_takes_the_plain_twin_and_counts_no_launch():
    args = _inputs(10, 64, torch.float32, 0)
    before = geglu_ff.launches
    torch.testing.assert_close(geglu_ff(*args), geglu_ff_plain(*args))
    assert geglu_ff.launches == before
