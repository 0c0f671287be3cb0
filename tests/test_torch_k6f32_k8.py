"""K6's f32 Hopper body and K8 on K3's Hopper forms, on the CPU.

K6 (the Winograd conv probe) routes f32 convs with C % 4 == 0 (any Co) to a
3xTF32 wgmma body (``csrc/winograd_f32_sm90.cu``) under the plan
``wino3x3_plan(..., dtype=float32)``. Here: the route rule at every width
and dtype; the plan's coverage (every tile in one block, every input
channel in one split); a torch emulation of what the body computes under
that plan (the patch of each 32-channel chunk zero-filled outside the
plane and past C, U's rows past C and columns past Co zero, V = B^T d B
rows first, each position's product over the chunk
folded into the four output sums, the splits summed in split order, the
bias added in f32) and the f32 twin, both against the JAX package's Pallas
kernel in interpret mode.

K8 (the GroupNorm probe) runs K3's slab or split form, as ``probe_plan``
says: K3's plan, or with forced splits S K3's split tiles each streaming its
share of S runs of the sample in turn, one launch less for the copy mode's
split form. Here: that mapping as a pure function, a transcription of the
kernels' run walk (every pixel once, the partials' counts, the statistics
merged from them equal to the twin's), the
ValueErrors for the shapes and flags it refuses (each mode's twin against
the TPU scripts' own kernels at shapes where K3's plan picks each form is in
``tests/test_torch_probes.py``). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu.ops.probes import winograd as JW
from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G
from complex_prompt_diffusion_tpu_torch.ops.probes import groupnorm as PG
from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as W
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS
from complex_prompt_diffusion_tpu_torch.tools.probe_groupnorm import (
    GN4_PLANES,
    GN5_PLANES,
    GN6_PLANES,
)

bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16

# f32: the same products summed in another order than the Pallas kernel's,
# and V combined rows first where the twin combines columns first: ~1e-6,
# held to the f32 bodies' 1e-5 (max |a - b| / max |b|)
F32_TOL = 1e-5
BF16_TOL = 2e-2  # the probes' outputs in bf16
SMS = 132


# ---- K6: the f32 route and plan ----

@pytest.mark.parametrize("c", [8, 20, 24, 32, 64, 96, 224, 320, 640, 672, 1280, 2560, 18])
@pytest.mark.parametrize("co", [4, 8, 64, 96, 128, 640, 672, 1280, 9])
def test_k6_body_by_dtype_and_width(c, co):
    assert W.k6_body(bf16, c, co) == ("bf16_sm90" if c % 8 == 0 else "prior")
    assert W.k6_body(f32, c, co) == ("f32_sm90" if c % 4 == 0 else "prior")
    with pytest.raises(TypeError):
        W.k6_body(f16, c, co)


def test_k6_f32_body_takes_every_resblock_conv_of_phase_9():
    for hw, c, co in B1_UNET_CONVS:
        assert W.k6_body(f32, c, co) == "f32_sm90"
    assert W.k6_body(f32, 512, 512) == "f32_sm90"  # phase 1's B1 32^2 512->512
    # no narrow carve-out: a probe, it takes every C % 4 (one partly zero chunk)
    assert W.k6_body(f32, 4, 320) == W.k6_body(f32, 320, 4) == "f32_sm90"
    assert W.k6_body(f32, 6, 320) == "prior"


_F32_PLANES = [(2, hw, hw, c, co) for hw, c, co in B1_UNET_CONVS]
_F32_PLANES += [(1, 32, 32, 512, 512), (1, 8, 8, 32, 64), (3, 10, 14, 128, 64),
                (1, 20, 12, 64, 192), (2, 64, 64, 320, 320)]
# CompVis LDM-VQ-4's widths (224 .. 896, 672 == 0 mod 32 and 224 too) and
# widths off the 32-channel chunk: the last chunk partly past C
_F32_PLANES += [(1, 16, 16, 224, 672), (1, 32, 32, 672, 448), (2, 8, 8, 40, 72),
                (1, 8, 8, 20, 9), (2, 16, 16, 100, 200)]


@pytest.mark.parametrize("b,h,w,c,co", _F32_PLANES)
def test_wino3x3_f32_plan_covers_every_tile_and_channel_once(b, h, w, c, co):
    plan = W.wino3x3_plan(b, h, w, c, co, dtype=f32)
    assert plan is W.wino3x3_plan(b, h, w, c, co, dtype=f32)  # cached
    assert plan.kc == W.F32_KC == 32 and plan.kchunks == -(-c // 32)
    assert plan.tw * plan.th == W.SM90_BT and plan.tw in (4, 8, 16)
    hits = {}
    for block in range(plan.m_blocks):
        for t in plan.tiles(block):
            if t[1] < h // 2 and t[2] < w // 2:
                hits[t] = hits.get(t, 0) + 1
    assert len(hits) == b * (h // 2) * (w // 2) and set(hits.values()) == {1}
    assert plan.n_blocks * W.SM90_BN >= co > (plan.n_blocks - 1) * W.SM90_BN
    for splits in sorted({None, 1, 2, 5, plan.kchunks} - {None}) + [None]:
        if splits is not None and splits > plan.kchunks:
            continue
        p = W.wino3x3_plan(b, h, w, c, co, splits, f32)
        ranges = [p.c_range(s) for s in range(p.splits)]
        assert all(len(r) > 0 and len(r) % 32 == 0 for r in ranges)
        # once each, in split order; the last chunk's channels past C are TMA's zeros
        assert [ch for r in ranges for ch in r] == list(range(32 * p.kchunks))
        assert p.launches == (1 if p.splits == 1 else 2)
        assert 1 <= p.splits <= min(16 if splits is None else splits, p.kchunks)
    # the f32 patch box of a block fits the kernel's buffer: 34 x 10 pixels of 32 f32
    assert (2 * plan.tw + 2) * (2 * plan.th + 2) * 32 * 4 <= 34 * 10 * 128


def test_wino3x3_f32_plan_refuses_what_the_body_does_not_take():
    for args in ((2, 16, 16, 50, 128), (2, 16, 16, 64, 0), (2, 6, 16, 64, 64)):
        with pytest.raises(ValueError):
            W.wino3x3_plan(*args, dtype=f32)
    with pytest.raises(ValueError):  # 2 chunks of 32 channels
        W.wino3x3_plan(2, 16, 16, 64, 64, splits=3, dtype=f32)
    # 96 channels: the f32 body's 3 chunks, the bf16 body's 2 (the last half zeros)
    assert W.wino3x3_plan(2, 16, 16, 96, 64, dtype=f32).kchunks == 3
    assert W.wino3x3_plan(2, 16, 16, 96, 64).kchunks == 2
    # 36 channels: f32 takes it (C % 4 == 0), bf16 does not (C % 8 != 0)
    assert W.wino3x3_plan(2, 16, 16, 36, 64, dtype=f32).kchunks == 2
    with pytest.raises(ValueError):
        W.wino3x3_plan(2, 16, 16, 36, 64)


def _butterfly(a0, a1, a2, a3):
    return a0 - a2, a1 + a2, a2 - a1, a1 - a3


def _emulate_f32(x, u, bias, plan):
    """What the f32 body computes under ``plan``: for each block (64 tiles
    by 128 output channels) and split, each 32-channel chunk's patch (zero
    outside the plane), V = B^T d B rows first, each position's product over
    the chunk folded into the four output sums y_ab with A^T's +-1
    coefficients; the splits summed in split order, the bias added in f32."""
    b, h, w, c = x.shape
    co = u.shape[2]
    at = W._AT
    rows_px = 2 * plan.rects_h * plan.th + 2
    cols_px = 2 * plan.rects_w * plan.tw + 2
    cp = plan.kchunks * plan.kc  # the chunks' channels, zeros past C (TMA's fill)
    xp = F.pad(x, (0, cp - c, 1, cols_px - w - 1, 1, rows_px - h - 1))
    u = F.pad(u, (0, 0, 0, cp - c))
    y = torch.zeros((b, h, w, co))
    for block in range(plan.m_blocks):
        tiles = plan.tiles(block)
        d = torch.stack([torch.stack([xp[bi, 2 * ti + k, 2 * tj:2 * tj + 4] for k in range(4)])
                         for bi, ti, tj in tiles])  # [64 tiles, 4 rows, 4 columns, C]
        rows = _butterfly(*(d[:, k] for k in range(4)))  # row i of B^T d: [64, 4 cols, C]
        v = [_butterfly(*(r[:, l] for l in range(4))) for r in rows]  # v[i][j]: [64, C]
        for nb in range(plan.n_blocks):
            cols = slice(nb * W.SM90_BN, min(co, (nb + 1) * W.SM90_BN))
            total = None
            for s in range(plan.splits):
                rng = plan.c_range(s)
                acc = torch.zeros((2, 2, len(tiles), cols.stop - cols.start))
                for c0 in range(rng.start, rng.stop, plan.kc):
                    ch = slice(c0, c0 + plan.kc)
                    for i in range(4):
                        for j in range(4):
                            m = v[i][j][:, ch] @ u[4 * i + j, ch, cols]
                            for a in range(2):
                                for bb in range(2):
                                    coef = at[a][i] * at[bb][j]
                                    if coef:
                                        acc[a, bb] += m if coef > 0 else -m
                total = acc if total is None else total + acc
            for t, (bi, ti, tj) in enumerate(tiles):
                if ti < h // 2 and tj < w // 2:
                    for a in range(2):
                        for bb in range(2):
                            y[bi, 2 * ti + a, 2 * tj + bb, cols] = total[a, bb, t]
    return y + bias


def _wino_inputs(b, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.uniform(-1, 1, (3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32) * 0.1
    return x, k, bias


@functools.lru_cache(maxsize=None)
def _pallas(b, h, w, c, co, seed):
    x, k, bias = _wino_inputs(b, h, w, c, co, seed)
    return np.asarray(JW.wino3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# the JAX kernel's own sizes (C % 128 == 0), with tiles overhanging a block's
# rectangle (8 x 8 and 16 x 16 planes) and Co below and above one block
_JAX_CASES = [(1, 8, 8, 128, 128), (2, 16, 16, 128, 256), (1, 32, 32, 256, 128)]


@pytest.mark.parametrize("b,h,w,c,co", _JAX_CASES)
@pytest.mark.parametrize("splits", [1, 2, None])
def test_f32_plan_emulation_matches_pallas_kernel(b, h, w, c, co, splits):
    x, k, bias = _wino_inputs(b, h, w, c, co, seed=c + co + h)
    plan = W.wino3x3_plan(b, h, w, c, co, splits, f32)
    u = W.winograd_weights(torch.from_numpy(k))
    got = _emulate_f32(torch.from_numpy(x), u, torch.from_numpy(bias), plan)
    assert _rel(got.numpy(), _pallas(b, h, w, c, co, c + co + h)) <= F32_TOL


@pytest.mark.parametrize("b,h,w,c,co", _JAX_CASES)
def test_f32_twin_matches_pallas_kernel(b, h, w, c, co):
    x, k, bias = _wino_inputs(b, h, w, c, co, seed=c + co + h)
    tx, tk, tb = map(torch.from_numpy, (x, k, bias))
    for fn in (lambda: W.wino3x3(tx, tk, tb), lambda: W.wino3x3_f32_sm90(tx, tk, tb),
               lambda: W.wino3x3_f32_sm90(tx, tk, tb, splits=2)):
        got = fn()
        assert got.dtype == f32 and tuple(got.shape) == (b, h, w, co)
        assert _rel(got.numpy(), _pallas(b, h, w, c, co, c + co + h)) <= F32_TOL


def test_f32_emulation_split_counts_agree_with_the_twin():
    """Every split count of a ragged shape (Co = 192: a block and a half;
    10 x 6 tiles in 8 x 8 rectangles) gives the twin's values: the split
    changes the order of the sums only."""
    b, h, w, c, co = 1, 20, 12, 96, 192
    x, k, bias = map(torch.from_numpy, _wino_inputs(b, h, w, c, co, seed=5))
    u = W.winograd_weights(k)
    want = W.wino3x3_plain(x, u, bias)
    for splits in (1, 2, 3):
        plan = W.wino3x3_plan(b, h, w, c, co, splits, f32)
        assert _rel(_emulate_f32(x, u, bias, plan).numpy(), want.numpy()) <= F32_TOL


@pytest.mark.parametrize("b,h,w,c,co,splits", [
    (1, 8, 8, 40, 72, None), (2, 16, 16, 100, 200, 2), (1, 16, 16, 224, 136, 3),
    (1, 8, 8, 20, 9, 1)])
def test_f32_emulation_at_remainder_widths_matches_the_twin(b, h, w, c, co, splits):
    """Widths off the 32-channel chunk and the 128-channel block (C = 224 is
    LDM-VQ-4's level 0): the last chunk's channels past C read as zeros on
    both operands, the last block's columns past Co are not written; the
    emulation gives the twin's values at every split count."""
    x, k, bias = map(torch.from_numpy, _wino_inputs(b, h, w, c, co, seed=c + co))
    u = W.winograd_weights(k)
    plan = W.wino3x3_plan(b, h, w, c, co, splits, f32)
    assert plan.kchunks * 32 > c or plan.n_blocks * 128 > co
    want = W.wino3x3_plain(x, u, bias)
    assert _rel(_emulate_f32(x, u, bias, plan).numpy(), want.numpy()) <= F32_TOL


def test_f32_wrapper_checks_on_the_cpu_and_launches_nothing():
    x, k, bias = map(torch.from_numpy, _wino_inputs(1, 8, 8, 64, 64, seed=6))
    counts = (W.wino3x3.launches, W.wino3x3_f32_sm90.launches, W.wino3x3_prior.launches)
    u = W.winograd_weights(k)
    assert torch.equal(W.wino3x3_f32_sm90(x, k, bias, u=u, splits=2), W.wino3x3_plain(x, u, bias))
    with pytest.raises(ValueError):  # bf16: the other Hopper body's
        W.wino3x3_f32_sm90(x.bfloat16(), k.bfloat16(), bias.bfloat16())
    with pytest.raises(ValueError):  # C % 4 != 0
        W.wino3x3_f32_sm90(x[..., :50], k[:, :, :50], bias)
    # C % 32 != 0 and Co % 64 != 0: taken (a partly zero chunk, a partial block)
    u48 = W.winograd_weights(k[:, :, :48, :40])
    assert torch.equal(W.wino3x3_f32_sm90(x[..., :48], k[:, :, :48, :40], bias[:40]),
                       W.wino3x3_plain(x[..., :48], u48, bias[:40]))
    with pytest.raises(ValueError):  # more splits than chunks
        W.wino3x3_f32_sm90(x, k, bias, splits=3)
    assert (W.wino3x3.launches, W.wino3x3_f32_sm90.launches, W.wino3x3_prior.launches) == counts


# ---- K8: the form and launch mapping ----

_GN_SHAPES = sorted({(8, side * side, c) for side, c in GN4_PLANES + GN5_PLANES + GN6_PLANES}
                    | {(2, 256, 64), (2, 144, 320), (1, 64, 1280), (2, 63, 1280),
                       (1, 4096, 320), (4, 16384, 512)})


@pytest.mark.parametrize("n,hw,c", _GN_SHAPES)
@pytest.mark.parametrize("mode", list(PG.GN_MODES))
def test_k8_plan_is_k3s_plan(n, hw, c, mode):
    k3 = G.group_norm_plan(n, hw, c, 32, bf16, SMS)
    plan = PG.probe_plan(n, hw, c, 32, mode, None, SMS)
    assert (plan.form, plan.tiles) == (k3.form, k3.tiles)
    # the copy mode's split form launches the apply kernel alone
    assert plan.launches == (1 if mode == "copy" and k3.form == "split" else k3.launches)


@pytest.mark.parametrize("n,hw,c", _GN_SHAPES)
def test_k8_forced_splits_take_the_split_form(n, hw, c):
    """Forced splits S run K3's split tiles (``sms // n``, at most hw // S
    so that each has a pixel of every run) over S runs: the grid never
    shrinks below K3's own split grid for S <= hw / (sms // n)."""
    k3_tiles = max(1, min(SMS // n, hw))
    for s in sorted({1, 2, 3, 16, hw}):
        plan = PG.probe_plan(n, hw, c, 32, "full", s, SMS)
        assert plan == PG.ProbePlan("split", max(1, min(SMS // n, hw // s)), 2, s)
        assert plan.tiles * s <= hw
        if s * k3_tiles <= hw:
            assert plan.tiles == k3_tiles


def _run_share(hw, runs, tiles, t, k):
    """``run_share`` of ``csrc/groupnorm_sm90.cuh``: tile t's share of run
    k, (first pixel, pixels)."""
    r0 = hw * k // runs
    length = hw * (k + 1) // runs - r0
    a = length * t // tiles
    return r0 + a, length * (t + 1) // tiles - a


def _tile_pixels(hw, runs, tiles, t):
    """``tile_pixels`` of ``csrc/groupnorm_sm90.cuh``: closed form."""
    lo, r = divmod(hw, runs)
    share = lambda n: n * (t + 1) // tiles - n * t // tiles
    return (runs - r) * share(lo) + r * share(lo + 1)


@pytest.mark.parametrize("n,hw,c", _GN_SHAPES)
def test_k8_run_walk_covers_every_pixel_once(n, hw, c):
    """The split kernels' walk under a forced plan: the tiles' shares of
    the runs cover each pixel of a sample once, every share has a pixel, and
    the closed-form count the apply kernel weights each partial by is the
    pixels the statistics kernel saw. Runs 1 is K3's contiguous tiles."""
    for s in sorted({1, 2, 3, 5, 16, hw}):
        plan = PG.probe_plan(n, hw, c, 32, "full", s, SMS)
        seen = np.zeros(hw, dtype=np.int64)
        for t in range(plan.tiles):
            shares = [_run_share(hw, s, plan.tiles, t, k) for k in range(s)]
            assert min(cnt for _, cnt in shares) >= 1
            for p0, cnt in shares:
                seen[p0:p0 + cnt] += 1
            assert sum(cnt for _, cnt in shares) == _tile_pixels(hw, s, plan.tiles, t)
            if s == 1:
                assert shares == [(hw * t // plan.tiles,
                                   hw * (t + 1) // plan.tiles - hw * t // plan.tiles)]
        assert (seen == 1).all()


@pytest.mark.parametrize("hw,s", [(64, 5), (63, 4), (256, 16), (144, 7)])
def test_k8_statistics_merged_over_the_run_shares_are_the_twins(hw, s):
    """The apply kernel's merge, emulated in f64: each tile's (mean,
    centered sum of squares) over its run shares, weighted by
    ``tile_pixels`` and merged in tile order (Chan), gives the group's mean
    and variance the twin takes over the whole sample."""
    rng = np.random.default_rng(hw + s)
    x = rng.standard_normal((hw, 8)) * 2 + 0.5  # one group of 8 channels
    tiles = max(1, min(SMS // 2, hw // s))
    n_, mean, m2 = 0.0, 0.0, 0.0
    for t in range(tiles):
        px = np.concatenate([x[p0:p0 + cnt] for p0, cnt in
                             (_run_share(hw, s, tiles, t, k) for k in range(s))])
        nb = float(_tile_pixels(hw, s, tiles, t) * 8)
        assert nb == px.size
        mb, m2b = px.mean(), ((px - px.mean()) ** 2).sum()
        delta = mb - mean
        tot = n_ + nb
        mean += delta * nb / tot
        m2 += m2b + delta * delta * n_ * nb / tot
        n_ = tot
    assert n_ == x.size
    np.testing.assert_allclose([mean, m2 / n_], [x.mean(), x.var()], rtol=1e-12)


def test_k8_plan_takes_each_form_at_the_script_planes():
    """At batch 8 K3 takes the split form on the 64^2 planes (a slab of 4
    groups of 10 channels over 4096 pixels does not fit) and the slab form
    on the others: both forms are K8's, mma included."""
    forms = {(side, c): PG.probe_plan(8, side * side, c, 32).form for side, c in GN4_PLANES}
    assert forms[(64, 320)] == forms[(64, 640)] == "split"
    assert {f for (side, _), f in forms.items() if side < 64} == {"slab"}
    assert PG.probe_plan(8, 4096, 320, 32).tiles == SMS // 8  # K3's one wave of split tiles
    assert PG.probe_plan(8, 4096, 320, 32, "full", 16).tiles == SMS // 8  # perf_gn4 chunk256


@pytest.mark.parametrize("n,hw,c,groups", [(2, 64, 36, 4), (2, 64, 4104, 8), (2, 64, 512, 512),
                                           (0, 64, 64, 32)])
def test_k8_plan_refuses_what_k3s_forms_refuse(n, hw, c, groups):
    """C % 8 != 0, C > 4096, more than 256 groups, no sample: K3's Hopper
    forms refuse them, so K8 does too, with the error K3's plan raises (on
    the card; the CPU runs the twin)."""
    with pytest.raises(ValueError):
        PG.probe_plan(n, hw, c, groups)
    with pytest.raises(ValueError):
        PG.probe_plan(n, hw, c, groups, "full", 2)


def test_k8_plan_refuses_forced_splits_out_of_range():
    for s in (0, 65):
        with pytest.raises(ValueError):
            PG.probe_plan(2, 64, 64, 32, "full", s)


@pytest.mark.parametrize("kw", [dict(mode="copy", splits=2), dict(mode="norm", mma=True),
                                dict(splits=2, mma=True), dict(mode="softmax"),
                                dict(splits=0), dict(splits=65)])
def test_k8_wrappers_refuse_the_flags_they_do_not_take(kw):
    x = torch.zeros((1, 8, 8, 64), dtype=bf16)
    g = torch.ones(64, dtype=bf16)
    for fn in (PG.group_norm_probe, PG.group_norm_probe_prior, PG.group_norm_probe_plain):
        with pytest.raises(ValueError):
            fn(x, g, g, **kw)


def test_k8_prior_runs_the_twin_on_the_cpu_and_launches_nothing():
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 64)).astype(np.float32)).bfloat16()
    g = torch.ones(64)
    counts = (PG.group_norm_probe.launches, PG.group_norm_probe_prior.launches)
    for kw in (dict(), dict(mode="bf16sig"), dict(mma=True), dict(splits=4)):
        want = PG.group_norm_probe_plain(x, g, g * 0, **kw)
        assert torch.equal(PG.group_norm_probe_prior(x, g, g * 0, **kw), want)
        assert torch.equal(PG.group_norm_probe(x, g, g * 0, **kw), want)
    assert counts == (PG.group_norm_probe.launches, PG.group_norm_probe_prior.launches)


def test_bf16sig_twin_within_tolerance_of_the_tanh_sigmoid():
    """The card's bf16sig epilogue takes the sigmoid as 0.5 tanh(y / 2) + 0.5
    on bf16 pairs (tanh.approx.bf16x2) where the twin takes 1 / (1 +
    exp(-y)), every result rounded to bf16 in both; emulated here with
    torch's bf16 arithmetic, the two stay within the bf16 tolerance."""
    rng = np.random.default_rng(34)
    x = torch.from_numpy((rng.standard_normal((2, 8, 8, 320)) * 2 + 0.5).astype(np.float32))
    x = x.bfloat16()
    g = torch.from_numpy((rng.standard_normal(320) * 0.5 + 1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(320) * 0.5).astype(np.float32))
    want = PG.group_norm_probe_plain(x, g, b, "bf16sig").float()
    yb = G.group_norm_plain(x, g, b, silu=False).bfloat16()  # the normalized value in bf16
    half = torch.tensor(0.5, dtype=bf16)
    sig = (torch.tanh(yb * half) * half + half).bfloat16()
    got = (yb * sig).float()
    assert float((got - want).abs().max() / want.abs().max()) <= BF16_TOL
    assert math.isfinite(float(got.abs().max()))
