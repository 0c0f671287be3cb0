"""Port parity: GEGLU FF (K2's twin) and GroupNorm(+SiLU) (K3's twin).

The plain PyTorch twins of the K2 and K3 CUDA kernels run for CPU tensors;
they are held against the JAX package's Pallas kernels in interpret mode:
``_ff_kernel`` (geglu_ff), ``_gn_kernel`` (group_norm / group_norm_silu on
a small plane) and the chunked ``_gn_stats2_kernel`` + ``_gn_apply_kernel``
pair (``_gn_chunked`` at f32). Inputs come from one numpy seed; f32.
"""

import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.ops import groupnorm as jax_gn
from complex_prompt_diffusion_tpu.ops.mlp import geglu_ff as jax_geglu_ff
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    GnPlan,
    gn_splits,
    group_norm,
    group_norm_nhwc,
    group_norm_plan,
    group_norm_prior,
    group_norm_silu,
    slab_groups,
)
from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_ff

# f32 both sides. GEGLU: the Pallas kernel's Abramowitz-Stegun erf is
# within 1.5e-7 of the exact erf the port uses; the sums are over C=128
# and 4C=512 terms. GroupNorm: f32 two-pass statistics on both sides.
FF_RTOL, FF_ATOL = 1e-4, 1e-5
GN_RTOL, GN_ATOL = 1e-5, 2e-5


def _ff_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    h4 = 4 * c
    x = rng.standard_normal((2, m // 2, c)).astype(np.float32)
    w1 = rng.uniform(-c**-0.5, c**-0.5, (c, 2 * h4)).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, (2 * h4,)).astype(np.float32)
    w2 = rng.uniform(-h4**-0.5, h4**-0.5, (h4, c)).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    return x, w1, b1, w2, b2


def test_geglu_matches_pallas_ff_kernel():
    args = _ff_inputs(128, 128)
    want = np.asarray(jax_geglu_ff(*args, use_pallas=True, interpret=True))
    got = geglu_ff(*map(torch.from_numpy, args))
    assert got.shape == (2, 64, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=FF_RTOL, atol=FF_ATOL)


@pytest.mark.parametrize("c", [320, 640, 1280])
def test_geglu_matches_pallas_ff_kernel_at_the_sd_widths(c):
    """K2's plain twin against the Pallas ``_ff_kernel`` in interpret mode at
    the UNet's three widths (H4 = 4C), small M; f32, the FF tolerance above
    (sums over C and 4C = 5120 terms at most). C = 320 is below the JAX
    wrapper's lane gate (C % 128), so ``_ff_pallas`` is called directly."""
    from complex_prompt_diffusion_tpu.ops.mlp import _ff_pallas

    args = _ff_inputs(16, c, seed=c)
    x2 = args[0].reshape(-1, c)
    want = np.asarray(_ff_pallas(x2, *args[1:], block_m=8, block_j=4 * c, interpret=True))
    got = geglu_ff(*map(torch.from_numpy, args)).reshape(-1, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=FF_RTOL, atol=FF_ATOL)


def test_geglu_small_width_matches_xla_path():
    """Widths below the Pallas kernel's lane gate (the tiny UNet's C=32)."""
    args = _ff_inputs(16, 32, seed=1)
    want = np.asarray(jax_geglu_ff(*args, use_pallas=False))
    got = geglu_ff(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=FF_RTOL, atol=FF_ATOL)


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    c = shape[-1]
    gamma = (1.0 + 0.5 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_pallas_gn_kernel(silu, eps):
    x, gamma, beta = _gn_inputs((2, 8, 8, 64), seed=int(silu))
    jfn = jax_gn.group_norm_silu if silu else jax_gn.group_norm
    want = np.asarray(jfn(x, gamma, beta, num_groups=32, eps=eps, interpret=True))
    fn = group_norm_silu if silu else group_norm
    got = fn(*map(torch.from_numpy, (x, gamma, beta)), 32, eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=GN_RTOL, atol=GN_ATOL)


def test_group_norm_matches_chunked_two_pass_kernels():
    """HW = 512, C = 64 at f32: the streaming two-pass stats kernel plus
    the apply kernel (rows 7 and 8 of the TPU kernel table)."""
    x, gamma, beta = _gn_inputs((2, 16, 32, 64), seed=2)
    want = np.asarray(jax_gn._gn_chunked(
        x, gamma, beta, num_groups=32, eps=1e-6, silu=True, interpret=True
    ))
    got = group_norm_silu(*map(torch.from_numpy, (x, gamma, beta)), 32, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=GN_RTOL, atol=GN_ATOL)


def test_group_norm_large_mean_is_two_pass():
    """A large common offset: centered variance keeps f32 accuracy where
    E[x^2] - E[x]^2 would cancel."""
    x, gamma, beta = _gn_inputs((1, 8, 8, 32), seed=3)
    x = x + 1000.0
    want = np.asarray(jax_gn._gn_xla(x, gamma, beta, 32, 1e-6, False))
    got = group_norm(*map(torch.from_numpy, (x, gamma, beta)), 32, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_group_norm_rejects_bad_groups_and_counts_no_cpu_launch():
    x = torch.zeros(1, 4, 4, 48)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(48), torch.zeros(48), 32)
    before = group_norm_nhwc.launches
    group_norm(torch.ones(1, 4, 4, 64), torch.ones(64), torch.zeros(64), 32)
    assert group_norm_nhwc.launches == before


@pytest.mark.parametrize(
    "n,hw,c,want",
    [
        (8, 64 * 64, 320, 1),    # UNet batch 8: 256 blocks fill 132 SMs, fused kernel
        (2, 16 * 16, 1280, 1),   # batch-1 UNet: slices too small to split
        (4, 512 * 512, 128, 1),  # b4 VAE decode plane: 128 blocks, fused kernel
        (2, 64 * 64, 320, 2),    # batch-1 UNet level 0: 64 blocks -> 128
        (1, 512 * 512, 256, 9),  # b1 VAE decode plane: 32 blocks -> 288
        (1, 64 * 64, 512, 4),    # b1 mid-block plane: 32 x 4, at least 16K elements each
    ],
)
def test_group_norm_split_count(n, hw, c, want):
    """How many blocks share one (sample, group) slice on a 132-SM card, in
    the replaced body's schedule (``group_norm_prior``)."""
    assert gn_splits(n, hw, c, 32, 132) == want


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "n,hw,c,dtype,want",
    [
        # UNet batch 8 (the b4 step): 64^2 planes hold no whole group in a
        # block's 188 KB (4096 pixels x 8 channels x 2 bytes = 64 KB is the
        # least, but 8 channels are not whole groups at C/G = 10, 20, 30):
        # split, 16 tiles a sample, 128 blocks
        (8, 64 * 64, 320, _BF16, GnPlan("split", 16, 2)),
        (8, 64 * 64, 960, _BF16, GnPlan("split", 16, 2)),
        # 32^2 x 320: 4 groups (40 channels) a block, 64 blocks
        (8, 32 * 32, 320, _BF16, GnPlan("slab", 4, 1)),
        # 32^2 x 1280: one group a block would be 256 blocks, two waves on
        # 132 SMs; two groups a block, 128 blocks, one wave
        (8, 32 * 32, 1280, _BF16, GnPlan("slab", 2, 1)),
        # 32^2 x 960 and 1920: the fewest whole groups of 8k channels (120)
        # over 1024 pixels do not fit a block
        (8, 32 * 32, 1920, _BF16, GnPlan("split", 16, 2)),
        (8, 8 * 8, 2560, _BF16, GnPlan("slab", 2, 1)),
        # UNet batch 2 (the b1 step): one group a block fits one wave
        (2, 32 * 32, 1280, _BF16, GnPlan("slab", 1, 1)),
        (2, 16 * 16, 640, _BF16, GnPlan("slab", 2, 1)),
        (2, 64 * 64, 640, _BF16, GnPlan("split", 66, 2)),
        # the decode planes at batch 1 and 4, bf16 and f32
        (1, 64 * 64, 512, _BF16, GnPlan("slab", 1, 1)),
        (1, 512 * 512, 128, _BF16, GnPlan("split", 132, 2)),
        (4, 64 * 64, 512, _F32, GnPlan("split", 33, 2)),
        (4, 512 * 512, 256, _F32, GnPlan("split", 33, 2)),
        # more samples than SMs: the most groups a block that fit
        (200, 8 * 8, 320, _BF16, GnPlan("slab", 16, 1)),
    ],
)
def test_group_norm_plan(n, hw, c, dtype, want):
    """K3's form and blocks at the UNet's and the decode's shapes on a
    132-SM card, and the kernels a call launches."""
    plan = group_norm_plan(n, hw, c, 32, dtype, 132)
    assert plan == want
    assert plan.launches == (1 if plan.form == "slab" else 2)


@pytest.mark.parametrize("hw,c,esize,want", [
    (1024, 320, 2, [4, 8]),          # C/G = 10: 40 channels at least; 160 x 1024 x 2 > 188 KB
    (64, 2560, 2, [1, 2]),           # C/G = 80: 80 and 160 channels; 320 > 256
    (300, 1280, 4, [1, 2]),          # two 256-pixel boxes: 4 x 40 f32 channels exceed 188 KB
    (4096, 320, 2, []),              # 40 channels x 4096 pixels: 320 KB
])
def test_slab_groups(hw, c, esize, want):
    """The group counts a slab block can hold: whole groups of a multiple of
    8 channels, at most 256, and their pixels in 128-byte aligned boxes
    within a block's shared memory."""
    assert slab_groups(hw, c, 32, esize) == want


@pytest.mark.parametrize("c,groups", [(36, 4), (8192, 32), (512, 512)])
def test_group_norm_plan_raises_on_what_k3_does_not_take(c, groups):
    """C % 8 != 0, C > 4096, more than 256 groups."""
    with pytest.raises(ValueError):
        group_norm_plan(1, 64, c, groups, _BF16, 132)


def test_group_norm_prior_runs_the_plain_twin_on_the_cpu():
    x, gamma, beta = _gn_inputs((1, 4, 4, 64), seed=4)
    args = [torch.from_numpy(a) for a in (x, gamma, beta)]
    before = group_norm_prior.launches
    got = group_norm_prior(*args, 32, 1e-6, True)
    assert group_norm_prior.launches == before
    torch.testing.assert_close(got, group_norm_silu(*args, 32, 1e-6))
