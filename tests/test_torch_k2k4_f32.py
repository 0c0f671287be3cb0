"""K2's and K4's f32 bodies on the CPU: the routes, the plans, and the
arithmetic their plain twins share with the JAX package.

The card runs an f32 UNet through two exact-f32 GEMM bodies (three TF32
products a product): K2's ``csrc/geglu_ff_f32_sm90.cu`` and K4's
``csrc/conv3x3_f32_sm90.cu``. Here, without a card: which body each dtype
and width goes to (``k2_body``, ``k4_body``; f16 raises); the f32 plans
(shared memory within a block's 227 KB, every k-step in exactly one split,
split counts within range, cached); an emulation of the f32 conv kernel's
data movement under its plan against the JAX package's Pallas conv in
interpret mode; ``geglu_ff`` and ``conv3x3`` in f32 on CPU tensors (the
plain twins) against the JAX package's Pallas kernels in interpret mode;
and an f32 tiny UNet eval of the port against the JAX package's on the
same converted weights. Inputs come from numpy seeds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu.ops.conv import conv3x3 as jax_conv3x3
from complex_prompt_diffusion_tpu.ops.mlp import _ff_pallas
from complex_prompt_diffusion_tpu.pipeline import ModelBundle as JaxBundle
from complex_prompt_diffusion_tpu_torch import _build, convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.ops import conv as C
from complex_prompt_diffusion_tpu_torch.ops import mlp as F2
from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS, GEGLU_ROWS

# f32 both sides, as tests/test_torch_ffn_groupnorm.py and test_torch_conv.py
# state: the GEGLU FF's sums over C and 4C terms and the Pallas kernel's
# Abramowitz-Stegun erf (within 1.5e-7 of the exact one); the conv's sums of
# 9C products in another order
FF_RTOL, FF_ATOL = 1e-4, 1e-5
CONV_TOL = 1e-5  # max |a - b| / max |b|
MODEL_RTOL, MODEL_ATOL = 2e-5, 2e-5  # f32 whole-model outputs of O(1)

bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
SMEM_MAX = 232448  # bytes of shared memory one block may have on an H100

# every GEGLU width (C, H4 = 4C): the SD-1.5 UNet's three and the tiny one's two
K2_WIDTHS = [(320, 1280), (640, 2560), (1280, 5120), (32, 128), (64, 256)]
# (C, Co) of every 3x3 conv K4 may be handed: the SD-1.5 UNet's 22 batch-1
# convs, its conv_in and out conv; the SD VAE's (decoder conv_in 4 -> 512,
# its levels, conv_out 128 -> 3; encoder conv_in 3 -> 128, conv_out 512 ->
# 8); the tiny UNet's and tiny VAE's narrow ones
K4_WIDTHS = sorted({(c, co) for _, c, co in B1_UNET_CONVS} | {
    (4, 320), (320, 4), (4, 512), (512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
    (128, 3), (3, 128), (128, 256), (256, 512), (512, 8), (4, 32), (32, 32), (32, 64),
    (64, 64), (96, 32), (64, 32), (32, 4), (3, 32), (32, 8)} | {
    # CompVis LDM-VQ-4's UNet (224 .. 1568 channels), and widths no body but
    # the generic one takes (C % 8 != 0 in bf16, C % 4 != 0 in f32)
    (224, 448), (448, 448), (672, 672), (1120, 448), (1568, 672), (20, 320), (18, 72), (40, 9)})


@pytest.mark.parametrize("c,h4", K2_WIDTHS)
def test_k2_body_by_dtype(c, h4):
    assert F2.k2_body(bf16, c, h4) == "bf16_sm90"
    assert F2.k2_body(f32, c, h4) == "f32_sm90"
    with pytest.raises(TypeError):
        F2.k2_body(f16, c, h4)
    with pytest.raises(ValueError):
        F2.k2_body(f32, c + 4, h4)


@pytest.mark.parametrize("c,co", K4_WIDTHS)
def test_k4_body_by_dtype_and_width(c, co):
    narrow = co <= 8 or c <= 16
    assert C.k4_body(bf16, c, co) == (
        "narrow" if narrow else "bf16_sm90" if c % 8 == 0 else "generic")
    assert C.k4_body(f32, c, co) == ("narrow" if narrow else "f32_sm90" if c % 4 == 0 else "generic")
    with pytest.raises(TypeError):
        C.k4_body(f16, c, co)


def test_k4_f32_body_takes_the_unet_convs_and_not_the_narrow_ones():
    """All 22 convs of a batch-1 SD-1.5 UNet call go to the f32 body, the
    UNet's conv_in (C = 4) and out conv (Co = 4), the VAE's conv_in (C = 4)
    and conv_out (Co = 3) to the narrow bodies, and the tiny widths' Co =
    32 to the f32 body too (a partial n-tile); only C % 4 != 0 past the
    narrow widths reaches the FMA body."""
    assert all(C.k4_body(f32, c, co) == "f32_sm90" for _, c, co in B1_UNET_CONVS)
    assert C.k4_body(f32, 512, 512) == "f32_sm90"
    for c, co in ((4, 320), (320, 4), (128, 3), (4, 512)):
        assert C.k4_body(f32, c, co) == "narrow"
    for c, co in ((32, 32), (64, 32), (96, 32)):
        assert C.k4_body(f32, c, co) == "f32_sm90"
    assert C.k4_body(f32, 18, 32) == "generic"


def _kernel_smem(src: str) -> int:
    """The f32 bodies' block: shared memory from the source's own constants
    (1024-byte alignment, a ring of STAGES stages of a 128 x 32 A tile and a
    128 x 32 B tile, three split buffers of B hi and lo, the barriers)."""
    text = (_build.CSRC / src).read_text()
    stages = int(re.search(r"constexpr int STAGES = (\d+);", text).group(1))
    assert "constexpr int SPLIT_BYTES = 3 * 2 *" in text
    tile = 128 * 32 * 4
    return 1024 + stages * 2 * tile + 3 * 2 * tile + 2 * stages * 8


@pytest.mark.parametrize("src", ["geglu_ff_f32_sm90.cu", "conv3x3_f32_sm90.cu"])
def test_f32_bodies_fit_a_block(src):
    assert _kernel_smem(src) <= SMEM_MAX


def _steps_once(gp):
    hits = np.zeros(gp.ksteps, np.int64)
    for s in range(gp.splits):
        assert len(gp.k_range(s)) > 0
        for t in gp.k_range(s):
            hits[t] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("m,c", list(GEGLU_ROWS) + [(1, 320), (77, 32), (4097, 64)])
def test_geglu_f32_plan(m, c):
    h4 = 4 * c
    plan = F2.geglu_plan(m, c, h4, f32)
    assert plan is F2.geglu_plan(m, c, h4, f32)  # cached
    assert plan != F2.geglu_plan(m, c, h4)  # the bf16 plan is another
    g1, g2 = plan
    assert (g1.bn, g2.bn) == (F2.F32_WIDTHS1[0], F2.F32_WIDTHS2[0])
    assert g1.ksteps == -(-c // F2.F32_BK) and g2.ksteps == -(-h4 // F2.F32_BK)
    for gp, n in ((g1, h4), (g2, c)):
        assert 1 <= gp.splits <= min(16, gp.ksteps)
        assert gp.m_tiles == -(-m // 128) and gp.n_tiles == -(-n // gp.bn)
        assert _steps_once(gp)
    assert plan.launches == 2 + (g1.splits > 1) + (g2.splits > 1)
    for s in (1, 2, g2.ksteps):
        forced = F2._forced_plan(m, c, h4, splits2=min(s, g2.ksteps), dtype=f32)
        assert _steps_once(forced.gemm2) and forced.gemm2.splits <= s
    with pytest.raises(TypeError):
        F2.geglu_plan(m, c, h4, f16)


@pytest.mark.parametrize("b,hw,c,co", [(2, hw, c, co) for hw, c, co in B1_UNET_CONVS]
                         + [(1, 32, 512, 512), (1, 16, 512, 512), (2, 24, 64, 192)]
                         + [(1, 16, 672, 672), (1, 32, 672, 672), (4, 16, 32, 32), (4, 16, 96, 32),
                            (2, 16, 20, 9)])
def test_conv3x3_f32_plan(b, hw, c, co):
    plan = C.conv3x3_plan(b, hw, hw, c, co, dtype=f32)
    assert plan is C.conv3x3_plan(b, hw, hw, c, co, dtype=f32)
    assert plan.ksteps == 9 * -(-c // C.F32_BK) and plan.wt * plan.ht == 128
    assert 1 <= plan.splits <= min(16, plan.ksteps)
    assert plan.m_tiles == b * plan.tiles_h * plan.tiles_w and plan.n_tiles == -(-co // 128)
    assert _steps_once(plan)
    with pytest.raises(ValueError):
        C.conv3x3_plan(b, hw, hw, c + 2, co, dtype=f32)  # C % 4 != 0


def _emulate_f32(x, weight, bias, plan):
    """What the f32 conv kernel computes, step by step: for each output tile
    and split, the f32 sum over its k-steps (one tap, 32 channels) of the
    TMA box of x (zero outside the plane) times the weight box (zero past
    Co), the splits summed in split order, the bias added in f32."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    bk = C.F32_BK
    chunks = -(-c // bk)
    cp = chunks * bk  # the channels the boxes reach, zeros past C (TMA's fill)
    xp = torch.nn.functional.pad(x, (0, cp - c, 1, plan.wt + 1, 1, plan.ht + 1))
    wpad = torch.zeros((plan.n_tiles * 128, 9, cp))  # zeros past C in a tap, past Co
    wpad[:co, :, :c] = weight.permute(0, 2, 3, 1).reshape(co, 9, c)
    y = torch.zeros((b, h, w, co))
    for mt in range(plan.m_tiles):
        tw, rest = mt % plan.tiles_w, mt // plan.tiles_w
        th, bi = rest % plan.tiles_h, rest // plan.tiles_h
        h0, w0 = th * plan.ht, tw * plan.wt
        for nt in range(plan.n_tiles):
            total = None
            for s in range(plan.splits):
                part = torch.zeros((plan.ht * plan.wt, 128))
                for t in plan.k_range(s):
                    tap, c0 = t // chunks, (t % chunks) * bk
                    dy, dx = tap // 3, tap % 3
                    box = xp[bi, h0 + dy:h0 + dy + plan.ht, w0 + dx:w0 + dx + plan.wt,
                             c0:c0 + bk]
                    wbox = wpad[nt * 128:(nt + 1) * 128, tap, c0:c0 + bk]
                    part += box.reshape(-1, bk) @ wbox.t()
                total = part if total is None else total + part
            tile = total.reshape(plan.ht, plan.wt, 128)
            hs, ws = min(plan.ht, h - h0), min(plan.wt, w - w0)
            nc = min(128, co - nt * 128)
            y[bi, h0:h0 + hs, w0:w0 + ws, nt * 128:nt * 128 + nc] = tile[:hs, :ws, :nc]
    return y + bias


def _conv_inputs(b, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, c, co)).astype(np.float32) / np.sqrt(9 * c)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, k, bias


def _jax_conv(x, k, bias):
    return np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), True))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,w,c,co,splits", [
    (1, 8, 8, 64, 64, None),    # one tile: 8 x 16 pixels over an 8 x 8 plane
    (2, 16, 16, 32, 128, 1),    # 16 x 8 tiles, one 32-channel chunk a tap
    (2, 24, 24, 96, 192, 5),    # 8 x 16 tiles; Co = 192: half an n-tile; runs across taps
    (1, 16, 16, 64, 64, 18),    # every k-step its own split
    (4, 16, 16, 96, 32, None),  # the tiny config's 96 -> 32: one n-tile a quarter full
    (1, 16, 16, 40, 72, 4),     # C % 32 == 8: each tap's second k-step 24 zeros
    (1, 8, 8, 20, 9, 2),        # one k-step a tap, 12 of its channels past C; an odd Co
])
def test_f32_plan_emulation_matches_pallas_kernel(b, h, w, c, co, splits):
    x, k, bias = _conv_inputs(b, h, w, c, co, seed=c + co + h)
    want = _jax_conv(x, k, bias)
    p = convert.to_port({"kernel": k, "bias": bias})
    plan = C.conv3x3_plan(b, h, w, c, co, splits, f32)
    got = _emulate_f32(torch.from_numpy(x), p["weight"], p["bias"], plan).numpy()
    assert _rel(got, want) <= CONV_TOL


@pytest.mark.parametrize("hw,c,co", [(16, 64, 128), (32, 64, 128), (16, 320, 64),
                                     (32, 320, 64)])
def test_conv3x3_f32_on_cpu_matches_pallas_kernel(hw, c, co):
    """The route and the f32 body's wrapper on CPU tensors (the plain twin)
    against the Pallas conv in interpret mode."""
    x, k, bias = _conv_inputs(2, hw, hw, c, co, seed=hw + c)
    want = _jax_conv(x, k, bias)
    p = convert.to_port({"kernel": k, "bias": bias})
    xt = torch.from_numpy(x)
    assert C.k4_body(xt.dtype, c, co) == "f32_sm90"
    got = C.conv3x3(xt, p["weight"], p["bias"])
    assert got.dtype == f32 and _rel(got.numpy(), want) <= CONV_TOL
    assert torch.equal(C.conv3x3_f32_sm90(xt, p["weight"], p["bias"]), got)


def _ff_inputs(m, c, seed):
    rng = np.random.default_rng(seed)
    h4 = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = rng.uniform(-c**-0.5, c**-0.5, (c, 2 * h4)).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, (2 * h4,)).astype(np.float32)
    w2 = rng.uniform(-h4**-0.5, h4**-0.5, (h4, c)).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("c", [32, 64, 320])
def test_geglu_f32_on_cpu_matches_pallas_ff_kernel(c):
    """``geglu_ff`` in f32 on CPU tensors (the plain twin; the f32 body's
    wrapper takes it too) against the Pallas ``_ff_kernel`` in f32 in
    interpret mode, whose hidden stays f32 as the f32 body's does."""
    args = _ff_inputs(24, c, seed=c)
    want = np.asarray(_ff_pallas(*args, block_m=8, block_j=4 * c, interpret=True))
    targs = list(map(torch.from_numpy, args))
    assert F2.k2_body(f32, c, 4 * c) == "f32_sm90"
    got = F2.geglu_ff(*targs)
    assert got.dtype == f32
    np.testing.assert_allclose(got.numpy(), want, rtol=FF_RTOL, atol=FF_ATOL)
    assert torch.equal(F2.geglu_ff_f32_sm90(*targs), got)


def test_f32_wrappers_check_before_the_device():
    """The f32 bodies' wrappers refuse what their kernels do not take on CPU
    tensors too: another dtype, inconsistent shapes, C % 4 != 0."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _ff_inputs(8, 32, seed=1))
    with pytest.raises(TypeError):
        F2.geglu_ff_f32_sm90(x.to(bf16), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        F2.geglu_ff_f32_sm90(x, w1[:, :-8], b1, w2, b2)
    xc = torch.zeros(1, 16, 16, 64)
    w = torch.zeros(64, 64, 3, 3)
    with pytest.raises(ValueError):
        C.conv3x3_f32_sm90(xc.to(bf16), w, torch.zeros(64))
    with pytest.raises(ValueError):
        C.conv3x3_f32_sm90(xc[..., :38], w[:, :38], torch.zeros(64))  # C % 4 != 0


def test_f32_tiny_unet_matches_jax():
    """An f32 tiny UNet eval through the port (its convs on the 16^2 plane
    through K4's route, every transformer block's FF through K2's: the plain
    twins on the CPU) against the JAX package's on the same weights,
    converted."""
    jb = JaxBundle.random("tiny", seed=0)
    pb = ModelBundle.from_jax_bundle(jb, device="cpu")
    assert pb.unet_cfg.dtype == "float32"
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([901, 41], np.int32)
    ctx = rng.standard_normal((2, 77, jb.unet_cfg.context_dim)).astype(np.float32)
    want = jax.jit(lambda p, a, b, c: JM.unet_apply(jb.unet_cfg, p, a, b, c))(
        jb.unet_params, x, t, ctx)
    before = C.conv3x3.launches
    got = M.unet_apply(pb.unet_cfg, pb.unet_params, *map(torch.from_numpy, (x, t, ctx)))
    assert C.conv3x3.launches == before  # CPU tensors launch nothing
    assert got.dtype == f32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)
