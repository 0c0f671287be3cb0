"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without an NVIDIA GPU every test skips (decided in the
``dev`` fixture, never at import). On a machine with the card, from the
repository root (``--noconftest`` keeps jax out: the suite's conftest
imports it):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes are ragged on purpose (sequence lengths, rows, planes and channel
counts that are not multiples of the kernels' tiles). Tolerances: max
|kernel - plain| / max |plain| <= 2e-2 in bf16, <= 1e-4 in f32 (TF32 off).
"""

import pytest
import torch

from complex_prompt_diffusion_tpu_torch.ops.attention import (
    attention_bf16_wide_mma,
    attention_bf16_wide_sm90,
    attention_cm_f32_sm90_count,
    attention_cm_sm90_count,
    attention_dmajor,
    attention_dmajor_plain,
    attention_dmajor_prior,
    attention_f32_fma,
    attention_f32_fused_sm90,
    attention_f32_sm90,
    attention_kcanon,
    attention_plain,
    attention_sm90,
    bf16_wide_launches,
    f32_sm90_launches,
    flash_attention,
    k1_bf16_key_tile,
    k1_f32_config,
    k5_body,
    k5_config,
    self_attention_cm,
    self_attention_cm_plain,
)
from complex_prompt_diffusion_tpu_torch.ops.conv import (
    conv3x3,
    conv3x3_f32_sm90,
    conv3x3_generic,
    conv3x3_plain,
    conv3x3_plan,
    conv3x3_sm90,
)
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS, GEGLU_ROWS
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    _TILE_BYTES,
    GnPlan,
    group_norm_nhwc,
    group_norm_plain,
    group_norm_plan,
    group_norm_prior,
    slab_groups,
)
from complex_prompt_diffusion_tpu_torch.ops.mlp import (
    GEGLU1_WIDTHS,
    GEGLU2_WIDTHS,
    _forced_plan,
    geglu_ff,
    geglu_ff_f32_sm90,
    geglu_ff_plain,
    geglu_plan,
)
from complex_prompt_diffusion_tpu_torch.ops.probes.attention import attention_probe
from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import (
    group_norm_probe,
    group_norm_probe_plain,
    group_norm_probe_prior,
    probe_plan,
)
from complex_prompt_diffusion_tpu_torch.ops.probes.stream import stream_copy, stream_copy_prior
from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
    k6_body,
    wino3x3,
    wino3x3_f32_sm90,
    wino3x3_plain,
    wino3x3_plan,
    wino3x3_prior,
    wino3x3_sm90,
    winograd_weights,
)
from complex_prompt_diffusion_tpu_torch.tools.probe_groupnorm import COPY_SHAPES, GN4_PLANES

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("d", [16, 40, 64, 80, 160, 256])
def test_attention_bf16_ragged(dev, d):
    g = _gen(dev, d)
    heads = 3
    qkv = torch.randn((2, 200, 3 * heads * d), generator=g, device=dev).to(torch.bfloat16)
    _, k, v = qkv.chunk(3, dim=-1)  # strided views, as in the UNet
    q = torch.randn((2, 100, heads * d), generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, heads)
    assert flash_attention.launches == before + 1
    assert _rel(got, attention_plain(q, k, v, heads)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("d", [64, 512])
def test_attention_f32_ragged(dev, d):
    g = _gen(dev, d)
    q = torch.randn((2, 70, d), generator=g, device=dev)
    k = torch.randn((2, 300, d), generator=g, device=dev)
    v = torch.randn((2, 300, d), generator=g, device=dev)
    got = flash_attention(q, k, v, 1)
    assert _rel(got, attention_plain(q, k, v, 1)) <= TOL[torch.float32]


@pytest.mark.parametrize("d", [384, 512])
def test_attention_bf16_wide_ragged(dev, d):
    """K1's bf16 route for 256 < d <= 512 (the VAE mid-block; the wgmma
    body): query and key counts that are not multiples of its 128-row and
    128-key tiles, and k/v as strided views; the route adds the kernels
    the body reports, and the replaced mma.sync body agrees too."""
    g = _gen(dev, d)
    kv = torch.randn((2, 300, 2 * d), generator=g, device=dev).to(torch.bfloat16)
    k, v = kv.chunk(2, dim=-1)
    q = torch.randn((2, 100, d), generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, 1)
    assert flash_attention.launches == before + bf16_wide_launches(2, 1, 100, 300)
    want = attention_plain(q, k, v, 1)
    assert _rel(got, want) <= TOL[torch.bfloat16]
    assert _rel(attention_bf16_wide_mma(q, k, v, 1), want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("s", [1, 100, 4095, 4096])
@pytest.mark.parametrize("d", [384, 512])
def test_attention_bf16_wide_sm90(dev, d, s, b):
    """The wgmma body at the VAE mid-block's lengths and ragged ones, batch 1
    and 4, against the plain twin within 2e-2; launches as predicted."""
    g = _gen(dev, 7 * d + s)
    q, k, v = (torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    before = attention_bf16_wide_sm90.launches
    got = attention_bf16_wide_sm90(q, k, v, 1)
    assert attention_bf16_wide_sm90.launches == before + bf16_wide_launches(b, 1, s, s)
    assert _rel(got, attention_plain(q, k, v, 1)) <= TOL[torch.bfloat16]


def test_attention_bf16_wide_sm90_in_several_passes_and_heads(dev):
    """Query rows in passes of 128 (the workspace cap's schedule), two heads
    of d = 384, unequal Sq and Skv."""
    g = _gen(dev, 21)
    q = torch.randn((2, 300, 768), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((2, 520, 768), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    before = attention_bf16_wide_sm90.launches
    got = attention_bf16_wide_sm90(q, k, v, 2, rows=128)
    assert attention_bf16_wide_sm90.launches == before + bf16_wide_launches(2, 2, 300, 520, 128)
    assert bf16_wide_launches(2, 2, 300, 520, 128) == 9
    assert _rel(got, attention_plain(q, k, v, 2)) <= TOL[torch.bfloat16]


def test_attention_rejects_unsupported(dev):
    x = torch.zeros((1, 256, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(x, x, x, 1)
    y = torch.zeros((1, 256, 40), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(y, y, y, 2)  # d = 20


@pytest.mark.parametrize("c", [32, 320])
def test_geglu_bf16_ragged(dev, c):
    g = _gen(dev, c)
    h4 = 4 * c

    def u(*shape, bound):
        return torch.empty(shape, device=dev).uniform_(-bound, bound, generator=g)

    x = torch.randn((3, 37, c), generator=g, device=dev).to(torch.bfloat16)
    args = [x] + [t.to(torch.bfloat16) for t in (
        u(c, 2 * h4, bound=c**-0.5), u(2 * h4, bound=0.1),
        u(h4, c, bound=h4**-0.5), u(c, bound=0.1))]
    before = geglu_ff.launches
    got = geglu_ff(*args)
    # GEMM1 with the GEGLU epilogue, GEMM2, and a reduce for each split GEMM
    assert geglu_ff.launches == before + geglu_plan(3 * 37, c, h4).launches
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _rel(got, geglu_ff_plain(*args)) <= TOL[torch.bfloat16]
    with pytest.raises(TypeError):  # f32 runs K2's f32 body; f16 has none
        geglu_ff(x.half(), *args[1:])


def _geglu_args(dev, m, c, seed):
    g = _gen(dev, seed)
    h4 = 4 * c

    def u(*shape, bound):
        return torch.empty(shape, device=dev).uniform_(-bound, bound, generator=g)

    x = torch.randn((m, c), generator=g, device=dev).to(torch.bfloat16)
    return [x] + [t.to(torch.bfloat16) for t in (
        u(c, 2 * h4, bound=c**-0.5), u(2 * h4, bound=0.1),
        u(h4, c, bound=h4**-0.5), u(c, bound=0.1))]


# the eight (M, C) of the SD-1.5 512x512 render: UNet batch 8, then 2
GEGLU_SD_SHAPES = [(32768, 320), (8192, 640), (2048, 1280), (512, 1280),
                   (8192, 320), (2048, 640), (512, 1280), (128, 1280)]


@pytest.mark.parametrize("m,c", GEGLU_SD_SHAPES)
def test_geglu_sm90_at_the_sd_shapes(dev, m, c):
    """K2 at the render's shapes: right, the same bits on two calls, and the
    plan's launch count."""
    args = _geglu_args(dev, m, c, m + c)
    before = geglu_ff.launches
    got = geglu_ff(*args)
    assert geglu_ff.launches == before + geglu_plan(m, c, 4 * c).launches
    assert _rel(got, geglu_ff_plain(*args)) <= TOL[torch.bfloat16]
    assert torch.equal(geglu_ff(*args), got)


@pytest.mark.parametrize("m", [1, 77, 200, 4097])
@pytest.mark.parametrize("c", [320, 1280])
def test_geglu_sm90_ragged_rows_at_every_split_count_and_width(dev, m, c):
    """Rows that are not multiples of the 128-row tile, every split count the
    plan can pick for each GEMM (1 .. 16, or the k-steps) and every tile
    width; each within bf16 of the plain twin and the same bits twice."""
    h4 = 4 * c
    args = _geglu_args(dev, m, c, m * c)
    want = geglu_ff_plain(*args)
    k1, k2 = -(-c // 64), -(-h4 // 64)
    plans = [_forced_plan(m, c, h4, splits1=min(s, k1), splits2=min(s, k2))
             for s in range(1, min(16, max(k1, k2)) + 1)]
    plans += [_forced_plan(m, c, h4, bn1=b1, bn2=b2)
              for b1 in GEGLU1_WIDTHS for b2 in GEGLU2_WIDTHS]
    for plan in plans:
        before = geglu_ff.launches
        got = geglu_ff(*args, plan=plan)
        assert geglu_ff.launches == before + plan.launches
        assert _rel(got, want) <= TOL[torch.bfloat16], plan
        assert torch.equal(geglu_ff(*args, plan=plan), got), plan


def test_geglu_sm90_takes_strided_rows_and_raises_on_what_it_does_not_take(dev):
    args = _geglu_args(dev, 300, 320, 5)
    x3 = args[0].reshape(3, 100, 320)
    got = geglu_ff(x3, *args[1:])
    assert got.shape == x3.shape
    assert _rel(got, geglu_ff_plain(x3, *args[1:])) <= TOL[torch.bfloat16]
    with pytest.raises(ValueError):
        geglu_ff(torch.zeros((4, 36), device=dev, dtype=torch.bfloat16),
                 *[a[..., :1] for a in args[1:]])
    # f32 is taken (K2's f32 body, the weights widened); f16 raises
    f32_args = [a.float() for a in args]
    before = geglu_ff_f32_sm90.launches
    got = geglu_ff(x3.float(), *f32_args[1:])
    assert got.dtype == torch.float32 and geglu_ff_f32_sm90.launches > before
    assert _rel(got, geglu_ff_plain(x3.float(), *f32_args[1:])) <= 1e-5
    with pytest.raises(TypeError):
        geglu_ff(x3.half(), *args[1:])


def _geglu_f32_args(dev, m, c, seed):
    return [a.float() for a in _geglu_args(dev, m, c, seed)]


@pytest.mark.parametrize("m,c", GEGLU_ROWS)
def test_geglu_f32_at_the_phase1_cases(dev, m, c):
    """K2's f32 body (three TF32 products a product) at every phase-1 case:
    within 1e-5 of the TF32-off twin, the same bits on two calls, and the
    kernels its plan predicts, all on the f32 body."""
    args = _geglu_f32_args(dev, m, c, m + 3 * c)
    before, before_f32 = geglu_ff.launches, geglu_ff_f32_sm90.launches
    got = geglu_ff(*args)
    n = geglu_plan(m, c, 4 * c, torch.float32).launches
    assert geglu_ff.launches == before + n and geglu_ff_f32_sm90.launches == before_f32 + n
    assert got.dtype == torch.float32
    assert _rel(got, geglu_ff_plain(*args)) <= 1e-5
    assert torch.equal(geglu_ff(*args), got)


@pytest.mark.parametrize("m", [1, 77, 200, 4097])
@pytest.mark.parametrize("c", [32, 320, 1280])
def test_geglu_f32_ragged_rows_at_every_split_count(dev, m, c):
    """Rows that are not multiples of the 128-row unit, the tiny UNet's C =
    32, and split counts forced for both GEMMs (1 .. 16, or the k-steps):
    each within 1e-5 of the twin and the same bits twice."""
    h4 = 4 * c
    args = _geglu_f32_args(dev, m, c, m * c + 1)
    want = geglu_ff_plain(*args)
    k1, k2 = -(-c // 32), -(-h4 // 32)
    for s_ in sorted({1, 2, 3, 7, 16, k1}):
        plan = _forced_plan(m, c, h4, splits1=min(s_, k1), splits2=min(s_, k2),
                            dtype=torch.float32)
        before = geglu_ff_f32_sm90.launches
        got = geglu_ff(*args, plan=plan)
        assert geglu_ff_f32_sm90.launches == before + plan.launches
        assert _rel(got, want) <= 1e-5, plan
        assert torch.equal(geglu_ff(*args, plan=plan), got), plan


def _conv_f32_inputs(dev, b, h, w, c, co, seed):
    x, wt, bias = _conv_inputs(dev, b, h, w, c, co, seed)
    return x.float() + 0.01 * torch.randn(x.shape, generator=_gen(dev, seed), device=dev), \
        wt.float(), bias.float() + 0.01


@pytest.mark.parametrize("b,hw,c,co", [(2, hw, c, co) for hw, c, co in B1_UNET_CONVS]
                         + [(1, 32, 512, 512)])
def test_conv3x3_f32_sm90_at_the_phase1_cases(dev, b, hw, c, co):
    """K4's f32 body at the 22 convs' shapes of a batch-1 f32 UNet call and
    the small f32 decode's 32^2 512->512, through the route: within 1e-5 of
    the TF32-off twin, one call of the f32 body, the same bits twice; the
    FMA body it replaced still within f32's tolerance."""
    x, wt, bias = _conv_f32_inputs(dev, b, hw, hw, c, co, b + hw + c + co)
    want = conv3x3_plain(x, wt, bias)
    before, before_f32 = conv3x3.launches, conv3x3_f32_sm90.launches
    got = conv3x3(x, wt, bias)
    assert conv3x3.launches == before + 1 and conv3x3_f32_sm90.launches == before_f32 + 1
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5
    assert torch.equal(got, conv3x3(x, wt, bias))
    # the FMA body's sequential f32 sums over K = 9C: f32's tolerance
    assert _rel(conv3x3_generic(x, wt, bias), want) <= TOL[torch.float32]


@pytest.mark.parametrize("b,hw,c,co", [(1, 8, 64, 64), (2, 24, 96, 192), (3, 40, 32, 64),
                                       (4, 8, 192, 128), (2, 10, 64, 320)])
def test_conv3x3_f32_sm90_ragged_planes_and_split_counts(dev, b, hw, c, co):
    """Planes that are not a multiple of the unit (8, 10, 24, 40), Co = 192 and
    320 (part of a 128-channel unit), C = 32 (one chunk a tap), batch 1-4;
    every forced split count within 1e-5 of the twin and the same bits twice."""
    x, wt, bias = _conv_f32_inputs(dev, b, hw, hw, c, co, 7 * b + hw + c + co)
    want = conv3x3_plain(x, wt, bias)
    ksteps = conv3x3_plan(b, hw, hw, c, co, dtype=torch.float32).ksteps
    for s_ in sorted({1, 2, 3, 7, ksteps}):
        got = conv3x3_f32_sm90(x, wt, bias, splits=s_)
        assert _rel(got, want) <= 1e-5, s_
        assert torch.equal(got, conv3x3_f32_sm90(x, wt, bias, splits=s_)), s_


@pytest.mark.parametrize("splits", [1, None])
def test_conv3x3_f32_fold_rule_at_the_longest_k(dev, splits):
    """The fold rule at K = 9C = 23040 (the UNet's 16^2 2560->1280 conv):
    the run length of csrc/tf32x3.cuh (kFold) holds 1e-5 against the
    TF32-off twin with the whole K in one unit and with the plan's splits."""
    x, wt, bias = _conv_f32_inputs(dev, 2, 16, 16, 2560, 1280, 23040)
    want = conv3x3_plain(x, wt, bias)
    got = conv3x3_f32_sm90(x, wt, bias, splits=splits)
    assert _rel(got, want) <= 1e-5


def test_conv3x3_f32_sm90_raises_on_what_it_does_not_take(dev):
    x, wt, bias = _conv_f32_inputs(dev, 1, 8, 8, 64, 64, 1)
    with pytest.raises(ValueError):  # bf16
        conv3x3_f32_sm90(x.to(torch.bfloat16), wt, bias)
    with pytest.raises(ValueError):  # C % 32 != 0
        conv3x3_f32_sm90(x[..., :40].contiguous(), wt[:, :40].contiguous(), bias)
    flat = torch.empty(1 + x.numel(), device=dev)
    shifted = flat[1:].view(x.shape)  # 4 bytes past a 16-byte boundary
    shifted.copy_(x)
    with pytest.raises(ValueError):  # TMA needs a 16-byte aligned base
        conv3x3_f32_sm90(shifted, wt, bias)
    with pytest.raises(TypeError):
        conv3x3(x.half(), wt.half(), bias)


@pytest.mark.parametrize("d", [64, 384, 512])
@pytest.mark.parametrize("s", [1, 100, 4095])
def test_attention_f32_exact_against_the_no_tf32_plain_twin(dev, d, s):
    """K1 in f32 (d = 64: the fused 3xTF32 body; 384 and 512: the unfused
    3xTF32 body) against the plain twin with TF32 off (the ``dev`` fixture
    sets ``torch.backends.cuda.matmul.allow_tf32 = False``): max |kernel -
    plain| <= 1e-5 of max |plain|, which one-pass TF32 (~1e-3) would miss."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = _gen(dev, d + s)
    kv = torch.randn((2, s, 2 * d), generator=g, device=dev)
    k, v = kv.chunk(2, dim=-1)  # strided views
    q = torch.randn((2, s, d), generator=g, device=dev)
    before = attention_f32_sm90.launches
    got = flash_attention(q, k, v, 1)
    assert attention_f32_sm90.launches == before + (
        f32_sm90_launches(2, 1, s, s) if d > 256 else 0)
    assert _rel(got, attention_plain(q, k, v, 1)) <= 1e-5


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("sq,skv", [(1, 1), (100, 300), (1000, 1336), (4095, 257)])
def test_attention_f32_fused_sm90_ragged(dev, d, sq, skv):
    """K1's fused 3xTF32 body (f32, d <= 160) at ragged lengths, on strided
    k and v views, against the plain twin with TF32 off at 1e-5; one launch
    a call, on its own count and K1's."""
    g = _gen(dev, d + sq)
    heads = 2
    q = torch.randn((2, sq, heads * d), generator=g, device=dev)
    kv = torch.randn((2, skv, 2 * heads * d), generator=g, device=dev)
    k, v = kv.chunk(2, dim=-1)
    before = (flash_attention.launches, attention_f32_fused_sm90.launches,
              attention_f32_sm90.launches)
    got = flash_attention(q, k, v, heads)
    assert (flash_attention.launches, attention_f32_fused_sm90.launches,
            attention_f32_sm90.launches) == (before[0] + 1, before[1] + 1, before[2])
    assert _rel(got, attention_plain(q, k, v, heads)) <= 1e-5
    assert torch.equal(attention_f32_fused_sm90(q, k, v, heads), got)


@pytest.mark.parametrize("d", [164, 200, 256])
def test_attention_f32_above_160_takes_the_unfused_body(dev, d):
    g = _gen(dev, d)
    q, k, v = (torch.randn((1, s, 2 * d), generator=g, device=dev) for s in (130, 250, 250))
    before = attention_f32_sm90.launches
    got = flash_attention(q, k, v, 2)
    assert attention_f32_sm90.launches == before + f32_sm90_launches(1, 2, 130, 250)
    assert _rel(got, attention_plain(q, k, v, 2)) <= 1e-5


def test_attention_f32_fma_still_matches(dev):
    g = _gen(dev, 5)
    q, k, v = (torch.randn((2, s, 2 * 80), generator=g, device=dev) for s in (70, 300, 300))
    assert _rel(attention_f32_fma(q, k, v, 2), attention_plain(q, k, v, 2)) <= 1e-5


def test_k1_f32_config_mirror_matches_the_c_entry(dev):
    """ops.attention.k1_f32_config against the CfgF the fused kernel
    compiles, at every head dim it takes; the C entry refuses the rest."""
    import ctypes

    from complex_prompt_diffusion_tpu_torch import _build

    fn = _build.kernel_library().cpd_attention_f32_fused_sm90_config
    for d in range(1, 261):
        buf = (ctypes.c_int * 4)()
        err = fn(d, ctypes.addressof(buf))
        if d % 4 or d > 160:
            assert err != 0, d
            continue
        c = k1_f32_config(d)
        assert err == 0 and tuple(buf) == (c.query_rows, c.key_tile, 1, c.smem_bytes), d


def test_attention_f32_sm90_in_several_passes_and_heads(dev):
    """Query rows in passes of 128 (the workspace cap's path), two heads,
    ragged Sq and Skv, against the plain twin at 1e-5; the same bits as one
    pass, and on a second call."""
    g = _gen(dev, 9)
    q = torch.randn((2, 300, 2 * 384), generator=g, device=dev)
    k = torch.randn((2, 333, 2 * 384), generator=g, device=dev)
    v = torch.randn((2, 333, 2 * 384), generator=g, device=dev)
    one = attention_f32_sm90(q, k, v, 2)
    before = attention_f32_sm90.launches
    passes = attention_f32_sm90(q, k, v, 2, rows=128)
    assert attention_f32_sm90.launches == before + 3 + 3 * 3  # split, then 3 passes
    assert _rel(passes, attention_plain(q, k, v, 2)) <= 1e-5
    assert torch.equal(passes, one) and torch.equal(attention_f32_sm90(q, k, v, 2), one)
    with pytest.raises(ValueError):
        attention_f32_sm90(q[..., :320], k[..., :320], v[..., :320], 2)  # d = 160: fused


def _grad_cases(dev):
    bf, f32 = torch.bfloat16, torch.float32
    q8 = torch.randn((1, 256, 64), device=dev, dtype=bf, requires_grad=True)
    qf = torch.randn((1, 256, 64), device=dev, requires_grad=True)
    qw = torch.randn((1, 256, 512), device=dev, requires_grad=True)
    qwb = torch.randn((1, 256, 512), device=dev, dtype=bf, requires_grad=True)
    dm = torch.randn((1, 1, 64, 256), device=dev, dtype=bf, requires_grad=True)
    x = torch.randn((1, 16, 16, 64), device=dev, dtype=bf, requires_grad=True)
    xf = torch.randn((1, 16, 16, 64), device=dev, dtype=f32, requires_grad=True)
    w = torch.randn((64, 64, 3, 3), device=dev, dtype=bf).contiguous(
        memory_format=torch.channels_last)
    bias = torch.zeros(64, device=dev, dtype=bf)
    gam = torch.ones(64, device=dev, dtype=bf)
    x320 = torch.randn((1, 8, 8, 320), device=dev, dtype=bf, requires_grad=True)
    g320 = torch.ones(320, device=dev, dtype=bf)
    ff = _geglu_args(dev, 16, 64, 3)
    ff[1].requires_grad_(True)  # a weight that requires grad is refused too
    return {
        "K1 sm90": lambda: flash_attention(q8, q8, q8, 1),
        "K1 f32": lambda: flash_attention(qf, qf, qf, 1),
        "K1 f32 3xTF32": lambda: flash_attention(qw, qw, qw, 1),
        "K1 bf16 d512": lambda: flash_attention(qwb, qwb, qwb, 1),
        "K5": lambda: attention_dmajor(dm, dm, dm, 0.125),
        "K2": lambda: geglu_ff(*ff),
        "K2 f32": lambda: geglu_ff(*[t.float() for t in ff]),
        "K3": lambda: group_norm_nhwc(x, gam, gam, 32),
        "K4 sm90": lambda: conv3x3(x, w, bias),
        "K4 f32": lambda: conv3x3(xf, w.float(), bias.float()),
        "K4 f32 FMA": lambda: conv3x3(xf[..., :40], w.float()[:, :40], bias.float()),
        "K6": lambda: wino3x3(x, w.permute(2, 3, 1, 0), bias),
        "K6 f32": lambda: wino3x3(xf, w.float().permute(2, 3, 1, 0), bias.float()),
        "K7": lambda: attention_probe(q8[..., :40], q8[..., :40], q8[..., :40], 1, 0.158),
        "K8": lambda: group_norm_probe(x320, g320, g320),
        "K8 replaced body": lambda: group_norm_probe_prior(x320, g320, g320),
        "K9": lambda: stream_copy(x.reshape(1, 256, 64), 64),
    }


@pytest.mark.parametrize("name", ["K1 sm90", "K1 f32", "K1 f32 3xTF32", "K1 bf16 d512", "K5",
                                  "K2", "K2 f32", "K3", "K4 sm90", "K4 f32", "K4 f32 FMA", "K6",
                                  "K6 f32", "K7", "K8", "K8 replaced body", "K9"])
def test_each_wrapper_raises_under_grad_and_runs_without_it(dev, name):
    call = _grad_cases(dev)[name]
    with pytest.raises(RuntimeError, match="no backward kernel"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call().float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize(
    "shape", [(3, 7, 5, 96), (2, 96, 160, 96), (2, 9, 11, 320), (2, 12, 10, 128),
              (1, 40, 24, 256), (2, 6, 7, 512)]
)
def test_group_norm_ragged(dev, dtype, silu, shape):
    """Channels per group 3, 10, 4, 8 and 16, in both dtypes, on small
    planes and on one whose ranges span many chunks; the wrapper adds the
    kernels the library reports, which are the plan's."""
    g = _gen(dev, 3)
    x = (2 * torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    c = shape[-1]
    gamma = (1 + 0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    before, planned = group_norm_nhwc.launches, group_norm_nhwc.planned
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, silu)
    assert group_norm_nhwc.launches - before == group_norm_nhwc.planned - planned
    assert group_norm_nhwc.launches - before in (1, 2)
    assert got.dtype == dtype
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, silu)) <= TOL[dtype]


def _gn_forced(form, hw, c, dtype):
    """A plan of ``form``: the split form over 5 tiles (ragged), or the slab
    form's fewest groups a block."""
    if form == "split":
        return GnPlan("split", 5, 2)
    return GnPlan("slab", slab_groups(hw, c, 32, 2 if dtype == torch.bfloat16 else 4)[0], 1)


@pytest.mark.parametrize("form", ["split", "slab"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [96, 128, 256, 320, 512, 960, 1280, 1920, 2560])
def test_group_norm_sm90_forms(dev, c, dtype, silu, form):
    """Both forms of K3 at C/G = 3, 4, 8, 10, 16, 30, 40, 60 and 80 (32
    groups), both dtypes, with and without SiLU, on a ragged 7 x 13 plane
    at batch 2: the split form's tiles take unequal pixel ranges, the slab
    form's TMA box is 91 pixels."""
    g = _gen(dev, c)
    x = (2 * torch.randn((2, 7, 13, c), generator=g, device=dev) + 0.5).to(dtype)
    gamma = (1 + 0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    plan = _gn_forced(form, 91, c, dtype)
    before = group_norm_nhwc.launches
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, silu, plan=plan)
    assert group_norm_nhwc.launches == before + plan.launches
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, silu)) <= TOL[dtype]


@pytest.mark.parametrize("groups,dtype", [(1, torch.bfloat16), (2, torch.bfloat16),
                                          (4, torch.bfloat16), (1, torch.float32),
                                          (2, torch.float32)])
def test_group_norm_slab_in_several_boxes(dev, groups, dtype):
    """The slab form over 300 pixels (a 256-pixel TMA box and a ragged one
    whose rows past the sample are zero-filled on load and clipped on
    store), 1, 2 and 4 groups a block (as many as two boxes fit), C/G =
    40."""
    assert groups in slab_groups(300, 1280, 32, 2 if dtype == torch.bfloat16 else 4)
    g = _gen(dev, 31 + groups)
    x = (2 * torch.randn((3, 20, 15, 1280), generator=g, device=dev) + 0.5).to(dtype)
    gamma = (1 + 0.5 * torch.randn(1280, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(1280, generator=g, device=dev)).to(dtype)
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-5, True, plan=GnPlan("slab", groups, 1))
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-5, True)) <= TOL[dtype]


@pytest.mark.parametrize("form", ["slab", "split"])
def test_group_norm_f32_centered_at_mean_1e3_on_a_decode_plane(dev, form):
    """An f32 plane (C/G = 4; the split form's at a decode plane's size,
    C/G = 8, as its plan) with a common offset of 1e3: the centered
    statistics (per-thread chunks merged by Chan, then the block's or the
    tiles') keep the f32 tolerance where E[x^2] - mean^2 would cancel."""
    g = _gen(dev, 17)
    shape = (1, 64, 64, 128) if form != "split" else (1, 256, 256, 256)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev) + 1000.0
    gamma = 1 + 0.5 * torch.randn(c, generator=g, device=dev)
    beta = 0.5 * torch.randn(c, generator=g, device=dev)
    if form == "split":
        plan = group_norm_plan(1, shape[1] * shape[2], c, 32, torch.float32, 132)
        assert plan.form == "split"
    else:
        plan = _gn_forced(form, shape[1] * shape[2], c, torch.float32)
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, True, plan=plan)
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, True)) <= TOL[torch.float32]


def test_group_norm_tile_bytes_match_the_plan(dev):
    """The plan's bytes of a slab block are the kernel's."""
    import ctypes

    from complex_prompt_diffusion_tpu_torch import _build

    got = ctypes.c_int(0)
    _build.check(_build.kernel_library().cpd_group_norm_sm90_tile_max(ctypes.addressof(got)),
                 "tile max")
    assert got.value == _TILE_BYTES


def test_group_norm_split_calls_share_one_partials_buffer(dev):
    """Split-form calls on one stream reuse one partials buffer, grown when
    a call needs more: a small plan, a larger one, then the small one again
    each match the plain twin, and the stream's buffer is allocated once a
    size."""
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G

    g = _gen(dev, 23)
    x = (2 * torch.randn((2, 24, 24, 256), generator=g, device=dev) + 0.5).to(torch.bfloat16)
    gamma = (1 + 0.5 * torch.randn(256, generator=g, device=dev)).to(torch.bfloat16)
    beta = (0.5 * torch.randn(256, generator=g, device=dev)).to(torch.bfloat16)
    want = group_norm_plain(x, gamma, beta, 32, 1e-6, True)
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    G._PARTS.pop(key, None)
    ptrs = []
    for tiles in (3, 40, 3):
        got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, True, plan=GnPlan("split", tiles, 2))
        assert _rel(got, want) <= TOL[torch.bfloat16]
        assert G._PARTS[key].shape[0] >= 2 * tiles * 32
        ptrs.append(G._PARTS[key].data_ptr())
    assert ptrs[1] == ptrs[2]


def test_group_norm_bf16_one_pass_on_an_offset_decode_plane(dev):
    """A bf16 decode-sized group slice (C/G = 4) with a common offset:
    K3's one-pass statistics against the one-pass plain twin."""
    g = _gen(dev, 5)
    x = (torch.randn((2, 128, 128, 128), generator=g, device=dev) + 8.0).to(torch.bfloat16)
    gamma = torch.ones(128, device=dev, dtype=torch.bfloat16)
    beta = torch.zeros(128, device=dev, dtype=torch.bfloat16)
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, True)
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, True)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_split_planes(dev, dtype):
    """A batch-1 plane too large for a slab: K3's plan splits it over
    one tile an SM (statistics kernel, then apply kernel). The f32 partials
    merge as centered sums (Chan), so a large common offset keeps the f32
    tolerance. The replaced body agrees too."""
    shape = (1, 256, 256, 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert group_norm_plan(1, 256 * 256, 64, 32, dtype, sms) == GnPlan("split", sms, 2)
    g = _gen(dev, 11)
    x = (torch.randn(shape, generator=g, device=dev) + (1000.0 if dtype == torch.float32
                                                        else 4.0)).to(dtype)
    gamma = (1 + 0.5 * torch.randn(64, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(64, generator=g, device=dev)).to(dtype)
    before = group_norm_nhwc.launches
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, True)
    assert group_norm_nhwc.launches == before + 2  # statistics, then apply
    want = group_norm_plain(x, gamma, beta, 32, 1e-6, True)
    assert _rel(got, want) <= TOL[dtype]
    assert _rel(group_norm_prior(x, gamma, beta, 32, 1e-6, True), want) <= TOL[dtype]


@pytest.mark.parametrize("co", [4, 320, 640, 1280])
@pytest.mark.parametrize("c", [4, 40, 320])
def test_conv3x3_ragged(dev, c, co):
    """K4 on a 10x12 plane (M = 240, not a multiple of its 64-row tile):
    C = 4 takes the element-wise gather, C = 40 splits 32-column k-tiles
    across taps, Co = 4 leaves most of a 64-channel tile empty."""
    g = _gen(dev, c + co)
    x = torch.randn((2, 10, 12, c), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.rand((co, c, 3, 3), generator=g, device=dev) * 2 - 1) / (3 * c ** 0.5)
    w = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    b = torch.randn(co, generator=g, device=dev).to(torch.bfloat16)
    before = conv3x3.launches
    got = conv3x3(x, w, b)
    assert conv3x3.launches == before + 1
    assert got.shape == (2, 10, 12, co) and got.dtype == torch.bfloat16
    assert _rel(got, conv3x3_plain(x, w, b)) <= TOL[torch.bfloat16]
    with pytest.raises(TypeError):
        conv3x3(x.half(), w, b)


@pytest.mark.parametrize("c,co", [(4, 4), (40, 320), (320, 640), (512, 512)])
def test_conv3x3_f32_ragged(dev, c, co):
    """K4's f32 path (exact FMAs, the f32 VAE decode's convs) on the same
    ragged 10x12 plane, and the bf16 path with an f32 bias."""
    g = _gen(dev, 7 * c + co)
    x = torch.randn((2, 10, 12, c), generator=g, device=dev)
    w = ((torch.rand((co, c, 3, 3), generator=g, device=dev) * 2 - 1) / (3 * c ** 0.5)).contiguous(
        memory_format=torch.channels_last)
    b = torch.randn(co, generator=g, device=dev)
    before = conv3x3.launches
    got = conv3x3(x, w, b)
    assert conv3x3.launches == before + 1
    assert got.shape == (2, 10, 12, co) and got.dtype == torch.float32
    assert _rel(got, conv3x3_plain(x, w, b)) <= TOL[torch.float32]
    x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
    assert _rel(conv3x3(x16, w16, b), conv3x3_plain(x16, w16, b)) <= TOL[torch.bfloat16]


def _conv_inputs(dev, b, h, w, c, co, seed):
    g = _gen(dev, seed)
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    wt = ((torch.rand((co, c, 3, 3), generator=g, device=dev) * 2 - 1) * (9 * c) ** -0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = (torch.rand(co, generator=g, device=dev) * 0.2 - 0.1).to(torch.bfloat16)
    return x, wt, bias


@pytest.mark.parametrize("hw,c,co", B1_UNET_CONVS)
def test_conv3x3_sm90_at_the_batch1_unet_shapes(dev, hw, c, co):
    """K4's TMA + wgmma body at the ten conv shapes of a batch-1 UNet call
    (UNet batch 2), through the route: the plain twin within bf16's
    tolerance, and the same bits on a second run (splits summed in order)."""
    x, wt, bias = _conv_inputs(dev, 2, hw, hw, c, co, hw + c + co)
    before, before_sm90 = conv3x3.launches, conv3x3_sm90.launches
    got = conv3x3(x, wt, bias)
    assert conv3x3.launches == before + 1 and conv3x3_sm90.launches == before_sm90 + 1
    assert _rel(got, conv3x3_plain(x, wt, bias)) <= TOL[torch.bfloat16]
    assert torch.equal(got, conv3x3(x, wt, bias))


@pytest.mark.parametrize("b,hw,c,co", [(1, 8, 64, 64), (2, 24, 128, 192), (3, 40, 64, 64),
                                       (4, 8, 192, 128), (2, 40, 128, 192)])
def test_conv3x3_sm90_ragged_planes_and_split_counts(dev, b, hw, c, co):
    """Planes that are not a multiple of the tile (8, 24, 40), Co = 192 (half
    an n-tile), batch 1-4, with an f32 bias too; every split count the plan
    can be forced to gives split 1's result within one bf16 rounding, and
    each the same bits twice."""
    x, wt, bias = _conv_inputs(dev, b, hw, hw, c, co, b * hw + c + co)
    want = conv3x3_plain(x, wt, bias)
    one = conv3x3_sm90(x, wt, bias, splits=1)
    assert _rel(one, want) <= TOL[torch.bfloat16]
    ksteps = conv3x3_plan(b, hw, hw, c, co).ksteps
    for s in sorted({2, 3, 4, 7, ksteps}):
        got = conv3x3_sm90(x, wt, bias, splits=s)
        assert torch.equal(got, conv3x3_sm90(x, wt, bias, splits=s))
        assert float((got.float() - one.float()).abs().max()) <= 2 ** -7 * float(
            one.float().abs().max())
    f32_bias = bias.float() + 0.01
    assert _rel(conv3x3_sm90(x, wt, f32_bias), conv3x3_plain(x, wt, f32_bias)) <= TOL[
        torch.bfloat16]


def test_conv3x3_sm90_raises_on_what_it_does_not_take(dev):
    x, wt, bias = _conv_inputs(dev, 1, 8, 8, 64, 64, 1)
    with pytest.raises(ValueError):  # f32
        conv3x3_sm90(x.float(), wt.float(), bias.float())
    x40, w40, b40 = _conv_inputs(dev, 1, 8, 8, 40, 64, 2)
    with pytest.raises(ValueError):  # C % 64 != 0
        conv3x3_sm90(x40, w40, b40)
    flat = torch.empty(1 + x.numel(), dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(x.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(x)
    with pytest.raises(ValueError):  # TMA needs a 16-byte aligned base
        conv3x3_sm90(shifted, wt, bias)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_attention_sm90_ragged_on_projection_views(dev, d):
    """K1's TMA + wgmma body on q, k, v that are strided views of one
    [B, S, 3*H*D] projection, with ragged Sq = 136 and Skv = 200 (k, v from
    a second projection); the plain twin within bf16's tolerance, and the
    same bits twice."""
    g = _gen(dev, 100 + d)
    heads = 3
    q = torch.randn((2, 136, 3 * heads * d), generator=g, device=dev).to(torch.bfloat16)
    q = q[..., :heads * d]
    _, k, v = torch.randn((2, 200, 3 * heads * d), generator=g, device=dev).to(
        torch.bfloat16).chunk(3, dim=-1)
    before, before_sm90 = flash_attention.launches, attention_sm90.launches
    got = flash_attention(q, k, v, heads)
    assert flash_attention.launches == before + 1
    assert attention_sm90.launches == before_sm90 + 1
    assert _rel(got, attention_plain(q, k, v, heads)) <= TOL[torch.bfloat16]
    assert torch.equal(got, attention_sm90(q, k, v, heads))


def test_attention_sm90_raises_on_what_it_does_not_take(dev):
    x = torch.zeros((1, 256, 64), device=dev)
    with pytest.raises(ValueError):  # f32 runs attention.cu's f32 body
        attention_sm90(x, x, x, 1)
    y = torch.zeros((1, 256, 512), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d = 512 runs the split-d body
        attention_sm90(y, y, y, 1)
    z = torch.zeros((1, 256, 104), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d = 104: no padded width
        attention_sm90(z, z, z, 1)


def test_unet_conv_launches(dev):
    """The tiny bf16 UNet at a 16x16 latent and batch 2 sends its 9 convs
    on the 16^2 plane (conv_in 4 -> 32, the level-0 resblocks, the level-1
    upsample conv, the out conv 32 -> 4) through K4, and no other."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle

    bundle = ModelBundle.random("tiny", seed=0, device=dev).cast("bfloat16")
    g = _gen(dev, 9)
    x = torch.randn((2, 16, 16, 4), generator=g, device=dev)
    ctx = torch.randn((2, 77, 64), generator=g, device=dev)
    before = conv3x3.launches
    with torch.inference_mode():
        M.unet_apply(bundle.unet_cfg, bundle.unet_params, x, torch.tensor([5, 5], device=dev), ctx)
    assert conv3x3.launches == before + 9


def test_bf16_vae_on_card_matches_plain_path(dev):
    """The tiny VAE after cast_vae("bfloat16"): decode and encode through
    the kernels (K1 at S = 256, K3, K4 on the 16^2..32^2 planes) against the
    plain twins on CPU copies of the same weights; bf16 activations, so
    relative L2 <= 2e-2."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle, _tree_map

    bundle = ModelBundle.random("tiny", seed=0, device=dev).cast_vae("bfloat16")
    cpu = _tree_map(lambda a: a.cpu(), bundle.vae_params)
    g = torch.Generator().manual_seed(1)
    z = torch.randn((1, 16, 16, 4), generator=g)
    img = torch.rand((1, 32, 32, 3), generator=g) * 2 - 1
    with torch.inference_mode():
        got = M.vae_decode(bundle.vae_cfg, bundle.vae_params, z.to(dev)).cpu()
        want = M.vae_decode(bundle.vae_cfg, cpu, z)
        assert float((got - want).norm() / want.norm()) <= 2e-2
        got = M.vae_encode(bundle.vae_cfg, bundle.vae_params, img.to(dev)).mean.cpu()
        want = M.vae_encode(bundle.vae_cfg, cpu, img).mean
        assert float((got - want).norm() / want.norm()) <= 2e-2


def test_tiny_slice_on_card_matches_plain_path(dev):
    """The tiny model through the kernels (bf16 UNet, f32 VAE) against the
    plain twins on CPU copies of the same weights."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle, RenderConfig, txt2img
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    bundle = ModelBundle.random("tiny", seed=0, device=dev).cast("bfloat16")
    cpu_unet = _tree_map(lambda a: a.cpu(), bundle.unet_params)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 16, 4), generator=g)
    t = torch.tensor([901, 41])
    ctx = torch.randn((2, 77, 64), generator=g)
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        want = M.unet_apply(bundle.unet_cfg, cpu_unet, x, t, ctx)
    assert float((got - want).norm() / want.norm()) <= 5e-2

    z = torch.randn((1, 12, 12, 4), generator=g)
    with torch.inference_mode():
        got = M.vae_decode(bundle.vae_cfg, bundle.vae_params, z.to(dev)).cpu()
        want = M.vae_decode(bundle.vae_cfg, _tree_map(lambda a: a.cpu(), bundle.vae_params), z)
    assert float((got - want).norm() / want.norm()) <= 1e-4

    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0
    # 128x128: 16x16 latents, so the level-0 self-attention (S = 256) and
    # the VAE mid-block reach K1
    images, latents = txt2img(bundle, "a cat", cfg=RenderConfig(
        steps=3, width=128, height=128, batch_size=2))
    assert images.shape == (2, 32, 32, 3) and torch.isfinite(latents).all()
    # K5 and K6 are not on this path (the default attention route, no probe)
    for name in ("attention", "geglu_ff", "group_norm", "conv3x3"):
        assert ops.KERNEL_WRAPPERS[name].launches > 0
    assert ops.KERNEL_WRAPPERS["attention_cm"].launches == 0


def test_tiny_f32_slice_on_card_matches_plain_path(dev):
    """The tiny model as ``ModelBundle.random`` makes it, with no cast (f32
    UNet: K2's and K4's f32 bodies, K1's fused 3xTF32 body), against the
    plain twins on CPU copies of the same weights (TF32 off), and a short
    txt2img through the kernels."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle, RenderConfig, txt2img
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    bundle = ModelBundle.random("tiny", seed=0, device=dev)
    assert bundle.unet_cfg.dtype == "float32"
    cpu_unet = _tree_map(lambda a: a.cpu(), bundle.unet_params)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 16, 4), generator=g)
    t = torch.tensor([901, 41])
    ctx = torch.randn((2, 77, 64), generator=g)
    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        want = M.unet_apply(bundle.unet_cfg, cpu_unet, x, t, ctx)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    k = ops.KERNEL_WRAPPERS
    assert k["geglu_ff_f32_sm90"].launches > 0
    assert k["geglu_ff"].launches == k["geglu_ff_f32_sm90"].launches
    assert k["conv3x3"].launches == 9 and k["conv3x3_sm90"].launches == 0

    images, latents = txt2img(bundle, "a cat", cfg=RenderConfig(
        steps=3, width=128, height=128, batch_size=2))
    assert images.shape == (2, 32, 32, 3) and torch.isfinite(latents).all()


def test_default_bundle_renders_on_the_card_without_a_cast(dev):
    """``ModelBundle.random()`` with no arguments: the tiny config on the
    card with an f32 UNet, as the JAX package's default; txt2img renders
    through K2's f32 body."""
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle, RenderConfig, txt2img

    bundle = ModelBundle.random()
    assert bundle.device.type == "cuda" and bundle.unet_cfg.dtype == "float32"
    before = geglu_ff_f32_sm90.launches
    images, latents = txt2img(bundle, "a lighthouse", cfg=RenderConfig(
        steps=2, width=64, height=64, batch_size=1))
    assert images.dtype.name == "uint8" and images.shape[0] == 1
    assert torch.isfinite(latents).all() and geglu_ff_f32_sm90.launches > before


def _k5_kernels(dtype, b, h, sq, skv, d):
    """Kernels a K5 call launches: one, or the f32 unfused route's split
    kernels and three a pass (d > 160)."""
    return f32_sm90_launches(b, h, sq, skv) if k5_body(dtype, d) == "f32_unfused" else 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 40, 64, 80, 160, 256])
def test_attention_cm_hdbs(dev, dtype, d):
    """K5 on [H, D, B, S] slices of one [3C, B, S] projection (the cm
    block's layout), S = 200: three full 64-key tiles and a ragged one."""
    g = _gen(dev, d)
    b, h, s = 2, 3, 200
    qkv = torch.randn((3, h, d, b, s), generator=g, device=dev).to(dtype)
    q, k, v = (qkv[i].permute(2, 0, 1, 3) for i in range(3))
    before = attention_dmajor.launches
    got = attention_dmajor(q, k, v, d**-0.5, out_hdbs=True)
    assert attention_dmajor.launches == before + _k5_kernels(dtype, b, h, s, s, d)
    assert got.shape == (b, h, d, s) and got.permute(1, 2, 0, 3).is_contiguous()
    assert _rel(got, attention_dmajor_plain(q, k, v, d**-0.5)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 40, 80, 160, 256])
def test_attention_cm_kcanon(dev, dtype, d):
    """K5 with K read in place from a [B, S, 3*H*D] projection, Sq != Skv,
    neither a multiple of the 64-wide tiles; and the whole kcanon route
    against the plain attention."""
    g = _gen(dev, 3 * d)
    b, h, sq, skv = 2, 3, 104, 328
    qkv = torch.randn((b, skv, 3 * h * d), generator=g, device=dev).to(dtype)
    _, k, v = qkv.chunk(3, dim=-1)
    q = torch.randn((b, sq, h * d), generator=g, device=dev).to(dtype)
    q_t = q.reshape(b, sq, h, d).permute(0, 2, 3, 1).contiguous()
    v_t = v.reshape(b, skv, h, d).permute(0, 2, 3, 1).contiguous()
    k_n = k.reshape(b, skv, h, d).permute(0, 2, 1, 3)
    before = attention_dmajor.launches
    got = attention_dmajor(q_t, k_n, v_t, 0.2, k_canonical=True)
    assert attention_dmajor.launches == before + _k5_kernels(dtype, b, h, sq, skv, d)
    assert got.is_contiguous()
    assert _rel(got, attention_dmajor_plain(q_t, k_n, v_t, 0.2, k_canonical=True)) <= TOL[dtype]
    assert _rel(attention_kcanon(q, k, v, h), attention_plain(q, k, v, h)) <= TOL[dtype]


def test_attention_cm_raises_on_what_it_does_not_take(dev):
    g = _gen(dev, 1)
    q = torch.randn((1, 2, 40, 136), generator=g, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):  # S % 8 != 0
        attention_dmajor(q[..., :130], q[..., :130], q[..., :130], 0.1)
    with pytest.raises(ValueError):  # the sequence axis is not the contiguous one
        t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        attention_dmajor(t, t, t, 0.1)
    with pytest.raises(TypeError):
        attention_dmajor(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError):  # d = 200 pads to 208, a width K5 does not have
        w = torch.randn((1, 2, 200, 136), generator=g, device=dev).to(torch.bfloat16)
        attention_dmajor(w, w, w, 0.1)


# K5's Hopper bodies: bf16 at every padded width K1 has (and d = 40), f32
# at the SD head dims, the narrowest, and the unfused route's 256
K5_CASES = ([(torch.bfloat16, d) for d in (16, 32, 40, 48, 64, 80, 96, 128, 160, 256)]
            + [(torch.float32, d) for d in (4, 40, 80, 160, 256)])
K5_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # f32: 3xTF32, TF32 off in the twin


def _k5_operands(dev, dtype, d, k_canonical, b, h, sq, skv, seed):
    """hdbs: q, k, v the [H, D, B, S] slices of one [3, H, D, B, S]
    projection; kcanon: q and v contiguous d-major, k read in place from a
    [B, Skv, 3 H D] projection."""
    g = _gen(dev, seed)
    if k_canonical:
        q = torch.randn((b, h, d, sq), generator=g, device=dev).to(dtype)
        kv = torch.randn((b, skv, 3 * h * d), generator=g, device=dev).to(dtype)
        k = kv[..., h * d:2 * h * d].reshape(b, skv, h, d).permute(0, 2, 1, 3)
        v = torch.randn((b, h, d, skv), generator=g, device=dev).to(dtype)
        return q, k, v
    qkv = torch.randn((3, h, d, b, max(sq, skv)), generator=g, device=dev).to(dtype)
    return (qkv[0, ..., :sq].permute(2, 0, 1, 3), qkv[1, ..., :skv].permute(2, 0, 1, 3),
            qkv[2, ..., :skv].permute(2, 0, 1, 3))


@pytest.mark.parametrize("k_canonical", [False, True])
@pytest.mark.parametrize("dtype,d", K5_CASES)
def test_attention_cm_sm90_ragged_at_every_width(dev, dtype, d, k_canonical):
    """K5's Hopper bodies on ragged Sq != Skv (1000 / 1336: a ragged query
    tile and key tile), both layouts, against the plain twin; each call
    counted on attention_dmajor and the Hopper bodies' counts (and the f32
    body's)."""
    b, h, sq, skv = 2, 3, 1000, 1336
    q, k, v = _k5_operands(dev, dtype, d, k_canonical, b, h, sq, skv, d + 7 * k_canonical)
    n = _k5_kernels(dtype, b, h, sq, skv, d)
    before = (attention_dmajor.launches, attention_cm_sm90_count.launches)
    before32 = attention_cm_f32_sm90_count.launches
    got = attention_dmajor(q, k, v, d**-0.5, k_canonical=k_canonical, out_hdbs=not k_canonical)
    assert (attention_dmajor.launches, attention_cm_sm90_count.launches) == (before[0] + n,
                                                                              before[1] + n)
    assert attention_cm_f32_sm90_count.launches == before32 + (n if dtype == torch.float32 else 0)
    assert got.shape == (b, h, d, sq)
    want = attention_dmajor_plain(q, k, v, d**-0.5, k_canonical)
    assert _rel(got, want) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h", [(1, 2), (8, 20)])
def test_attention_cm_sm90_below_and_above_one_block_an_sm(dev, dtype, b, h):
    """B*H = 2 and 160 (x 2 query tiles) blocks against the card's 132 SMs,
    at S = 256, d = 80, both layouts."""
    for k_canonical in (False, True):
        q, k, v = _k5_operands(dev, dtype, 80, k_canonical, b, h, 256, 256, b * h)
        got = attention_dmajor(q, k, v, 80**-0.5, k_canonical=k_canonical)
        want = attention_dmajor_plain(q, k, v, 80**-0.5, k_canonical)
        assert _rel(got, want) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype,sq", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_attention_cm_sm90_takes_fewer_queries_than_a_box(dev, dtype, sq):
    """Sq below one 64-query box (the second box wholly past Sq), both layouts."""
    for k_canonical in (False, True):
        q, k, v = _k5_operands(dev, dtype, 40, k_canonical, 2, 3, sq, 136, sq)
        got = attention_dmajor(q, k, v, 0.1, k_canonical=k_canonical)
        assert _rel(got, attention_dmajor_plain(q, k, v, 0.1, k_canonical)) <= K5_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k_canonical", [False, True])
def test_attention_dmajor_prior_still_matches(dev, dtype, k_canonical):
    """The replaced bodies (csrc/attention_cm.cu) against the same twin;
    their launches count on no wrapper."""
    q, k, v = _k5_operands(dev, dtype, 80, k_canonical, 2, 3, 200, 328, 5)
    before = (attention_dmajor.launches, attention_cm_sm90_count.launches)
    got = attention_dmajor_prior(q, k, v, 0.1, k_canonical=k_canonical, out_hdbs=True)
    assert (attention_dmajor.launches, attention_cm_sm90_count.launches) == before
    assert got.permute(1, 2, 0, 3).is_contiguous()
    assert _rel(got, attention_dmajor_plain(q, k, v, 0.1, k_canonical)) <= TOL[dtype]


def test_k5_config_mirror_matches_the_c_entries(dev):
    """ops.attention.k5_config against the Cfg / CfgF the kernels compile
    (query rows, key tile, stages, shared-memory bytes, fused or not), at
    every head dim each dtype takes."""
    import ctypes

    from complex_prompt_diffusion_tpu_torch import _build

    lib = _build.kernel_library()
    for dtype, ds, fn in ((torch.bfloat16, range(8, 257, 8), lib.cpd_attention_cm_sm90_bf16_config),
                          (torch.float32, range(4, 257, 4), lib.cpd_attention_cm_f32_sm90_config)):
        for d in ds:
            for kc in (0, 1):
                buf = (ctypes.c_int * 5)()
                err = fn(d, kc, ctypes.addressof(buf))
                try:
                    c = k5_config(dtype, d, bool(kc))
                except ValueError:
                    assert err != 0, (dtype, d)
                    continue
                assert err == 0
                assert tuple(buf) == (c.query_rows, c.key_tile, c.stages, c.smem_bytes,
                                      int(c.body != "f32_unfused")), (dtype, d, kc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_self_attention_cm_block(dev, dtype):
    """The fused cm block (projections + K5) against its plain twin."""
    g = _gen(dev, 5)
    b, s, c, h = 2, 256, 256, 4
    x = torch.randn((b, s, c), generator=g, device=dev).to(dtype)
    ws = [(torch.randn((c, c), generator=g, device=dev) * c**-0.5).to(dtype) for _ in range(4)]
    bo = (torch.randn(c, generator=g, device=dev) * 0.1).to(dtype)
    before = attention_dmajor.launches
    got = self_attention_cm(x, *ws, bo, h)
    assert attention_dmajor.launches == before + 1
    assert _rel(got, self_attention_cm_plain(x, *ws, bo, h)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c,co", [(1, 8, 8, 128, 128), (2, 16, 16, 256, 128),
                                        (1, 32, 32, 128, 256), (3, 10, 12, 40, 24),
                                        (1, 8, 8, 8, 8)])
def test_wino3x3(dev, dtype, b, h, w, c, co):
    """K6 at the JAX test's sizes and on ragged ones (tiles, C and Co that
    are not multiples of the block's 32 x 64 tile and 32-channel chunk)."""
    g = _gen(dev, c + co)
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(dtype)
    k = (torch.randn((3, 3, c, co), generator=g, device=dev) * 0.05).to(dtype)
    bias = torch.randn(co, generator=g, device=dev).to(dtype)
    before = wino3x3.launches
    got = wino3x3(x, k, bias)
    # a Hopper body launches its reduction too where its plan splits C
    body = k6_body(dtype, c, co)
    want_launches = (1 if body == "prior" else
                     wino3x3_plan(b, h, w, c, co, dtype=dtype).launches)
    assert wino3x3.launches == before + want_launches
    assert got.shape == (b, h, w, co) and got.dtype == dtype
    u = winograd_weights(k).to(dtype)
    assert _rel(got, wino3x3_plain(x, u, bias)) <= TOL[dtype]
    # and the direct conv, at the documented bf16 deviation
    ref = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
                                     bias.float(), padding=1).permute(0, 2, 3, 1)
    assert _rel(got, ref) <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


def test_wino3x3_raises_on_what_it_does_not_take(dev):
    g = _gen(dev, 2)
    x = torch.randn((1, 8, 8, 12), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((3, 3, 12, 16), generator=g, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 needs C % 8 == 0
        wino3x3(x, k, torch.zeros(16, device=dev))
    with pytest.raises(TypeError):
        wino3x3(x.half(), k.half(), torch.zeros(16, device=dev))
    with pytest.raises(ValueError):  # f32 needs Co % 4 == 0
        wino3x3(x.float(), k.float()[..., :6], torch.zeros(6, device=dev))


def _wino_case(dev, b, h, w, c, co, seed):
    g = _gen(dev, seed)
    x = torch.randn((b, h, w, c), generator=g, device=dev).to(torch.bfloat16)
    k = ((torch.rand((3, 3, c, co), generator=g, device=dev) * 2 - 1) * (9 * c) ** -0.5).to(
        torch.bfloat16)
    bias = ((torch.rand(co, generator=g, device=dev) * 2 - 1) * 0.1).to(torch.bfloat16)
    return x, k, bias, winograd_weights(k).to(torch.bfloat16)


@pytest.mark.parametrize("hw,c,co", B1_UNET_CONVS)
def test_wino3x3_sm90_at_the_unet_resblock_shapes(dev, hw, c, co):
    """K6's Hopper body at every ResBlock conv of phase 9 (UNet batch 2),
    through the route, with the kernels its plan predicts."""
    x, k, bias, u = _wino_case(dev, 2, hw, hw, c, co, hw + c + co)
    before = (wino3x3.launches, wino3x3_sm90.launches, wino3x3_prior.launches)
    got = wino3x3(x, k, bias, u=u)
    n = wino3x3_plan(2, hw, hw, c, co).launches
    assert (wino3x3.launches, wino3x3_sm90.launches, wino3x3_prior.launches) == (
        before[0] + n, before[1] + n, before[2])
    assert _rel(got, wino3x3_plain(x, u, bias)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("b,h,w,c,co", [(1, 20, 12, 64, 192), (3, 10, 14, 128, 64),
                                        (1, 36, 20, 192, 128), (1, 8, 8, 128, 128),
                                        (2, 64, 64, 320, 320)])
def test_wino3x3_sm90_ragged_tiles_at_every_split_count(dev, b, h, w, c, co):
    """Tile rectangles that overhang the plane (20 x 12: 10 x 6 tiles in
    8 x 8 and 4 x 16 rectangles), Co not a multiple of the block's 128, and
    every split count of C; the splits are summed in a fixed order, so a
    second run writes the same bits."""
    x, k, bias, u = _wino_case(dev, b, h, w, c, co, h * w)
    want = wino3x3_plain(x, u, bias)
    kchunks = c // 64
    for splits in sorted({1, 2, kchunks} & set(range(1, kchunks + 1))):
        got = wino3x3_sm90(x, k, bias, u=u, splits=splits)
        assert _rel(got, want) <= TOL[torch.bfloat16], splits
        assert torch.equal(got, wino3x3_sm90(x, k, bias, u=u, splits=splits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wino3x3_prior_still_matches(dev, dtype):
    x, k, bias, u = _wino_case(dev, 2, 16, 16, 128, 64, 5)
    x, k, bias, u = (t.to(dtype) for t in (x, k, bias, u))
    before = wino3x3_prior.launches
    got = wino3x3_prior(x, k, bias, u=u)
    assert wino3x3_prior.launches == before + 1
    assert _rel(got, wino3x3_plain(x, u, bias)) <= TOL[dtype]


def test_wino3x3_sm90_raises_on_what_it_does_not_take(dev):
    x, k, bias, _ = _wino_case(dev, 1, 8, 8, 64, 64, 3)
    with pytest.raises(ValueError):  # f32: the first body's
        wino3x3_sm90(x.float(), k.float(), bias.float())
    with pytest.raises(ValueError):  # C % 64 != 0
        wino3x3_sm90(x[..., :32], k[:, :, :32], bias)


def _wino_f32_case(dev, b, h, w, c, co, seed):
    x, k, bias, _ = _wino_case(dev, b, h, w, c, co, seed)
    x, k, bias = x.float() + 0.01 * torch.randn(x.shape, generator=_gen(dev, seed), device=dev), \
        k.float(), bias.float()
    return x, k, bias, winograd_weights(k)


@pytest.mark.parametrize("b,hw,c,co", [(2, hw, c, co) for hw, c, co in B1_UNET_CONVS]
                         + [(1, 32, 512, 512)])
def test_wino3x3_f32_sm90_at_the_phase9_shapes(dev, b, hw, c, co):
    """K6's f32 body at every ResBlock conv of phase 9 (UNet batch 2) and
    phase 1's B1 32^2 512->512, through the route, with the kernels its
    plan predicts: 1e-5 of the TF32-off twin, the same bits twice."""
    x, k, bias, u = _wino_f32_case(dev, b, hw, hw, c, co, hw + c + co)
    before = (wino3x3.launches, wino3x3_f32_sm90.launches, wino3x3_prior.launches)
    got = wino3x3(x, k, bias, u=u)
    n = wino3x3_plan(b, hw, hw, c, co, dtype=torch.float32).launches
    assert (wino3x3.launches, wino3x3_f32_sm90.launches, wino3x3_prior.launches) == (
        before[0] + n, before[1] + n, before[2])
    assert got.dtype == torch.float32
    assert _rel(got, wino3x3_plain(x, u, bias)) <= 1e-5
    assert torch.equal(got, wino3x3(x, k, bias, u=u))


@pytest.mark.parametrize("b,h,w,c,co", [(1, 20, 12, 64, 192), (3, 10, 14, 128, 64),
                                        (1, 36, 20, 96, 128), (1, 8, 8, 32, 64),
                                        (2, 64, 64, 320, 320)])
def test_wino3x3_f32_sm90_ragged_tiles_at_every_split_count(dev, b, h, w, c, co):
    """Tile rectangles that overhang the plane, Co not a multiple of the
    block's 128, C of 1 to 10 chunks of 32, and every split count of C: 1e-5
    of the twin, and a second run writes the same bits."""
    x, k, bias, u = _wino_f32_case(dev, b, h, w, c, co, h * w + c)
    want = wino3x3_plain(x, u, bias)
    kchunks = c // 32
    for splits in sorted({1, 2, 3, kchunks} & set(range(1, kchunks + 1))):
        got = wino3x3_f32_sm90(x, k, bias, u=u, splits=splits)
        assert _rel(got, want) <= 1e-5, splits
        assert torch.equal(got, wino3x3_f32_sm90(x, k, bias, u=u, splits=splits))


def test_wino3x3_f32_sm90_raises_on_what_it_does_not_take(dev):
    x, k, bias, _ = _wino_f32_case(dev, 1, 8, 8, 64, 64, 3)
    with pytest.raises(ValueError):  # bf16: the other Hopper body's
        wino3x3_f32_sm90(x.bfloat16(), k.bfloat16(), bias.bfloat16())
    with pytest.raises(ValueError):  # C % 32 != 0
        wino3x3_f32_sm90(x[..., :48], k[:, :, :48], bias)
    with pytest.raises(ValueError):  # Co % 64 != 0
        wino3x3_f32_sm90(x, k[..., :32], bias[:32])
    # the route leaves those f32 widths to the first body
    before = (wino3x3_f32_sm90.launches, wino3x3_prior.launches)
    wino3x3(x[..., :48], k[:, :, :48], bias)
    assert (wino3x3_f32_sm90.launches, wino3x3_prior.launches) == (before[0], before[1] + 1)


def test_cm_unet_on_card_matches_default_route(dev):
    """A one-level C = 128 UNet at a 16x16 latent: with attn_route="cm" its
    four self-attention sites go through K5 and the result stays with the
    default route's (bf16, relative L2 <= 2e-2)."""
    import dataclasses

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import _unzero_kernels

    cfg = dataclasses.replace(M.UNetConfig.tiny(context_dim=32), model_channels=128,
                              channel_mult=(1,), attention_resolutions=(1,), num_heads=2,
                              attn_route="cm")
    g = _gen(dev, 4)
    params = convert.unet_params(_unzero_kernels(g, M.init_unet(g, cfg, dev)), dev,
                                 torch.bfloat16)
    x = torch.randn((2, 16, 16, 4), generator=g, device=dev)
    ctx = torch.randn((2, 77, 32), generator=g, device=dev)
    t = torch.tensor([900, 40], device=dev)
    before = attention_dmajor.launches
    with torch.inference_mode():
        got = M.unet_apply(cfg, params, x, t, ctx)
        assert attention_dmajor.launches == before + 4
        want = M.unet_apply(dataclasses.replace(cfg, attn_route="bsc"), params, x, t, ctx)
    assert attention_dmajor.launches == before + 4
    assert float((got - want).norm() / want.norm()) <= 2e-2


# ---- the probes of the TPU tuning scripts: K7, K8, K9 ----

@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("mode", ["full", "scores", "max", "exp", "pv", "rowsum", "loads"])
def test_attention_probe_modes(dev, mode, d):
    from complex_prompt_diffusion_tpu_torch.ops.probes.attention import (
        attention_probe,
        attention_probe_plain,
    )

    g = _gen(dev, d)
    q = torch.randn((2, 136, 2 * d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((2, 200, 2 * d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    before = attention_probe.launches
    got = attention_probe(q, k, v, 2, d**-0.5, mode)
    assert attention_probe.launches == before + 1
    assert _rel(got, attention_probe_plain(q, k, v, 2, d**-0.5, mode)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("denom,exp,unnorm,tile", [("sum", "exp", False, None),
                                                   ("ones", "exp2", False, None),
                                                   ("ones", "exp", False, None),
                                                   ("ones", "exp2", True, None),
                                                   ("sum", "exp2", False, 64)])
def test_attention_probe_flags(dev, d, denom, exp, unnorm, tile):
    """Each flag at K1's key tile (None), and 64-key tiles at K1's other
    choices (K1's own tile at d = 160)."""
    from complex_prompt_diffusion_tpu_torch.ops.probes.attention import (
        attention_probe,
        attention_probe_plain,
    )

    g = _gen(dev, d + 1)
    q = torch.randn((2, 72, 8 * d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((2, 264, 8 * d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    args = (q, k, v, 8, d**-0.5, "full", denom, exp, unnorm, tile)
    got = attention_probe(*args)
    assert got.dtype == (torch.float32 if unnorm else torch.bfloat16)
    assert _rel(got, attention_probe_plain(*args)) <= TOL[torch.bfloat16]


def test_attention_probe_f32_scores_and_k5_scores(dev):
    from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA

    g = _gen(dev, 31)
    for d in (80, 160):  # the fused f32 body's scores mode at the other levels
        q, k, v = (torch.randn((2, s, 2 * d), generator=g, device=dev) for s in (136, 200, 200))
        got = PA.attention_probe(q, k, v, 2, d**-0.5, "scores")
        assert _rel(got, PA.attention_probe_plain(q, k, v, 2, d**-0.5, "scores")) <= 1e-5
    q, k, v = (torch.randn((2, s, 2 * 40), generator=g, device=dev) for s in (136, 200, 200))
    got = PA.attention_probe(q, k, v, 2, 40**-0.5, "scores")
    assert _rel(got, PA.attention_probe_plain(q, k, v, 2, 40**-0.5, "scores")) <= 1e-4
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    qd, kd, vd = (PA.to_dmajor(t, 2) for t in (q, k, v))
    kc = k.view(2, 200, 2, 40).permute(0, 2, 1, 3)
    for kk, canon in ((kd, False), (kc, True)):
        got = PA.attention_dmajor_scores(qd, kk, vd, 40**-0.5, canon)
        want = PA.attention_dmajor_scores_plain(qd, kk, vd, 40**-0.5, canon)
        assert _rel(got, want) <= TOL[torch.bfloat16]
    # the UNet-interface forms hold to K1
    want = flash_attention(q, k[:, :136], v[:, :136], 2, 40**-0.5)
    for fn in (PA.v3_attention, PA.h2_attention):
        assert _rel(fn(q, k[:, :136], v[:, :136], 2, 40**-0.5), want) <= TOL[torch.bfloat16]


def test_attention_probe_raises_on_what_it_was_not_built_for(dev):
    from complex_prompt_diffusion_tpu_torch.ops.probes.attention import attention_probe

    q = torch.zeros((1, 64, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d = 64: not a UNet level
        attention_probe(q, q, q, 1, 0.125)
    q = torch.zeros((1, 64, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # K7 takes d in 40, 80, 160
        attention_probe(q, q, q, 1, 0.125, denom="ones")
    q = torch.zeros((1, 64, 40), device=dev)
    with pytest.raises(ValueError):  # f32 operands: the scores mode only
        attention_probe(q, q, q, 1, 0.125)
    q = torch.zeros((1, 64, 160), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 128-key tiles do not fit at d = 160
        attention_probe(q, q, q, 1, 0.125, kv_tile=128)


def test_attention_probe_c_entry_refuses_what_it_has_no_instantiation_for(dev):
    """The C entry returns an error (and launches nothing) for combinations
    the wrapper's check refuses: 128-key tiles at d = 160, an ablated mode
    at 64 keys where K1 takes 128, exp with the unnormalized output."""
    from complex_prompt_diffusion_tpu_torch import _build

    lib = _build.kernel_library()
    for d, mode, denom, exp2, unnorm, tile in ((160, 0, 0, 1, 0, 128), (40, 1, 0, 1, 0, 64),
                                               (80, 0, 1, 0, 1, 128), (48, 0, 0, 1, 0, 128)):
        q = torch.zeros((1, 64, d), device=dev, dtype=torch.bfloat16)
        o = torch.empty_like(q)
        err = lib.cpd_probe_attention_bf16(q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
                                           1, 1, 64, 64, d, 64 * d, d, 64 * d, d, 64 * d, d, 0.1,
                                           mode, denom, exp2, unnorm, tile,
                                           _build.stream_ptr(q.device))
        assert err != 0, (d, mode, denom, exp2, unnorm, tile)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_attention_probe_full_at_k1_choices_writes_k1_bits(dev, d):
    """K7's full mode at K1's choices (row sums, exp2, K1's key tile) is
    K1's own instantiation of the loop: the same bits as flash_attention, on
    strided views and ragged lengths."""
    from complex_prompt_diffusion_tpu_torch.ops.probes.attention import attention_probe

    g = _gen(dev, 3 * d)
    qkv = torch.randn((2, 333, 3 * 4 * d), generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    assert torch.equal(attention_probe(q, k, v, 4, d**-0.5), flash_attention(q, k, v, 4, d**-0.5))
    assert torch.equal(attention_probe(q, k, v, 4, d**-0.5, kv_tile=k1_bf16_key_tile(d)),
                       flash_attention(q, k, v, 4, d**-0.5))


@pytest.mark.parametrize("kw", [dict(), dict(kv_tile=128), dict(mode="scores"),
                                dict(mode="pv"), dict(denom="ones", unnormalized=True)],
                         ids=["full", "full128", "scores", "pv", "h2"])
def test_attention_probe_prior_still_matches(dev, kw):
    """K7's replaced loops (the mma.sync loop at its 64-key tiles, K5's,
    K1's f32 FMA loop) against the plain twin, counted on their own count."""
    from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA

    g = _gen(dev, 17)
    q = torch.randn((2, 136, 2 * 80), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((2, 200, 2 * 80), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    before = (PA.attention_probe_prior.launches, PA.attention_probe.launches)
    got = PA.attention_probe_prior(q, k, v, 2, 80**-0.5, **kw)
    assert (PA.attention_probe_prior.launches, PA.attention_probe.launches) == (
        before[0] + 1, before[1])
    want = PA._plain(q, k, v, 2, 80**-0.5, kw.get("mode", "full"), kw.get("denom", "sum"),
                     "exp2", kw.get("unnormalized", False))
    assert _rel(got, want) <= TOL[torch.bfloat16]
    qd, kd, vd = (PA.to_dmajor(t, 2) for t in (q, k, v))
    assert _rel(PA.attention_dmajor_scores_prior(qd, kd, vd, 80**-0.5),
                PA.attention_dmajor_scores_plain(qd, kd, vd, 80**-0.5)) <= TOL[torch.bfloat16]
    q, k, v = (t.float() for t in (q, k, v))
    assert _rel(PA.attention_probe_prior(q, k, v, 2, 80**-0.5, "scores"),
                PA.attention_probe_plain(q, k, v, 2, 80**-0.5, "scores")) <= 1e-4


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 12, 12, 320), (1, 8, 8, 1280),
                                   (1, 64, 64, 320), (2, 7, 9, 1280)])
@pytest.mark.parametrize("mode,splits,mma", [("full", None, False), ("copy", None, False),
                                             ("stats", None, False), ("norm", None, False),
                                             ("bf16sig", None, False), ("full", None, True),
                                             ("full", 1, False), ("full", 5, False)])
def test_group_norm_probe(dev, shape, mode, splits, mma):
    """Every K8 mode and flag against its twin, on K3's slab form (the small
    planes) and split form (1 x 64^2 x 320), with the kernels its plan
    predicts (the library reports them)."""
    g = _gen(dev, shape[-1])
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = (torch.randn(shape[-1], generator=g, device=dev) * 0.5 + 1).to(torch.bfloat16)
    beta = (torch.randn(shape[-1], generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = group_norm_probe.launches
    got = group_norm_probe(x, gamma, beta, mode, splits=splits, mma=mma)
    plan = probe_plan(shape[0], shape[1] * shape[2], shape[3], 32, mode, splits)
    assert group_norm_probe.launches == before + plan.launches
    want = group_norm_probe_plain(x, gamma, beta, mode, splits=splits, mma=mma)
    if mode in ("copy", "stats"):
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("side,c", GN4_PLANES)
def test_group_norm_probe_full_is_k3(dev, side, c):
    """K8's full mode at K3's plan is K3's own instantiation of its Hopper
    kernels: the same bits as ``group_norm_nhwc`` at every plane phase 10
    times (batch 8), slab and split form."""
    g = _gen(dev, side + c)
    x = torch.randn((8, side, side, c), generator=g, device=dev).to(torch.bfloat16)
    gamma = torch.randn(c, generator=g, device=dev).to(torch.bfloat16)
    beta = torch.randn(c, generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(group_norm_probe(x, gamma, beta), group_norm_nhwc(x, gamma, beta, 32,
                                                                         1e-5, True))


@pytest.mark.parametrize("side,c", [(64, 320), (64, 640)])
def test_group_norm_probe_forced_runs_on_k3s_grid(dev, side, c):
    """Forced splits keep K3's split grid (8 x 16 blocks at batch 8): one
    run is K3's split form, the same bits as ``group_norm_nhwc``; 2 to 16
    runs a sample (perf_gn4's chunk 2048 .. 256) stream each tile's share of
    every run and agree with the twin."""
    g = _gen(dev, side * c)
    x = (torch.randn((8, side, side, c), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = (torch.randn(c, generator=g, device=dev) * 0.5 + 1).to(torch.bfloat16)
    beta = (torch.randn(c, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    k3 = group_norm_nhwc(x, gamma, beta, 32, 1e-5, True)
    assert torch.equal(group_norm_probe(x, gamma, beta, splits=1), k3)
    want = group_norm_probe_plain(x, gamma, beta)
    for runs in (2, 4, 8, 16):
        plan = probe_plan(8, side * side, c, 32, "full", runs,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
        assert plan.tiles * 8 >= 128 and plan.runs == runs
        assert _rel(group_norm_probe(x, gamma, beta, splits=runs), want) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("kw", [dict(), dict(mode="copy"), dict(mode="bf16sig"),
                                dict(mma=True), dict(splits=3)])
def test_group_norm_probe_prior_still_runs(dev, kw):
    """K8's replaced body (one block a (sample, group) slice) against the
    twin, counted on its own count."""
    g = _gen(dev, 41)
    x = (torch.randn((2, 12, 12, 320), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = torch.ones(320, device=dev, dtype=torch.bfloat16)
    beta = torch.zeros(320, device=dev, dtype=torch.bfloat16)
    before = (group_norm_probe_prior.launches, group_norm_probe.launches)
    got = group_norm_probe_prior(x, gamma, beta, **kw)
    assert (group_norm_probe_prior.launches, group_norm_probe.launches) == (
        before[0] + (2 if "splits" in kw else 1), before[1])
    assert _rel(got, group_norm_probe_plain(x, gamma, beta, **kw)) <= TOL[torch.bfloat16]


def test_group_norm_probe_refuses_what_k3s_forms_refuse(dev):
    """C % 8 != 0 and more than 256 groups: K3's Hopper forms refuse them,
    and K8 raises ValueError on the card (no kernel of another form)."""
    before = group_norm_probe.launches
    for shape, groups in (((1, 8, 8, 36), 4), ((1, 8, 8, 512), 512)):
        x = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
        g = torch.ones(shape[-1], device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            group_norm_probe(x, g, g, num_groups=groups)
    assert group_norm_probe.launches == before


@pytest.mark.parametrize("stages", [1, 3, 4, 8])
@pytest.mark.parametrize("convert", [False, True])
@pytest.mark.parametrize("rows", [4, 64, 1024])
def test_stream_copy(dev, rows, convert, stages):
    from complex_prompt_diffusion_tpu_torch.ops.probes.stream import stream_copy

    x = torch.randn((3, 1024, 40), generator=_gen(dev, rows), device=dev).to(torch.bfloat16)
    before = stream_copy.launches
    assert torch.equal(stream_copy(x, rows, convert, stages), x)
    assert stream_copy.launches == before + 1
    assert torch.equal(stream_copy_prior(x, rows, convert, stages), x)


@pytest.mark.parametrize("stages", [1, 3, 4, 8])
@pytest.mark.parametrize("convert", [False, True])
@pytest.mark.parametrize("hw,c", COPY_SHAPES)
def test_stream_copy_at_the_script_shapes(dev, hw, c, convert, stages):
    """K9's Hopper body at the copy scripts' shapes, every tile size of
    tools/probe_groupnorm.py: bit-exact, one launch a call."""
    x = torch.randn((8, hw, c), generator=_gen(dev, hw + c), device=dev).to(torch.bfloat16)
    for rows in dict.fromkeys((hw, 2048, 1024, 512, 256, 64, 16)):
        if rows <= hw:
            before = stream_copy.launches
            assert torch.equal(stream_copy(x, rows, convert, stages), x), rows
            assert stream_copy.launches == before + 1
