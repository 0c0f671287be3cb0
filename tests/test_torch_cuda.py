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
    attention_dmajor,
    attention_dmajor_plain,
    attention_kcanon,
    attention_plain,
    flash_attention,
    self_attention_cm,
    self_attention_cm_plain,
)
from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3, conv3x3_plain
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    gn_splits,
    group_norm_nhwc,
    group_norm_plain,
)
from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_ff, geglu_ff_plain
from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
    wino3x3,
    wino3x3_plain,
    winograd_weights,
)

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
    """The split-d kernel (256 < d <= 512, the VAE mid-block): query and
    key counts that are not multiples of its 64-row and 32-key tiles, and
    k/v as strided views."""
    g = _gen(dev, d)
    kv = torch.randn((2, 300, 2 * d), generator=g, device=dev).to(torch.bfloat16)
    k, v = kv.chunk(2, dim=-1)
    q = torch.randn((2, 100, d), generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, 1)
    assert flash_attention.launches == before + 1
    assert _rel(got, attention_plain(q, k, v, 1)) <= TOL[torch.bfloat16]


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
    assert geglu_ff.launches == before + 2  # GEMM1 with the GEGLU epilogue, GEMM2
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert _rel(got, geglu_ff_plain(*args)) <= TOL[torch.bfloat16]
    with pytest.raises(TypeError):
        geglu_ff(x.float(), *args[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize(
    "shape", [(3, 7, 5, 96), (2, 96, 160, 96), (2, 9, 11, 320), (2, 12, 10, 128),
              (1, 40, 24, 256), (2, 6, 7, 512)]
)
def test_group_norm_ragged(dev, dtype, silu, shape):
    """Channels per group 3, 10, 4, 8 and 16 (every vector width K3 picks,
    in both dtypes), on small planes and on one whose group slices span
    many loop trips."""
    g = _gen(dev, 3)
    x = (2 * torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    c = shape[-1]
    gamma = (1 + 0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(c, generator=g, device=dev)).to(dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels = 1 if gn_splits(shape[0], shape[1] * shape[2], c, 32, sms) == 1 else 2
    before = group_norm_nhwc.launches
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, silu)
    assert group_norm_nhwc.launches == before + kernels
    assert got.dtype == dtype
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, silu)) <= TOL[dtype]


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
    """A batch-1 plane whose 32 (sample, group) blocks leave SMs idle: K3
    splits each group's pixels over 8 blocks (statistics kernel, then apply
    kernel). The f32 partials merge as centered sums (Chan), so a large
    common offset keeps the f32 tolerance."""
    shape = (1, 256, 256, 64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert gn_splits(1, 256 * 256, 64, 32, sms) > 1
    g = _gen(dev, 11)
    x = (torch.randn(shape, generator=g, device=dev) + (1000.0 if dtype == torch.float32
                                                        else 4.0)).to(dtype)
    gamma = (1 + 0.5 * torch.randn(64, generator=g, device=dev)).to(dtype)
    beta = (0.5 * torch.randn(64, generator=g, device=dev)).to(dtype)
    before = group_norm_nhwc.launches
    got = group_norm_nhwc(x, gamma, beta, 32, 1e-6, True)
    assert group_norm_nhwc.launches == before + 2  # statistics, then apply
    assert _rel(got, group_norm_plain(x, gamma, beta, 32, 1e-6, True)) <= TOL[dtype]


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
    assert attention_dmajor.launches == before + 1
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
    assert attention_dmajor.launches == before + 1
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
    assert wino3x3.launches == before + 1
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
@pytest.mark.parametrize("denom,exp,unnorm,tile", [("sum", "exp", False, 64),
                                                   ("ones", "exp2", False, 64),
                                                   ("ones", "exp", False, 64),
                                                   ("ones", "exp2", True, 64),
                                                   ("sum", "exp2", False, 128)])
def test_attention_probe_flags(dev, d, denom, exp, unnorm, tile):
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
    with pytest.raises(ValueError):  # d = 64 pads to 64: not a UNet level
        attention_probe(q, q, q, 1, 0.125)
    q = torch.zeros((1, 64, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the ones column needs d in 40, 80, 160
        attention_probe(q, q, q, 1, 0.125, denom="ones")
    q = torch.zeros((1, 64, 40), device=dev)
    with pytest.raises(ValueError):  # f32 operands: the scores mode only
        attention_probe(q, q, q, 1, 0.125)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 12, 12, 320), (1, 8, 8, 1280)])
@pytest.mark.parametrize("mode,splits,mma", [("full", None, False), ("copy", None, False),
                                             ("stats", None, False), ("norm", None, False),
                                             ("bf16sig", None, False), ("full", None, True),
                                             ("full", 1, False), ("full", 5, False)])
def test_group_norm_probe(dev, shape, mode, splits, mma):
    from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import (
        group_norm_probe,
        group_norm_probe_plain,
    )

    g = _gen(dev, shape[-1])
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = (torch.randn(shape[-1], generator=g, device=dev) * 0.5 + 1).to(torch.bfloat16)
    beta = (torch.randn(shape[-1], generator=g, device=dev) * 0.5).to(torch.bfloat16)
    before = group_norm_probe.launches
    got = group_norm_probe(x, gamma, beta, mode, splits=splits, mma=mma)
    assert group_norm_probe.launches == before + (1 if splits is None else 2)
    want = group_norm_probe_plain(x, gamma, beta, mode, splits=splits, mma=mma)
    if mode in ("copy", "stats"):
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= TOL[torch.bfloat16]


def test_group_norm_probe_full_is_k3(dev):
    """The fused kernel's full mode is K3's kernel: the same bits."""
    from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import group_norm_probe

    g = _gen(dev, 77)
    x = torch.randn((8, 32, 32, 640), generator=g, device=dev).to(torch.bfloat16)
    gamma = torch.randn(640, generator=g, device=dev).to(torch.bfloat16)
    beta = torch.randn(640, generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(group_norm_probe(x, gamma, beta), group_norm_nhwc(x, gamma, beta, 32, 1e-5,
                                                                         True))


@pytest.mark.parametrize("stages", [1, 3, 4, 8])
@pytest.mark.parametrize("convert", [False, True])
@pytest.mark.parametrize("rows", [4, 64, 1024])
def test_stream_copy(dev, rows, convert, stages):
    from complex_prompt_diffusion_tpu_torch.ops.probes.stream import stream_copy

    x = torch.randn((3, 1024, 40), generator=_gen(dev, rows), device=dev).to(torch.bfloat16)
    before = stream_copy.launches
    assert torch.equal(stream_copy(x, rows, convert, stages), x)
    assert stream_copy.launches == before + 1
