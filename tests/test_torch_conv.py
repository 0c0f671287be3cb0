"""Port parity: the 3x3 conv (K4's plain twin) and the conv dispatch.

The port's ``conv3x3`` on CPU tensors runs the plain twin of the K4 CUDA
kernel. It is held against the JAX package's Pallas kernel
(``ops/conv.py:_kernel``) in interpret mode, in f32 and in bf16, with
inputs from one numpy seed. ``models/layers.conv2d`` must send exactly the
convs the JAX gate admits (any dtype, batch <= 4, 256 <= H*W <= 1024,
stride-1 3x3 'same', W % 8 == 0) to ``conv3x3`` and every other conv to
``F.conv2d``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.ops.conv import conv3x3 as jax_conv3x3
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.ops.conv import (
    conv3x3,
    conv3x3_plain,
    conv3x3_supported,
)

# f32: sums of up to 9C = 864 products taken in another order: ~1e-5.
# bf16: both sides round one f32 result to bf16, so they differ by at most
# one bf16 step (2^-8 relative) where the f32 sums straddle a rounding edge.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=8e-3, atol=8e-3)}


def _inputs(shape, co, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, c, co)).astype(np.float32) / np.sqrt(9 * c)
    b = rng.standard_normal(co).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,co", [((2, 16, 16, 64), 128), ((4, 32, 32, 96), 128), ((2, 16, 16, 4), 128)]
)
def test_conv3x3_matches_pallas_kernel(shape, co, dtype):
    x, k, b = _inputs(shape, co, seed=shape[-1])
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_conv3x3(xj, jnp.asarray(k), jnp.asarray(b), True), np.float32)
    w = convert.to_port({"kernel": k, "bias": b})
    got = conv3x3(torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype)),
                  w["weight"], w["bias"])
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape[:3] + (co,)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_conv3x3_rejects_bad_shapes_and_counts_no_cpu_launch():
    x = torch.zeros(1, 16, 16, 8)
    with pytest.raises(ValueError):
        conv3x3(x, torch.zeros(4, 6, 3, 3), torch.zeros(4))
    before = conv3x3.launches
    conv3x3(x, torch.zeros(4, 8, 3, 3), torch.zeros(4))
    assert conv3x3.launches == before


@pytest.mark.parametrize(
    "shape,k,stride,padding,dtype,wanted",
    [
        ((2, 16, 16, 8), 3, 1, None, torch.bfloat16, True),   # 16^2
        ((4, 32, 32, 8), 3, 1, 1, torch.bfloat16, True),      # 32^2, batch 4
        ((1, 8, 32, 8), 3, 1, None, torch.bfloat16, True),    # H*W = 256
        ((8, 16, 16, 8), 3, 1, None, torch.bfloat16, False),  # the b4 main path's UNet batch
        ((2, 64, 64, 8), 3, 1, None, torch.bfloat16, False),  # 64^2: above the gate
        ((2, 8, 8, 8), 3, 1, None, torch.bfloat16, False),    # 8^2: below it
        ((2, 24, 12, 8), 3, 1, None, torch.bfloat16, False),  # W % 8 != 0
        ((2, 32, 32, 8), 3, 2, None, torch.bfloat16, False),  # stride 2
        ((2, 33, 33, 8), 3, 2, 0, torch.bfloat16, False),     # the VAE downsample
        ((2, 16, 16, 8), 1, 1, None, torch.bfloat16, False),  # 1x1
        ((2, 16, 16, 8), 3, 1, None, torch.float32, True),    # f32 too (the exact decode)
    ],
)
def test_conv2d_dispatch_sends_in_gate_shapes_to_conv3x3(
    monkeypatch, shape, k, stride, padding, dtype, wanted
):
    calls = []

    def spy(x, w, b):
        calls.append(tuple(x.shape))
        return conv3x3(x, w, b)

    monkeypatch.setattr(L, "conv3x3", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    p = convert.to_port({"kernel": rng.standard_normal((k, k, 8, 16)).astype(np.float32) / 9,
                         "bias": rng.standard_normal(16).astype(np.float32)})
    got = L.conv2d(p, x, stride=stride, padding=padding)
    assert calls == ([shape] if wanted else [])
    assert L.conv3x3_wanted(x, p["weight"].shape, stride, padding) == wanted
    want = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), p["weight"].float(), p["bias"].float(), stride=stride,
        padding=(k - 1) // 2 if padding is None else padding,
    ).permute(0, 2, 3, 1)
    tol = TOL["bfloat16" if dtype == torch.bfloat16 else "float32"]
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=tol["rtol"],
                               atol=2 * tol["atol"])


def test_conv3x3_supported_guard():
    assert conv3x3_supported((2, 16, 16, 320), (640, 320, 3, 3), 1, None)
    assert conv3x3_supported((2, 32, 32, 2560), (1280, 2560, 3, 3), 1, 1)
    assert not conv3x3_supported((2, 16, 16, 320), (640, 320, 3, 3), 2, None)
    assert not conv3x3_supported((2, 16, 16, 320), (640, 320, 3, 3), 1, 0)
    assert not conv3x3_supported((2, 16, 16, 320), (640, 320, 1, 1), 1, None)
    assert not conv3x3_supported((2, 16, 12, 320), (640, 320, 3, 3), 1, None)
    assert not conv3x3_supported((2, 4, 64, 320), (640, 320, 3, 3), 1, None)


def test_sd15_plan_sends_22_convs_per_unet_call_at_batch_1(monkeypatch):
    """The SD-1.5 UNet plan (4 levels, 2 res blocks each) at a 64x64
    latent and UNet batch 2 (CFG at batch 1), bf16: 8 down-path convs on
    the 32^2/16^2 planes, 12 up-path convs there and the 2 upsample convs
    on 16^2 and 32^2, with the up path's skip concat materialized; fused
    (the default) the 6 up-path in_convs there split in two over the
    hidden state's and the skip's channels, 28 convs. Narrow channels
    (32..128) and no attention keep it small on the CPU; the conv sites
    depend on the plan alone."""
    import dataclasses

    from complex_prompt_diffusion_tpu_torch.models import unet as U

    calls = []
    monkeypatch.setattr(L, "conv3x3", lambda x, w, b: calls.append(
        (x.shape[1], x.shape[3], w.shape[0])) or conv3x3_plain(x, w, b))
    cfg = dataclasses.replace(M.UNetConfig.sd15(), model_channels=32, attention_resolutions=(),
                              context_dim=64)
    gen = torch.Generator().manual_seed(0)
    params = convert.unet_params(M.init_unet(gen, cfg), dtype=torch.bfloat16)
    x = torch.randn((2, 64, 64, 4), generator=gen)
    ctx = torch.randn((2, 77, 64), generator=gen)
    with torch.inference_mode():
        monkeypatch.setattr(U, "_FUSE_SKIP_CAT", False)
        out = M.unet_apply(cfg, params, x, torch.tensor([801, 801]), ctx)
        materialized, calls[:] = list(calls), []
        monkeypatch.setattr(U, "_FUSE_SKIP_CAT", True)
        fused = M.unet_apply(cfg, params, x, torch.tensor([801, 801]), ctx)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert len(materialized) == 22
    assert sorted({hw for hw, _, _ in materialized}) == [16, 32]
    # the skip-concat inputs of the up path (SD-1.5 widths / 10)
    assert {c for _, c, _ in materialized} >= {192, 256, 96, 128}
    assert fused.shape == x.shape and torch.isfinite(fused).all()
    assert len(calls) == 28 and not {c for _, c, _ in calls} & {192, 256, 96}
