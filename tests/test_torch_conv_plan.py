"""K4's sm90 body on the CPU: its tile and split-K plan, and a torch
emulation of what the kernel computes under that plan.

``conv3x3_plan`` decides the output tiles (a Wt x Ht rectangle of one
image's pixels by 128 channels) and the runs of (tap, 64-channel) k-steps
each block sums; the card runs exactly that plan. Here the plan must cover
every output pixel and channel once and every k-step in exactly one split,
and an emulation of the kernel's data movement (the TMA box of each k-step,
zero-filled outside the plane; the splits summed in split order; the bias
added in f32; one rounding) must agree with the JAX package's Pallas conv
kernel in interpret mode. The attention half: which K1 body each
(dtype, head dim) goes to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.ops.conv import conv3x3 as jax_conv3x3
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.ops.attention import k1_body
from complex_prompt_diffusion_tpu_torch.ops.conv import (
    conv3x3_plain,
    conv3x3_plan,
    conv3x3_sm90,
    sm90_takes,
)
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
    B1_UNET_CONV_COUNTS,
    B1_UNET_CONVS,
)

BK = 64  # channels a k-step

# f32: sums of 9C products in another order than the Pallas kernel's: ~1e-5.
# bf16: both round one f32 sum to bf16, so they differ by at most a bf16
# step (2^-8 relative) where the sums straddle a rounding edge.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

RAGGED = [(b, hw, hw, c, co) for b, hw, c, co in (
    (1, 8, 64, 64), (2, 24, 128, 192), (3, 40, 64, 64), (4, 8, 192, 128), (2, 40, 128, 192))]


def _coverage(b, h, w, c, co, plan):
    """(hits per output pixel and channel, hits per k-step) under the plan."""
    pix = np.zeros((b, h, w), np.int64)
    chan = np.zeros(co, np.int64)
    for mt in range(plan.m_tiles):
        tw, rest = mt % plan.tiles_w, mt // plan.tiles_w
        th, bi = rest % plan.tiles_h, rest // plan.tiles_h
        h0, w0 = th * plan.ht, tw * plan.wt
        pix[bi, h0:h0 + plan.ht, w0:w0 + plan.wt] += 1  # numpy clips at the edge
    for nt in range(plan.n_tiles):
        chan[nt * 128:(nt + 1) * 128] += 1
    steps = np.zeros(plan.ksteps, np.int64)
    for s in range(plan.splits):
        for t in plan.k_range(s):
            steps[t] += 1
    return pix, chan, steps


@pytest.mark.parametrize("b,h,w,c,co", [(2, hw, hw, c, co) for hw, c, co in B1_UNET_CONVS]
                         + RAGGED)
def test_plan_covers_every_output_and_k_step_once(b, h, w, c, co):
    plan = conv3x3_plan(b, h, w, c, co)
    assert plan.wt * plan.ht == 128 and plan.ksteps == 9 * c // BK
    assert all(len(plan.k_range(s)) > 0 for s in range(plan.splits))
    pix, chan, steps = _coverage(b, h, w, c, co, plan)
    assert (pix == 1).all() and (chan == 1).all() and (steps == 1).all()
    for s in range(1, plan.ksteps + 1, max(1, plan.ksteps // 7)):  # forced counts too
        forced = conv3x3_plan(b, h, w, c, co, splits=s)
        _, _, steps = _coverage(b, h, w, c, co, forced)
        assert (steps == 1).all() and forced.splits <= s


def test_plan_rejects_what_the_sm90_body_does_not_take():
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 40, 64)  # C % 64 != 0
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 64, 96)  # Co % 64 != 0
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 64, 64, splits=10)  # 9 k-steps
    assert sm90_takes(torch.bfloat16, 320, 640)
    assert not sm90_takes(torch.float32, 320, 640)
    assert not sm90_takes(torch.bfloat16, 4, 320)
    assert not sm90_takes(torch.bfloat16, 320, 4)
    x = torch.zeros(1, 8, 8, 64)
    with pytest.raises(ValueError):  # the body is bf16 only
        conv3x3_sm90(x, torch.zeros(64, 64, 3, 3), torch.zeros(64))


def test_b1_unet_conv_shapes_and_counts_match_the_unet_plan(monkeypatch):
    """The (plane, C, Co) table the card's phase 1 sums over is the SD-1.5
    plan's: a UNet at a tenth of SD-1.5's widths, run at a 64x64 latent and
    UNet batch 2, sends 22 convs to K4, whose shapes scaled by 10 are the
    table's, as often as the table counts."""
    import collections
    import dataclasses

    calls = []
    monkeypatch.setattr(L, "conv3x3", lambda x, w, b: calls.append(
        (x.shape[1], 10 * x.shape[3], 10 * w.shape[0])) or conv3x3_plain(x, w, b))
    cfg = dataclasses.replace(M.UNetConfig.sd15(), model_channels=32, attention_resolutions=(),
                              context_dim=64)
    gen = torch.Generator().manual_seed(0)
    params = convert.unet_params(M.init_unet(gen, cfg), dtype=torch.bfloat16)
    with torch.inference_mode():
        M.unet_apply(cfg, params, torch.randn((2, 64, 64, 4), generator=gen),
                     torch.tensor([801, 801]), torch.randn((2, 77, 64), generator=gen))
    assert collections.Counter(calls) == dict(zip(B1_UNET_CONVS, B1_UNET_CONV_COUNTS))
    assert all(sm90_takes(torch.bfloat16, c, co) for _, c, co in B1_UNET_CONVS)


def _emulate(x, weight, bias, plan):
    """What the sm90 kernel computes, step by step: for each output tile and
    split, the f32 sum over its k-steps of (TMA box of x) @ (weight box)^T,
    the box zero-filled outside the plane and past Co; the splits summed in
    split order; the bias in f32; one rounding to x's dtype."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    chunks = c // BK
    # x zero-padded past every edge a box can reach: xp[1 + i] = x[i]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, plan.wt + 1, 1, plan.ht + 1))
    wmat = weight.float().permute(0, 2, 3, 1).reshape(co, 9 * c)  # [Co, 9C], (tap, c)
    wpad = torch.zeros((plan.n_tiles * 128, 9 * c))
    wpad[:co] = wmat
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
                    tap, c0 = t // chunks, (t % chunks) * BK
                    dy, dx = tap // 3, tap % 3
                    # the box at (c0, w0 + dx - 1, h0 + dy - 1, b), zero outside
                    box = xp[bi, h0 + dy:h0 + dy + plan.ht, w0 + dx:w0 + dx + plan.wt,
                             c0:c0 + BK]
                    wbox = wpad[nt * 128:(nt + 1) * 128, tap * c + c0:tap * c + c0 + BK]
                    part += box.reshape(-1, BK) @ wbox.t()
                total = part if total is None else total + part
            tile = total.reshape(plan.ht, plan.wt, 128)
            hs, ws = min(plan.ht, h - h0), min(plan.wt, w - w0)
            nc = min(128, co - nt * 128)
            y[bi, h0:h0 + hs, w0:w0 + ws, nt * 128:nt * 128 + nc] = tile[:hs, :ws, :nc]
    return (y + bias.float()).to(x.dtype)


def _inputs(b, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, c, co)).astype(np.float32) / np.sqrt(9 * c)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, k, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,co,splits", [
    (1, 8, 8, 64, 64, None),    # one tile: 8 x 16 pixels over an 8 x 8 plane
    (2, 16, 16, 64, 128, 1),    # 16 x 8 tiles, two per image
    (2, 24, 24, 128, 192, 3),   # W % 16 != 0: 8 x 16 tiles; Co = 192: half an n-tile
    (1, 40, 40, 64, 64, 4),     # 5 x 3 tiles, the last row of tiles ragged
])
def test_plan_emulation_matches_pallas_kernel(b, h, w, c, co, splits, dtype):
    x, k, bias = _inputs(b, h, w, c, co, seed=c + co + h)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_conv3x3(xj, jnp.asarray(k), jnp.asarray(bias), True), np.float32)
    p = convert.to_port({"kernel": k, "bias": bias})
    xt = torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype))
    wt = p["weight"].to(xt.dtype)
    got = _emulate(xt, wt, p["bias"], conv3x3_plan(b, h, w, c, co, splits)).float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL[dtype], err


def test_plan_emulation_split_counts_agree():
    """Every split count gives the f32 sums of split 1 up to summation
    order, so the bf16 results agree within one bf16 rounding."""
    x, k, bias = _inputs(1, 16, 16, 64, 64, seed=3)
    p = convert.to_port({"kernel": k, "bias": bias})
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = p["weight"].to(torch.bfloat16)
    one = _emulate(xt, wt, p["bias"], conv3x3_plan(1, 16, 16, 64, 64, 1)).float()
    for s in (2, 3, 9):
        got = _emulate(xt, wt, p["bias"], conv3x3_plan(1, 16, 16, 64, 64, s)).float()
        assert float((got - one).abs().max()) <= 2 ** -7 * float(one.abs().max())


@pytest.mark.parametrize("dtype,d,body", [
    (torch.bfloat16, 40, "sm90"), (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 80, "sm90"),
    (torch.bfloat16, 160, "sm90"), (torch.bfloat16, 8, "sm90"), (torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, 120, "sm90"), (torch.bfloat16, 248, "sm90"),
    (torch.bfloat16, 264, "bf16_wide"), (torch.bfloat16, 512, "bf16_wide"),
    (torch.float32, 40, "f32_fused"), (torch.float32, 160, "f32_fused"),
    (torch.float32, 512, "f32_sm90"), (torch.float32, 4, "f32_fused"),
    (torch.float32, 164, "f32_sm90"), (torch.float32, 256, "f32_sm90"),
])
def test_attention_route_by_dtype_and_head_dim(dtype, d, body):
    assert k1_body(dtype, d) == body


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.bfloat16, 20, ValueError),   # d % 8 != 0
    (torch.bfloat16, 104, ValueError),  # pads to 112: a width K1 has no body for
    (torch.bfloat16, 200, ValueError),  # pads to 208
    (torch.bfloat16, 520, ValueError),  # above 512
    (torch.float32, 6, ValueError),     # d % 4 != 0
    (torch.float32, 516, ValueError),
    (torch.float16, 64, TypeError),
])
def test_attention_route_raises_on_what_no_body_takes(dtype, d, exc):
    with pytest.raises(exc):
        k1_body(dtype, d)
