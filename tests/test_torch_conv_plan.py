"""K4's sm90 body on the CPU: its tile and split-K plan, and a torch
emulation of what the kernel computes under that plan.

``conv3x3_plan`` decides the output tiles (a Wt x Ht rectangle of one
image's pixels by 128 channels, the last partly past Co) and the runs of
(tap, 64-channel) k-steps each block sums (ceil(C / 64) a tap, the last
partly past C); the card runs exactly that plan. Here the plan must cover
every output pixel and channel once and every k-step in exactly one split,
and an emulation of the kernel's data movement (the TMA box of each k-step,
zero-filled outside the plane and past C and Co; the splits summed in split
order; the bias added in f32; one rounding) must agree with the JAX
package's Pallas conv kernel in interpret mode. The attention half: which
K1 body each (dtype, head dim) goes to.
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
    k4_body,
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
# widths off the 64-channel tile: a tap's last k-step partly past C, the last
# n-tile partly past Co (CompVis LDM-VQ-4's UNet: 224, 672, 1120 and 1568 ==
# 32 mod 64; its 32^2 convs into 448; narrow-ish and odd widths)
REMAINDER = [(b, hw, hw, c, co) for b, hw, c, co in (
    (2, 16, 96, 72), (2, 16, 224, 672), (2, 16, 672, 672), (2, 32, 1120, 448), (4, 32, 1568, 672),
    (1, 16, 24, 200), (2, 8, 40, 9), (1, 24, 200, 131))]


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
                         + RAGGED + REMAINDER)
def test_plan_covers_every_output_and_k_step_once(b, h, w, c, co):
    plan = conv3x3_plan(b, h, w, c, co)
    assert plan.wt * plan.ht == 128 and plan.ksteps == 9 * -(-c // BK)
    assert plan.n_tiles == -(-co // 128)
    # a tap's last k-step covers the channels C - (C - 1) % 64 - 1 .. C - 1 (all
    # 64 where C % 64 == 0), the last n-tile Co - 128 (n_tiles - 1) of 128
    assert c - BK * (plan.ksteps // 9 - 1) == (c % BK or BK)
    assert co - 128 * (plan.n_tiles - 1) == (co % 128 or 128)
    assert all(len(plan.k_range(s)) > 0 for s in range(plan.splits))
    pix, chan, steps = _coverage(b, h, w, c, co, plan)
    assert (pix == 1).all() and (chan == 1).all() and (steps == 1).all()
    for s in range(1, plan.ksteps + 1, max(1, plan.ksteps // 7)):  # forced counts too
        forced = conv3x3_plan(b, h, w, c, co, splits=s)
        _, _, steps = _coverage(b, h, w, c, co, forced)
        assert (steps == 1).all() and forced.splits <= s


def test_plan_rejects_what_the_sm90_body_does_not_take():
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 20, 64)  # C % 8 != 0: the maps' 16-byte strides
    assert conv3x3_plan(2, 16, 16, 36, 64, dtype=torch.float32).ksteps == 18  # f32: C % 4 == 0
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 38, 64, dtype=torch.float32)  # C % 4 != 0
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 64, 0)  # no output channel
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 64, 64, splits=10)  # 9 k-steps
    with pytest.raises(ValueError):
        conv3x3_plan(2, 16, 16, 40, 64, splits=10)  # 9 k-steps, the one chunk partly past C
    assert conv3x3_plan(2, 16, 16, 40, 96).ksteps == 9  # C % 64 != 0, Co % 64 != 0: taken
    assert k4_body(torch.bfloat16, 20, 64) == "generic"  # what neither Hopper body takes
    assert k4_body(torch.bfloat16, 320, 640) == "bf16_sm90"
    assert k4_body(torch.float32, 320, 640) == "f32_sm90"  # K4's f32 body, not this one
    assert k4_body(torch.bfloat16, 4, 320) == "narrow"
    assert k4_body(torch.bfloat16, 320, 4) == "narrow"
    x = torch.zeros(1, 8, 8, 64)
    with pytest.raises(ValueError):  # the body is bf16 only
        conv3x3_sm90(x, torch.zeros(64, 64, 3, 3), torch.zeros(64))


@pytest.mark.parametrize("c,co,bf16_body,f32_body", [
    (224, 448, "bf16_sm90", "f32_sm90"), (672, 672, "bf16_sm90", "f32_sm90"),
    (1120, 448, "bf16_sm90", "f32_sm90"), (1568, 672, "bf16_sm90", "f32_sm90"),
    (448, 224, "bf16_sm90", "f32_sm90"), (96, 32, "bf16_sm90", "f32_sm90"),  # the tiny config
    (20, 320, "generic", "f32_sm90"),   # C % 8 != 0: neither bf16 Hopper map takes it
    (18, 320, "generic", "generic"),    # C % 4 != 0 too
    (4, 224, "narrow", "narrow"), (224, 3, "narrow", "narrow"), (16, 672, "narrow", "narrow"),
    (24, 9, "bf16_sm90", "f32_sm90"),   # past the narrow widths, an odd Co
])
def test_k4_route_at_remainder_widths(c, co, bf16_body, f32_body):
    """K4's route at CompVis LDM-VQ-4's widths (C and Co == 32 mod 64), at C
    = 20 and at the narrow widths: the Hopper bodies take every C % 8 (f32:
    % 4) past the narrow widths, with a plan for it."""
    assert k4_body(torch.bfloat16, c, co) == bf16_body
    assert k4_body(torch.float32, c, co) == f32_body
    for dt, body in ((torch.bfloat16, bf16_body), (torch.float32, f32_body)):
        if body.endswith("sm90"):
            assert conv3x3_plan(2, 16, 16, c, co, dtype=dt).n_tiles == -(-co // 128)


def test_b1_unet_conv_shapes_and_counts_match_the_unet_plan(monkeypatch):
    """The (plane, C, Co) table the card's phase 1 sums over is the SD-1.5
    plan's: a UNet at a tenth of SD-1.5's widths, run at a 64x64 latent and
    UNet batch 2 with the up path's skip concat materialized, sends 22 convs
    to K4, whose shapes scaled by 10 are the table's, as often as the table
    counts; with the up path fused (the default) it sends the 28 of
    ``kernel_cases.unet_sites(fused=True)`` inside K4's gate, every shape
    among the table's."""
    import collections
    import dataclasses

    from complex_prompt_diffusion_tpu_torch.models import unet as U
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import unet_sites

    calls = []
    monkeypatch.setattr(L, "conv3x3", lambda x, w, b: calls.append(
        (x.shape[1], 10 * x.shape[3], 10 * w.shape[0])) or conv3x3_plain(x, w, b))
    cfg = dataclasses.replace(M.UNetConfig.sd15(), model_channels=32, attention_resolutions=(),
                              context_dim=64)
    gen = torch.Generator().manual_seed(0)
    params = convert.unet_params(M.init_unet(gen, cfg), dtype=torch.bfloat16)
    args = (torch.randn((2, 64, 64, 4), generator=gen), torch.tensor([801, 801]),
            torch.randn((2, 77, 64), generator=gen))
    with torch.inference_mode():
        monkeypatch.setattr(U, "_FUSE_SKIP_CAT", False)
        M.unet_apply(cfg, params, *args)
        materialized, calls[:] = list(calls), []
        monkeypatch.setattr(U, "_FUSE_SKIP_CAT", True)
        M.unet_apply(cfg, params, *args)
    assert collections.Counter(materialized) == dict(zip(B1_UNET_CONVS, B1_UNET_CONV_COUNTS))
    assert all(k4_body(torch.bfloat16, c, co) == "bf16_sm90" for _, c, co in B1_UNET_CONVS)
    fused = collections.Counter(c for c in unet_sites(M.UNetConfig.sd15(), 64, fused=True)["conv"]
                                if c[0] in (16, 32))
    assert collections.Counter(calls) == fused and sum(fused.values()) == 28
    assert set(fused) <= set(B1_UNET_CONVS)


def _emulate(x, weight, bias, plan):
    """What the sm90 kernel computes, step by step: for each output tile and
    split, the f32 sum over its k-steps of (TMA box of x) @ (weight box)^T,
    the box zero-filled outside the plane and past Co; the splits summed in
    split order; the bias in f32; one rounding to x's dtype."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    chunks = -(-c // BK)
    cp = chunks * BK  # the channels the boxes reach, zeros past C (TMA's fill)
    # x zero-padded past every edge a box can reach: xp[1 + i] = x[i]
    xp = torch.nn.functional.pad(x.float(), (0, cp - c, 1, plan.wt + 1, 1, plan.ht + 1))
    # [Co, 9, C] (tap, c) zero-filled past C in each tap and past Co
    wpad = torch.zeros((plan.n_tiles * 128, 9, cp))
    wpad[:co, :, :c] = weight.float().permute(0, 2, 3, 1).reshape(co, 9, c)
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
                    wbox = wpad[nt * 128:(nt + 1) * 128, tap, c0:c0 + BK]
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
    (2, 16, 16, 96, 72, 5),     # C % 64 == 32: each tap's second k-step half zeros; Co 72
    (2, 16, 16, 224, 672, 2),   # LDM-VQ-4's width: 6 n-tiles, the last 32 wide
    (1, 8, 8, 40, 9, None),     # one k-step a tap, 24 of its channels past C; an odd Co
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


def _emulate_narrow_co(x, weight, bias, warps=8):
    """What K4's narrow-Co kernel computes, in its order: K = 9C cut into
    segments of one tap and 32 lanes x VEC channels (VEC: a 16-byte vector,
    1 where C is not a multiple of it), segment s summed by warp s % 8, each
    lane's VEC products in turn; the 32 lanes folded by a shuffle tree
    (lane l += lane l ^ o, o = 16 .. 1), the warps' sums in warp order, the
    bias in f32, one rounding."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    vec = 16 // x.element_size()
    vec = vec if c % vec == 0 else 1
    seg = 32 * vec
    segs = -(-c // seg)
    xp = torch.nn.functional.pad(x.float(), (0, seg * segs - c, 1, 1, 1, 1))
    wm = torch.nn.functional.pad(weight.float().permute(0, 2, 3, 1).reshape(co, 9, c),
                                 (0, seg * segs - c))
    acc = torch.zeros((b, h, w, warps, 32, co))
    for s in range(9 * segs):
        tap, j = divmod(s, segs)
        dy, dx = divmod(tap, 3)
        xs = xp[:, dy:dy + h, dx:dx + w, j * seg:(j + 1) * seg].reshape(b, h, w, 32, 1, vec)
        ws = wm[:, tap, j * seg:(j + 1) * seg].reshape(co, 32, vec).permute(1, 0, 2)
        prod = xs * ws  # [b, h, w, 32 lanes, co, vec]
        for v in range(vec):
            acc[:, :, :, s % warps] += prod[..., v]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(32) ^ o, :]
    y = acc[..., 0, 0, :]
    for wi in range(1, warps):
        y = y + acc[..., wi, 0, :]
    return (y + bias.float()).to(x.dtype)


def _emulate_narrow_c(x, weight, bias):
    """What K4's narrow-C kernel computes, in its order: for each output
    pixel and channel, the f32 products of its 3 x 3 x C neighbourhood
    (zero outside the plane) summed over the kernel row dy, then the
    channel, then the column dx; then the bias in f32, one rounding."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = weight.float()
    y = torch.zeros((b, h, w, weight.shape[0]))
    for dy in range(3):
        for ch in range(c):
            for dx in range(3):
                y = y + xp[:, dy:dy + h, dx:dx + w, ch:ch + 1] * wf[:, ch, dy, dx]
    return (y + bias.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,co", [
    (2, 16, 16, 320, 4),   # the UNet's out conv on a 16^2 latent
    (1, 8, 8, 512, 8),     # the VAE encoder's conv_out
    (2, 10, 12, 40, 3),    # C a multiple of neither vector: scalar loads
    (2, 16, 16, 4, 320),   # the UNet's conv_in
    (1, 8, 16, 9, 70),     # the inpaint UNet's conv_in, Co past one 64-channel block
    (3, 5, 7, 16, 64),     # the widest narrow C, a ragged plane
])
def test_narrow_emulation_matches_pallas_kernel(b, h, w, c, co, dtype):
    """K4's narrow route at the widths it takes, and an emulation of each
    narrow kernel's summation order against the JAX package's Pallas conv
    kernel in interpret mode; the wrapper on CPU tensors is the plain twin."""
    from complex_prompt_diffusion_tpu_torch.ops.conv import NARROW_C, NARROW_CO, conv3x3_narrow

    tdt = getattr(torch, dtype)
    assert k4_body(tdt, c, co) == "narrow" and (co <= NARROW_CO or c <= NARROW_C)
    x, k, bias = _inputs(b, h, w, c, co, seed=c + 3 * co + h)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_conv3x3(xj, jnp.asarray(k), jnp.asarray(bias), True), np.float32)
    p = convert.to_port({"kernel": k, "bias": bias})
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt)
    wt = p["weight"].to(tdt)
    emulate = _emulate_narrow_co if co <= NARROW_CO else _emulate_narrow_c
    got = emulate(xt, wt, p["bias"]).float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= TOL[dtype]
    assert torch.equal(conv3x3_narrow(xt, wt, p["bias"]), conv3x3_plain(xt, wt, p["bias"]))


def test_narrow_route_refuses_wide_convs():
    """The narrow bodies take Co <= 8 or C <= 16 and nothing else; K4's
    route sends them only those (the Hopper bodies keep their widths)."""
    from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3_narrow

    x = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="narrow"):
        conv3x3_narrow(x, torch.zeros(32, 32, 3, 3), torch.zeros(32))
    for dt in (torch.bfloat16, torch.float32):
        assert k4_body(dt, 17, 9) == "generic" and k4_body(dt, 16, 9) == "narrow"
        assert k4_body(dt, 64, 8) == "narrow" and k4_body(dt, 640, 640) != "narrow"


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
