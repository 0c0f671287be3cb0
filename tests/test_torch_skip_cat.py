"""Port parity of the JAX package's last forms: the UNet's virtual skip
concat (GroupNorm+SiLU over two sources, the split convs), the exact
subpixel upsample conv, ``DiffusionTables.astype``, ``init_layer_norm``,
and the two-output plain-VJP rule the two-source GroupNorm differentiates
through.

Inputs come from numpy seeds and reach both packages as the same arrays; the
tiny JAX bundle's weights reach the port through ``convert.py``. On the CPU
the port's kernel wrappers run their plain twins (K3's two-source form runs
on the card only: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import collections
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.models import layers as JL
from complex_prompt_diffusion_tpu.ops import groupnorm as JG
from complex_prompt_diffusion_tpu.pipeline import ModelBundle as JaxBundle
from complex_prompt_diffusion_tpu_torch import _build, convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.models import unet as U
from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G
from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

# f32: both sides sum in f32 in another order (1e-6 of the output's scale);
# bf16: the same f32 values rounded once to bf16, where a value next to a
# rounding boundary may land one bf16 ulp (2^-8 relative) away
F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 2 ** -10
# the tiny bf16 UNet's decoder states against JAX's: every layer rounds to
# bf16 at places XLA and PyTorch choose differently (measured: 1.6e-2 of the
# largest value at most)
UNET_BF16_TOL = 3e-2
# f32 UNet / VAE calls: f32 reassociation through a dozen layers
CALL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gn_data(c, seed, n=2, hw=(5, 7)):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, *hw, c)) + 0.5).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.5 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


def _close(got, want, dtype):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


# (Ca, Cb): JAX's own case (C 224, Ca 96 and 128: groups of 7 straddle), the
# SD-1.5 up path's ratios at a tenth of the width: (1280 | 640) -> (128 |
# 64), C/G = 6, group 21 straddles; (640 | 320) -> (64 | 32), C/G = 3;
# (1280 | 1280) -> (64 | 64), an exact split
CAT_SPLITS = [(96, 128), (128, 96), (128, 64), (64, 32), (64, 64)]


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ca,cb", CAT_SPLITS)
def test_group_norm_silu_cat_plain_matches_jax(ca, cb, dtype, silu):
    """The twin against JAX's ``group_norm_silu_cat``, both halves: one-pass
    f32 statistics in f32 too (where ``group_norm_plain`` takes two)."""
    x, gamma, beta = _gn_data(ca + cb, seed=ca + cb)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ja, jb = jnp.asarray(x[..., :ca], jdt), jnp.asarray(x[..., ca:], jdt)
    want = JG.group_norm_silu_cat(ja, jb, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5, silu)
    a, b = (torch.from_numpy(np.array(t, np.float32)).to(tdt) for t in (ja, jb))
    got = G.group_norm_silu_cat_plain(a, b, torch.from_numpy(gamma), torch.from_numpy(beta),
                                      32, 1e-5, silu)
    # the CPU route of the wrapper is the twin
    routed = G.group_norm_silu_cat(a, b, torch.from_numpy(gamma), torch.from_numpy(beta), 32,
                                   1e-5, silu)
    for g, r, w in zip(got, routed, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        assert torch.equal(g, r)
        _close(g, w, dtype)


def test_group_norm_silu_cat_plain_is_the_group_norm_of_the_concat():
    """The twin's halves, concatenated, are the materialized concat's
    GroupNorm+SiLU: in f32 its one-pass statistics against the two-pass ones
    of ``group_norm_plain`` to f32 rounding, in bf16 (both one pass, summed
    in another order) to one bf16 ulp."""
    x, gamma, beta = _gn_data(192, seed=3)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        ya, yb = G.group_norm_silu_cat_plain(xt[..., :128], xt[..., 128:],
                                             torch.from_numpy(gamma), torch.from_numpy(beta))
        want = G.group_norm_plain(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5,
                                  True)
        _close(torch.cat([ya, yb], dim=-1), want.float().numpy(), str(dtype).split(".")[1])


def test_group_norm_silu_cat_bad_channels_raise_in_both_packages():
    """65 + 61 = 126 channels do not divide into 32 groups: ValueError from
    JAX's function, the port's twin and the port's wrapper; the plan of
    K3's two-source form refuses what its kernel cannot take."""
    x, gamma, beta = _gn_data(128, seed=4)
    with pytest.raises(ValueError):
        JG.group_norm_silu_cat(jnp.asarray(x[..., :65]), jnp.asarray(x[..., 65:126]),
                               jnp.asarray(gamma[:126]), jnp.asarray(beta[:126]), num_groups=32)
    a, b = torch.from_numpy(x[..., :65]), torch.from_numpy(x[..., 65:126])
    g, be = torch.from_numpy(gamma[:126]), torch.from_numpy(beta[:126])
    for fn in (G.group_norm_silu_cat_plain, G.group_norm_silu_cat):
        with pytest.raises(ValueError, match="not divisible"):
            fn(a, b, g, be, 32)
    with pytest.raises(TypeError, match="one dtype"):
        G.group_norm_silu_cat(a, b.to(torch.bfloat16), torch.ones(126), torch.zeros(126), 2)
    for ca, cb in ((60, 68), (64, 4100 - 64), (0, 128)):
        with pytest.raises(ValueError, match="two-source"):
            G.group_norm_cat_plan(2, 64, ca, cb, 32, 132)


def test_group_norm_cat_plan_takes_every_sd15_cat_shape():
    """Every (Ca | Cb) of the SD-1.5 up path at UNet batch 2 and 4: the slab
    form (one launch, one group a block, two at C/G = 60) on the three 8^2
    and three 16^2 pairs and 32^2 (640 | 640); the split form (two launches
    over SMs / N tiles a sample) on 32^2 (1280 | 640) and (640 | 320) and
    the 64^2 pairs, whose slabs do not fit a block."""
    for side, ca, cb in KC.GN_CAT_PLANES:
        for n in (2, 4):
            plan = G.group_norm_cat_plan(n, side * side, ca, cb, 32, 132)
            if side <= 16 or (side, ca, cb) == (32, 640, 640):
                want = G.GnPlan("slab", 2 if (ca + cb) == 1920 else 1, 1)
            else:
                want = G.GnPlan("split", min(132 // n, side * side), 2)
            assert plan == want, (side, ca, cb, n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("side,ca,cb", KC.GN_CAT_PLANES)
def test_group_norm_cat_plan_is_the_one_input_plan_of_the_concat(side, ca, cb, n):
    """At every pair of the SD-1.5 up path, in both dtypes, the two-source
    plan is the one-input plan of the materialized concat (the same form,
    groups a block or tiles, and launches): a straddling block's two
    regions take no more room than its box there."""
    for dtype in (torch.bfloat16, torch.float32):
        cat = G.group_norm_cat_plan(n, side * side, ca, cb, 32, 132, dtype)
        one = G.group_norm_plan(n, side * side, ca + cb, 32, dtype, 132)
        assert cat == one


@pytest.mark.parametrize("hw,ca,cb,esize,straddles", [
    (256, 1280, 640, 2, True),   # 16^2, C/G = 60, two groups a block: 80 | 40 channels
    (64, 640, 320, 2, True),     # 8^2, C/G = 30, four groups a block: 40 | 80
    (256, 1280, 1280, 2, False),  # C/G = 80: the boundary falls between blocks
    (25, 1280, 640, 2, True),    # 5^2: boxes of 25 pixels, 80 | 40 channels round up apart
    (25, 1280, 640, 4, True),
])
def test_cat_slab_rule_sees_straddling_groups(hw, ca, cb, esize, straddles):
    """The two-source slab rule over the virtual row: the block that
    straddles the boundary takes each box as two 128-byte aligned regions,
    which can take more room than one box of its channels; the rule keeps a
    k only where those boxes fit, a subset of the one-input rule's."""
    c = ca + cb
    box = min(hw, 256)
    one = G.slab_groups(hw, c, 32, esize)
    cat = G.cat_slab_groups(hw, ca, cb, 32, esize)
    assert set(cat) <= set(one) and cat == sorted(cat)
    for k in one:
        kc = k * (c // 32)
        def bb(ch):
            return -(-box * ch * esize // 128) * 128

        ka = ca % kc
        got = G.cat_box_bytes(box, ca, kc, esize)
        assert got == (bb(ka) + bb(kc - ka) if ka else bb(kc)) >= bb(kc)
        assert (k in cat) == (-(-hw // box) * got <= G._TILE_BYTES)
    k = cat[0]
    assert (ca % (k * (c // 32)) != 0) == straddles


@pytest.mark.parametrize("ub", [1, 2, 3, 4])
def test_chip_smoke_predicts_the_two_source_launches(ub):
    """``chip_smoke.unet_call_launches`` counts the two-source form's
    kernels by its plans: at UNet batch 1-4 the 7 pairs on 8^2 and 16^2
    planes and 32^2 (640 | 640) take one slab launch each, the other 5 two
    split launches: 17 kernels for the 12 calls, 7 of them slab ones."""
    per = _chip_smoke().unet_call_launches(M.UNetConfig.sd15(), 64, ub)
    assert (per["k3_cat"], per["k3_cat_launches"], per["k3_cat_slab"]) == (12, 17, 7)
    assert per["k4_narrow"] == 0  # conv_in and out conv on the 64^2 plane: cuDNN
    per16 = _chip_smoke().unet_call_launches(M.UNetConfig.sd15(), 16, ub)
    assert per16["k4_narrow"] == 2  # a 16^2 latent: conv_in (C = 4), out conv (Co = 4)
    assert (per16["k3_cat"], per16["k3_cat_slab"]) == (12, per16["k3_cat_launches"])


def test_hopper_operands_read_a_weight_slice_in_place():
    """K4's Hopper bodies take a channel slice of a channels_last weight as
    it lies (the UNet's split in_convs): the operand is a view of the
    weight (same address), with the full weight's channel stride, in both
    dtypes; a weight in the default (OIHW) layout is copied once into the
    kernels' [Co, 3, 3, C] layout."""
    from complex_prompt_diffusion_tpu_torch.ops import conv as C

    for dtype in (torch.bfloat16, torch.float32):
        w = torch.randn(64, 192, 3, 3).to(dtype).contiguous(memory_format=torch.channels_last)
        p = {"weight": w, "bias": torch.zeros(64)}
        wa, wb, _ = U._split_weight(p, 128)
        for ws, lo in ((wa, 0), (wb, 128)):
            c = ws.shape[1]
            x = torch.randn(1, 8, 8, c).to(dtype)
            plan = C.conv3x3_plan(1, 8, 8, c, 64, dtype=dtype)
            _, wt, cw, _, _ = C._hopper_operands(x, ws, plan, "test")
            assert wt.data_ptr() == ws.data_ptr() == w.data_ptr() + lo * w.element_size()
            assert cw == 192 and tuple(wt.shape) == (64, 3, 3, c)
            assert torch.equal(wt.permute(0, 3, 1, 2), ws)
        wc = torch.randn(64, 64, 3, 3).to(dtype)
        x = torch.randn(1, 8, 8, 64).to(dtype)
        _, wt, cw, _, _ = C._hopper_operands(x, wc, C.conv3x3_plan(1, 8, 8, 64, 64, dtype=dtype),
                                             "test")
        assert cw == 64 and wt.is_contiguous() and wt.data_ptr() != wc.data_ptr()
        assert torch.equal(wt.permute(0, 3, 1, 2), wc)


@pytest.mark.parametrize("dtype,ca,cb,in_place", [
    (torch.bfloat16, 672, 224, True),   # CompVis LDM-VQ-4's (672 | 224) -> 448 in_conv
    (torch.bfloat16, 896, 672, True),
    (torch.float32, 100, 36, True),     # f32: 400 bytes, a multiple of 16
    (torch.bfloat16, 20, 24, False),    # b's half starts 40 bytes in: not TMA-aligned
    (torch.float32, 18, 20, False),     # a row of 38 f32 channels: not a 16-byte stride
])
def test_split_halves_off_the_tile_are_read_in_place_where_tma_can(dtype, ca, cb, in_place):
    """A half whose width is off the Hopper bodies' 64- (f32: 32-) channel
    k-step is read in place like any other when its start and the weight's
    channel stride are multiples of 16 bytes (the kernel's map stops at the
    half's C, so the neighbour's channels past it read as zeros); a half
    that is not is copied to its own contiguous layout."""
    from complex_prompt_diffusion_tpu_torch.ops import conv as C

    w = torch.randn(48, ca + cb, 3, 3).to(dtype).contiguous(memory_format=torch.channels_last)
    wa, wb, _ = U._split_weight({"weight": w, "bias": torch.zeros(48)}, ca)
    for ws, lo in ((wa, 0), (wb, ca)):
        c = ws.shape[1]
        x = torch.randn(1, 8, 8, c).to(dtype)
        plan = C.conv3x3_plan(1, 8, 8, c + (-c % C.SM90_ALIGN[dtype]), 48, dtype=dtype)
        if c % C.SM90_ALIGN[dtype]:
            continue  # the route sends this half to the generic body, which copies
        _, wt, cw, _, _ = C._hopper_operands(x, ws, plan, "test")
        here = in_place or lo == 0 and (ca + cb) * w.element_size() % 16 == 0
        assert (wt.data_ptr() == w.data_ptr() + lo * w.element_size()) == here
        assert cw == (ca + cb if here else c) and wt.data_ptr() % 16 == 0
        assert torch.equal(wt.permute(0, 3, 1, 2), ws)


def _plain_pair(a, b, w, k):
    """A two-output stand-in for a kernel and its twin: (a w + b, a * b k)."""
    return a * w + b, a * b * k


def test_two_output_plain_vjp_matches_autograd():
    """``kernel_with_plain_vjp`` over a two-output function (the two-source
    GroupNorm's shape of call): the forward is the kernel's, the gradients
    are autograd's of the twin for both cotangents, one of them alone, and
    with the other's ``None`` skipped."""
    rng = np.random.default_rng(11)
    a, b, w = (torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
               for _ in range(3))
    ga, gb = (torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)) for _ in range(2))
    calls = []

    def kernel(*args):
        calls.append(torch.is_grad_enabled())
        return tuple(t.detach().clone() for t in _plain_pair(*args))

    def grads(fn, cot):
        leaves = [t.detach().requires_grad_(True) for t in (a, b, w)]
        outs = fn(*leaves)
        torch.autograd.backward([o for o, c in zip(outs, cot) if c is not None],
                                [c for c in cot if c is not None])
        # an input an output's graph misses gets a zero gradient from the
        # rule (autograd hands it a zero cotangent for the unused output)
        return outs, [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]

    for cot in ((ga, gb), (ga, None), (None, gb)):
        got_out, got = grads(lambda *t: _build.kernel_with_plain_vjp(kernel, _plain_pair, (2.0,),
                                                                     *t), cot)
        want_out, want = grads(lambda *t: _plain_pair(*t, 2.0), cot)
        for g, w_ in zip(got_out, want_out):
            torch.testing.assert_close(g, w_, rtol=0, atol=0)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=1e-6, atol=1e-6)
    assert calls == [False, False, False]  # the kernel runs with grad off
    # the backward itself, handed a None cotangent, passes only the pair it has
    fn = _build._plain_vjp_function()
    ctx = types.SimpleNamespace(needs_input_grad=(False, False, False, True, True, False),
                                saved_tensors=(a, b, w), plain_fn=_plain_pair, nondiff=(2.0,))
    out = fn.backward(ctx, ga, None)
    assert out[:3] == (None, None, None) and out[5] is None
    torch.testing.assert_close(out[3], ga * w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[4], ga, rtol=0, atol=0)


def test_group_norm_silu_cat_gradients_through_the_vjp_rule():
    """The two-source GroupNorm under grad through the plain-VJP rule with
    the twin as the stand-in kernel: the gradients of a, b, gamma and beta
    equal plain autograd's of the twin."""
    x, gamma, beta = _gn_data(96, seed=9)
    ins = [torch.from_numpy(t) for t in (x[..., :64], x[..., 64:], gamma, beta)]
    rng = np.random.default_rng(12)
    cot = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)) for t in ins[:2]]

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in ins]
        torch.autograd.backward(list(fn(*leaves)), cot)
        return [t.grad for t in leaves]

    def stand_in(*args):
        return tuple(t.detach() for t in G.group_norm_silu_cat_plain(*args))

    got = run(lambda *t: _build.kernel_with_plain_vjp(stand_in, G.group_norm_silu_cat_plain,
                                                      (32, 1e-5, True), *t))
    want = run(lambda *t: G.group_norm_silu_cat_plain(*t, 32, 1e-5, True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    jb = JaxBundle.random("tiny", seed=0)
    port = (convert.config_from(M.UNetConfig, jb.unet_cfg), convert.unet_params(jb.unet_params))
    vae = (convert.config_from(M.VAEConfig, jb.vae_cfg), convert.vae_params(jb.vae_params))
    return jb, port, vae


def _unet_inputs(b, ctx_dim, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    t = (np.arange(b, dtype=np.int32) * 97 + 5).astype(np.int32)
    ctx = rng.standard_normal((b, 77, ctx_dim)).astype(np.float32)
    return x, t, ctx


class _CatCalls:
    """Counts the two-source GroupNorm calls of both packages (the UNet
    reads each through its module)."""

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        for key, mod in (("jax", JG), ("port", G)):
            inner = mod.group_norm_silu_cat

            def counted(*args, _inner=inner, _key=key, **kw):
                self.n[_key] += 1
                return _inner(*args, **kw)

            monkeypatch.setattr(mod, "group_norm_silu_cat", counted)


# UNet batch, dtype -> the two-source calls a tiny UNet call makes: its 4
# up-path ResBlocks (SD-1.5's 12, scaled to the tiny config's two levels of
# two output blocks) where the gate admits the pair, none at batch 8 or in f32
FUSED_CASES = [(2, "bfloat16", 4), (4, "bfloat16", 4), (8, "bfloat16", 0), (2, "float32", 0)]


@pytest.mark.parametrize("b,dtype,cat_calls", FUSED_CASES)
def test_unet_fused_skip_cat_matches_jax(tiny, monkeypatch, b, dtype, cat_calls):
    """The tiny UNet against JAX's ``unet_apply``: both packages take the
    fused form at the same sites (the same count of two-source calls) and
    agree on the decoder states (the out conv is zero-init, so they are
    what there is to compare)."""
    jb, (pcfg, pp), _ = tiny
    jcfg = dataclasses.replace(jb.unet_cfg, dtype=dtype)
    pcfg = dataclasses.replace(pcfg, dtype=dtype)
    x, t, ctx = _unet_inputs(b, jcfg.context_dim)
    calls = _CatCalls(monkeypatch)
    _, want = JM.unet_apply(jcfg, jb.unet_params, x, t, ctx, return_feats=True)
    _, got = M.unet_apply(pcfg, pp, *map(torch.from_numpy, (x, t, ctx)), return_feats=True)
    assert calls.n == {"jax": cat_calls, "port": cat_calls} or cat_calls == 0 and not calls.n
    assert U.skip_cat_fused(b, getattr(torch, dtype)) == bool(cat_calls)
    tol = UNET_BF16_TOL if dtype == "bfloat16" else CALL_TOL
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def test_unet_fused_matches_materialized(tiny, monkeypatch):
    """The port's fused call against its materialized one (the flag off), as
    the JAX package's own test holds its two: in f32 with the fused gate
    forced open (``prefers_mm_stats``), so both forms run f32 arithmetic;
    the flag off takes no two-source call."""
    _, (pcfg, pp), _ = tiny
    x, t, ctx = map(torch.from_numpy, _unet_inputs(2, pcfg.context_dim, seed=6))
    monkeypatch.setattr(G, "prefers_mm_stats", lambda a: True)
    calls = _CatCalls(monkeypatch)
    _, fused = M.unet_apply(pcfg, pp, x, t, ctx, return_feats=True)
    assert calls.n["port"] == 4
    monkeypatch.setattr(U, "_FUSE_SKIP_CAT", False)
    _, materialized = M.unet_apply(pcfg, pp, x, t, ctx, return_feats=True)
    assert calls.n["port"] == 4
    for f, m in zip(fused, materialized):
        torch.testing.assert_close(f, m, rtol=CALL_TOL, atol=CALL_TOL)


def test_split_weight_cache_follows_the_weight():
    """A split conv's weight halves are views of the weight, taken at each
    call: a weight written in place is seen by the next call, in inference
    mode or not, and the gradient flows to the weight."""
    w = torch.randn(8, 12, 3, 3).contiguous(memory_format=torch.channels_last)
    p = {"weight": w, "bias": torch.zeros(8)}
    wa, wb, zero = U._split_weight(p, 4)
    assert torch.equal(wa, w[:, :4]) and torch.equal(wb, w[:, 4:]) and not zero.any()
    assert wa._base is w and wb._base is w
    w.mul_(2.0)
    with torch.inference_mode():
        wa2, wb2, _ = U._split_weight(p, 4)
    assert torch.equal(wa2, w[:, :4]) and torch.equal(wb2, w[:, 4:])
    w.requires_grad_(True)
    wa3, wb3, _ = U._split_weight(p, 4)
    (g,) = torch.autograd.grad(wa3.sum() + 2 * wb3.sum(), w)
    assert torch.equal(g[:, :4], torch.ones_like(g[:, :4]))
    assert torch.equal(g[:, 4:], torch.full_like(g[:, 4:], 2.0))


def test_fused_unet_under_grad_after_an_inference_call(tiny):
    """An unguided call in inference mode, then one under grad w.r.t. x (a
    guided step): the second call's split conv weights can be saved for its
    backward, and its gradient equals that of a call with no inference-mode
    call before it."""
    _, (pcfg, pp), _ = tiny
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    x, t, ctx = map(torch.from_numpy, _unet_inputs(2, pcfg.context_dim, seed=9))

    def grad_x():
        xx = x.clone().requires_grad_(True)
        out, feats = M.unet_apply(pcfg, pp, xx, t, ctx, return_feats=True)
        (g,) = torch.autograd.grad(feats[-1].float().square().sum(), xx)
        return g

    want = grad_x()
    with torch.inference_mode():
        M.unet_apply(pcfg, pp, x, t, ctx)
    torch.testing.assert_close(grad_x(), want, rtol=0, atol=0)


def test_unet_sites_of_the_fused_sd15_call():
    """``tools/kernel_cases.unet_sites(fused=True)``: the 12 two-source
    GroupNorms at the (Ca | Cb) pairs of the SD-1.5 up path, with the 49
    plain ones still 61 K3 calls a UNet call; the 12 in_convs as 24 convs,
    the 16^2 and 32^2 ones inside K4's gate at UNet batch 2 (28 convs there
    against 22 concatenated); the fused UNet batches' shapes include no
    concat plane."""
    cfg = M.UNetConfig.sd15()
    plain, fused = KC.unet_sites(cfg, 64), KC.unet_sites(cfg, 64, fused=True)
    assert collections.Counter(fused["gn_cat"]) == dict(zip(KC.GN_CAT_PLANES, KC.GN_CAT_CALLS))
    assert sum(KC.GN_CAT_CALLS) == 12
    assert len(fused["gn_planes"]) == 49 and fused["gn"] == plain["gn"] == 61
    assert len(fused["conv"]) == len(plain["conv"]) + 12
    gated = [s for s in fused["conv"] if s[0] in (16, 32)]
    assert len(gated) == 28
    assert set(gated) <= set(KC.B1_UNET_CONVS)
    for ub in (1, 2, 3, 4):
        shapes = KC.unet_batch_shapes(cfg, 64, ub)
        assert sorted(shapes["gn_cat"]) == sorted((ub, s, s, a, b) for s, a, b in KC.GN_CAT_PLANES)
        assert not {c for _, _, _, c in shapes["gn"]} & {960, 1920, 2560}
        assert len(shapes["conv"]) == 6
    assert KC.unet_batch_shapes(cfg, 64, 8)["gn_cat"] == []
    # phase 1 holds both forms: the materialized concat of a flag-off run too
    keys = KC.held_unet_shapes()
    assert ("k3cat", 2, 16, 16, 1280, 640) in keys and ("k3", 2, 16, 16, 1920) in keys
    assert ("k4", 2, 32, 1920, 640) in keys


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,ci,co", [(2, 8, 8, 16, 24), (1, 5, 7, 8, 8)])
def test_conv3x3_after_upsample2x_matches_jax(b, h, w, ci, co, dtype):
    """The subpixel form against JAX's and against the conv of the upsampled
    plane (JAX's own shapes; the kernel and bias shifted off their init
    values so every tap counts)."""
    rng = np.random.default_rng(b * 100 + h)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.uniform(-0.3, 0.3, (3, 3, ci, co)) + 0.01).astype(np.float32)
    bias = np.full((co,), 0.1, np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(x, jdt)
    want = JL.conv3x3_after_upsample2x({"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}, jx)
    p = convert.to_port({"kernel": k, "bias": bias})
    xt = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    got = L.conv3x3_after_upsample2x(p, xt)
    assert got.dtype == tdt and tuple(got.shape) == (b, 2 * h, 2 * w, co)
    ref = L.conv2d(p, L.upsample_nearest2x(xt))
    if dtype == "float32":
        _close(got, want, dtype)
        torch.testing.assert_close(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        _close(got, want, dtype)
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def test_subpixel_up_wanted_mirrors_the_flag(monkeypatch):
    """"auto" (the default) is off on this card, as on every non-TPU JAX
    backend; "1" takes every 3x3 kernel; "0" none."""
    assert L._SUBPIXEL_UP == "auto" and not L.subpixel_up_wanted((8, 8, 3, 3))
    assert not JL.subpixel_up_wanted((3, 3, 8, 8))
    monkeypatch.setattr(L, "_SUBPIXEL_UP", "1")
    assert L.subpixel_up_wanted((8, 8, 3, 3)) and not L.subpixel_up_wanted((8, 8, 1, 1))
    monkeypatch.setattr(L, "_SUBPIXEL_UP", "0")
    assert not L.subpixel_up_wanted((8, 8, 3, 3))


def _forced(monkeypatch):
    monkeypatch.setattr(L, "_SUBPIXEL_UP", "1")
    monkeypatch.setattr(JL, "_SUBPIXEL_UP", "1")


def test_unet_with_subpixel_up_matches_jax(tiny, monkeypatch):
    """The f32 tiny UNet with the subpixel form forced in both packages (its
    level-1 "up" op), and against the port's own call without it."""
    jb, (pcfg, pp), _ = tiny
    x, t, ctx = _unet_inputs(2, pcfg.context_dim, seed=7)
    xt = tuple(map(torch.from_numpy, (x, t, ctx)))
    _, off = M.unet_apply(pcfg, pp, *xt, return_feats=True)
    _forced(monkeypatch)
    _, want = JM.unet_apply(jb.unet_cfg, jb.unet_params, x, t, ctx, return_feats=True)
    _, got = M.unet_apply(pcfg, pp, *xt, return_feats=True)
    for g, w, o in zip(got, want, off):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CALL_TOL, atol=CALL_TOL)
        torch.testing.assert_close(g, o, rtol=CALL_TOL, atol=CALL_TOL)


def test_vae_decode_with_subpixel_up_matches_jax(tiny, monkeypatch):
    """The f32 tiny VAE decode with the subpixel form forced in both
    packages (every decoder upsampler), and against the port's own decode
    without it."""
    jb, _, (vcfg, vp) = tiny
    z = np.random.default_rng(8).standard_normal((2, 6, 5, vcfg.z_channels)).astype(np.float32)
    off = M.vae_decode(vcfg, vp, torch.from_numpy(z))
    _forced(monkeypatch)
    want = JM.vae_decode(jb.vae_cfg, jb.vae_params, z)
    got = M.vae_decode(vcfg, vp, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CALL_TOL, atol=CALL_TOL)
    torch.testing.assert_close(got, off, rtol=CALL_TOL, atol=CALL_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_diffusion_tables_astype_matches_jax(dtype):
    """Every table cast to numpy ``dtype``, as JAX's ``astype`` casts it."""
    want = JS.make_diffusion_tables().astype(dtype)
    got = S.make_diffusion_tables().astype(dtype)
    assert isinstance(got, S.DiffusionTables)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert isinstance(g, np.ndarray) and g.dtype == dtype == np.asarray(w).dtype, f.name
        np.testing.assert_array_equal(g, np.asarray(w))


def test_init_layer_norm_matches_jax():
    got = L.init_layer_norm(24)
    want = JL.init_layer_norm(24)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].dtype == torch.float32


def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("ub,dtype,cat,k4", [(2, "bfloat16", 12, 28), (4, "bfloat16", 12, 28),
                                             (1, "bfloat16", 12, 28), (8, "bfloat16", 0, 0),
                                             (2, "float32", 0, 22)])
def test_chip_smoke_predicts_the_fused_call(ub, dtype, cat, k4):
    """``chip_smoke.unet_call_launches``, which every path's launch check
    reads: an SD-1.5 UNet call at a 64x64 latent has 61 K3 calls, 12 of
    them two-source where the up path is fused (bf16, UNet batch <= 4), and
    K4 on 28 convs there (22 and the 6 split in_convs of the 16^2 and 32^2
    planes), 22 in f32, none at UNet batch 8."""
    per = _chip_smoke().unet_call_launches(M.UNetConfig.sd15(), 64, ub, dtype)
    assert (per["k3"], per["k3_cat"], per["k4"]) == (61, cat, k4)


def test_chip_smoke_predicts_the_forced_subpixel_call(monkeypatch):
    """With the subpixel form forced the two "up" convs inside K4's gate
    (onto the 16^2 and 32^2 planes) leave K4."""
    monkeypatch.setattr(L, "_SUBPIXEL_UP", "1")
    per = _chip_smoke().unet_call_launches(M.UNetConfig.sd15(), 64, 2)
    assert per["k4"] == 26 and per["k3_cat"] == 12


def test_classifier_guidance_in_inference_mode():
    """The render loops run in inference mode: the guidance takes the
    classifier's gradient on a leaf copy of x outside it (a condition made
    in it copied out too), and gives what it gives outside."""
    from complex_prompt_diffusion_tpu_torch.samplers import solver as Sol

    ns = Sol.NoiseScheduleVP("discrete", alphas_cumprod=S.make_diffusion_tables().alphas_cumprod)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 4, 4, 3)).astype(np.float32))

    def model(x_, t, c):
        return torch.tanh(x_ * 0.3) * (1.0 + t / 1000.0)

    def classifier(x_, t, c):
        return (torch.sin(x_ * c) * (1.0 + t / 1000.0)).sum(dim=(1, 2, 3))

    def run():
        cond = torch.tensor(0.7)
        fn = Sol.model_wrapper(model, ns, guidance_type="classifier", guidance_scale=2.0,
                               classifier_fn=classifier, condition=cond)
        return fn(x, 0.4)

    want = run()
    with torch.inference_mode():
        got = run()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(want, Sol.model_wrapper(model, ns)(x, 0.4))


class _Rank:
    """A stand-in shard context of one rank of ``conv_split``: the rank's
    partial comes back as it is, for the test to sum over the ranks."""

    conv_split = True
    model_axis = "model"

    def __init__(self, rank):
        self.rank = rank

    def axis_rank(self, name):
        return self.rank

    def enter(self, t):
        return t

    def all_reduce(self, t, bias):
        return t


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("k", [3, 1])
def test_conv_split_over_cin_shards_is_the_conv_of_the_concat(model, k):
    """``_conv_split`` under ``conv_split``: each rank convolves its share of
    the virtual concat's input channels (from a, from b, or from both where
    its shard straddles Ca = 48 of 80), and the ranks' partials summed with
    the bias once are the conv of the concat by the whole weight."""
    rng = np.random.default_rng(k + model)
    a, b = (torch.from_numpy(rng.standard_normal((2, 16, 16, c)).astype(np.float32))
            for c in (48, 32))
    w = torch.from_numpy(rng.standard_normal((24, 80, k, k)).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    cin = 80 // model
    got = sum(U._conv_split({"weight": w[:, r * cin:(r + 1) * cin], "bias": bias}, a, b, _Rank(r))
              for r in range(model)) + bias
    want = L.conv2d({"weight": w, "bias": bias}, torch.cat([a, b], dim=-1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # without a shard context: the two convs over the split weight
    torch.testing.assert_close(U._conv_split({"weight": w, "bias": bias}, a, b), want,
                               rtol=1e-5, atol=1e-5)
