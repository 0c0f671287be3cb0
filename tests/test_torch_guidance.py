"""Port parity of the guidance switches: the ten thresholders and the
dynamic clip, the Gaussian blur, ``cfg_epsilon`` with each switch on,
the per-step blur schedule, and tiny renders with the switches and
``clip_sample`` (DDIM, PLMS), against the JAX package.

Inputs come from numpy seeds; f32 on the CPU. The render tests carry the
tiny JAX bundle's weights to the port through ``from_jax_bundle``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.guidance import threshold as JT
from complex_prompt_diffusion_tpu.ops import blur as JB
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.guidance import threshold as T
from complex_prompt_diffusion_tpu_torch.ops import blur as B

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# f32 elementwise and quantile arithmetic on the same inputs
OP_TOL = 1e-6
# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_sampler_slice.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4


def _x(seed, shape=(3, 6, 5, 4), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=OP_TOL):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


# threshold values per algorithm: percentiles, fractions, absolute levels
THRESHOLDS = [None, 0.5, 0.9966, 1.0, 2.5, 50.0, 90.0, 99.66]


@pytest.mark.parametrize("name", sorted(JT.THRESHOLDERS))
def test_thresholders_equal_jax(name):
    """Each of the ten at every threshold on f32 inputs; 120 values a sample,
    so a percentile such as 99.66 falls between two order statistics."""
    assert T.THRESHOLDERS.keys() == JT.THRESHOLDERS.keys()
    x = _x(1)
    for th in THRESHOLDS:
        if th is None and name != "none":
            continue
        want = JT.get_thresholder(name)(jnp.asarray(x), th)
        _close(T.get_thresholder(name)(torch.from_numpy(x), th), want)


def test_quantile_between_order_statistics_and_dynamic_clip():
    """n = 7 values a sample: the 0.9966 quantile sits at 0.9966 * 6 =
    5.9796, between the two largest |x|, which linear interpolation weighs
    0.0204 / 0.9796."""
    x = np.array([[1.0, -4.0, 2.0, 3.5, -0.5, 6.0, -2.5],
                  [0.1, 0.2, -9.0, 0.3, 8.0, 0.4, 0.5]], np.float32).reshape(2, 7, 1, 1)
    got = T._per_sample_abs_quantile(torch.from_numpy(x), 0.9966)
    want = np.asarray(JT._per_sample_abs_quantile(jnp.asarray(x), 0.9966))
    _close(got, want)
    assert got[0].item() == pytest.approx(4.0 + 0.9796 * 2.0, abs=1e-5)
    for th in (50.0, 99.5, 99.9):
        _close(T.dynamic_clip(torch.from_numpy(x), th), JT.dynamic_clip(jnp.asarray(x), th))
        _close(T.dynamic_clip(torch.from_numpy(_x(2)), th), JT.dynamic_clip(jnp.asarray(_x(2)), th))


def test_quantile_thresholders_refuse_bf16():
    with pytest.raises(RuntimeError):
        T.dynamic_thresholding(torch.zeros((1, 4, 4, 4), dtype=torch.bfloat16))


@pytest.mark.parametrize("k,hw", [(3, (6, 5)), (7, (8, 8)), (7, (3, 2)), (31, (8, 8)),
                                  (31, (16, 12)), (31, (1, 5))])
def test_gaussian_blur_equals_jax(k, hw):
    """Reflect padding by index: a pad of k // 2 >= the plane (k = 31 pads
    15 on an 8x8 plane, k = 7 pads 3 on 3x2) reflects back and forth as
    jnp.pad does."""
    x = _x(3, (2,) + hw + (4,), scale=1.0)
    np.testing.assert_array_equal(B.gaussian_kernel1d(k), JB.gaussian_kernel1d(k))
    _close(B.gaussian_blur(torch.from_numpy(x), k), JB.gaussian_blur(jnp.asarray(x), k))
    got16 = B.gaussian_blur(torch.from_numpy(x).to(torch.bfloat16), k)
    assert got16.dtype == torch.bfloat16  # f32 inside, the caller's dtype out
    want16 = JB.gaussian_blur(jnp.asarray(x, jnp.bfloat16), k)
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("kw,steps", [
    ({}, 10), (dict(uc_blur=True), 10), (dict(uc_blur=True), 25),
    (dict(uc_blur=True, uc_blur_rounds=4), 10), (dict(uc_blur=True, uc_blur_rounds=0), 10),
])
def test_uc_blur_schedule_equals_jax(kw, steps):
    got = G.make_uc_blur_schedule(G.GuidanceConfig(**kw), steps)
    want = JG.make_uc_blur_schedule(JG.GuidanceConfig(**kw), steps)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_only_attn_guide_is_unported():
    """Attention-saliency guidance is ported: no switch is left unported,
    and a guided render runs (``tests/test_torch_attn_guide.py`` holds it
    to the JAX package)."""
    on = dict(uc_blur=True, threshold_e="static_thresholding", dynamic_scale_clip=True)
    assert G.GuidanceConfig(**on).unported() == []
    assert G.GuidanceConfig(attn_guide=True, **on).unported() == []
    _, lat = P.txt2img(P.ModelBundle.random("tiny", device="cpu"), "a cat",
                       cfg=P.RenderConfig(steps=2, width=32, height=32,
                                          guidance=G.GuidanceConfig(attn_guide=True)),
                       decode=False)
    assert tuple(lat.shape) == (1, 4, 4, 4) and bool(torch.isfinite(lat).all())


def _fake_unet(xp):
    """A deterministic stand-in for the UNet, the same arithmetic in both
    packages (``xp`` is jnp or torch)."""
    def unet(x, t, ctx):
        c = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
        t = t.astype(jnp.float32) if xp is jnp else t.to(torch.float32)
        return 0.7 * x + xp.sin(3.0 * x) * c[:, None, None, None] + t[:, None, None, None] / 500.0
    return unet


def _spec_arrays(seed, k=3, h=6, w=5):
    rng = np.random.default_rng(seed)
    masks = (rng.random((k, h, w, 1)) > 0.4).astype(np.float32)
    return dict(uncond=rng.standard_normal((7, 8)).astype(np.float32),
                factors=rng.standard_normal((k, 7, 8)).astype(np.float32),
                scales=np.array([1.0, 1.5, -0.5], np.float32)[:k], masks=masks)


SWITCHES = [
    dict(),
    dict(uc_blur=True, uc_blur_k=3),
    dict(uc_blur=True, uc_blur_k=7),
    dict(dynamic_scale_clip=True),
    dict(dynamic_scale_clip=True, dynamic_scale_clip_threshold=50.0),
    dict(threshold_e="dynamic_thresholding"),
    dict(threshold_e="static_thresholding", threshold_e_value=1.5),
    dict(threshold_e="norm_thresholding", threshold_e_value=0.9966),
    dict(threshold_e="scaled_spatial_norm_thresholding"),
    dict(uc_blur=True, uc_blur_k=7, dynamic_scale_clip=True, threshold_e="renorm_thresholding"),
]


@pytest.mark.parametrize("kw", SWITCHES, ids=range(len(SWITCHES)))
@pytest.mark.parametrize("blur_on", [None, False, True])
def test_cfg_epsilon_switches_equal_jax(kw, blur_on):
    """One guided eps over a 3-factor spec with spatial masks, batch 2, the
    same fake UNet in both packages; the blur flag None (the sigma family),
    off or on."""
    arrays = _spec_arrays(4)
    x = _x(5, (2, 6, 5, 4), scale=1.5)
    want = JG.cfg_epsilon(
        _fake_unet(jnp), jnp.asarray(x), jnp.float32(601.0),
        JG.GuidanceSpec(**{k: jnp.asarray(v) for k, v in arrays.items()}), jnp.float32(7.5),
        gcfg=JG.GuidanceConfig(**kw), uc_blur_on=None if blur_on is None else jnp.asarray(blur_on))
    got = G.cfg_epsilon(
        _fake_unet(torch), torch.from_numpy(x), torch.tensor(601.0),
        G.GuidanceSpec(**{k: torch.from_numpy(v) for k, v in arrays.items()}), 7.5,
        gcfg=G.GuidanceConfig(**kw), uc_blur_on=blur_on)
    _close(got, want, 1e-5)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _specs(jb, pb):
    out = []
    for mod in (JP, P):
        b = jb if mod is JP else pb
        cond = mod.encode_prompt(b, ["a castle", "a dragon"])
        uncond = mod.encode_prompt(b, "fog")[0]
        masks = np.ones((2, 4, 4, 1), np.float32)
        masks[1, :, 2:] = 0.0
        spec_cls = JG.GuidanceSpec if mod is JP else G.GuidanceSpec
        arr = jnp.asarray if mod is JP else torch.from_numpy
        out.append(spec_cls(uncond=uncond, factors=cond, scales=arr(np.array([1.0, 1.5], np.float32)),
                            masks=arr(masks)))
    return out


RENDER_SWITCHES = [
    ("DDIM", dict(uc_blur=True, uc_blur_k=3, uc_blur_rounds=3), {}),
    ("DDIM", dict(threshold_e="dynamic_thresholding", dynamic_scale_clip=True),
     dict(clip_sample="dynamic_thresholding")),
    ("DDIM", dict(uc_blur=True, uc_blur_k=7, uc_blur_rounds=4, threshold_e="static_thresholding",
                  threshold_e_value=1.0), dict(clip_sample="static_thresholding",
                                               clip_sample_thresh=1.0, eta=0.4)),
    ("PLMS", dict(uc_blur=True, uc_blur_k=3, uc_blur_rounds=3, dynamic_scale_clip=True),
     dict(clip_sample="renorm_thresholding")),
    ("PLMS", dict(threshold_e="spatial_norm_thresholding", threshold_e_value=0.9966), {}),
]


@pytest.mark.parametrize("sampler,gkw,rkw", RENDER_SWITCHES, ids=range(len(RENDER_SWITCHES)))
def test_switched_render_equals_jax(bundles, sampler, gkw, rkw):
    """txt2img at batch 2 with the guidance switches and ``clip_sample``,
    the same x_T and injected noises in both packages."""
    jb, pb = bundles
    jspec, pspec = _specs(jb, pb)
    kw = dict(sampler=sampler, steps=6, width=32, height=32, batch_size=2, **rkw)
    jcfg = JP.RenderConfig(guidance=JG.GuidanceConfig(**gkw), **kw)
    pcfg = P.RenderConfig(guidance=G.GuidanceConfig(**gkw), **kw)
    rng = np.random.default_rng(41)
    x_T = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    noises = rng.standard_normal((8, 2, 4, 4, 4)).astype(np.float32)
    want = JP.sample_latents(jb, jspec, jcfg, x_init=jnp.asarray(x_T), noises=jnp.asarray(noises))
    got = P.sample_latents(pb, pspec, pcfg, x_init=torch.from_numpy(x_T),
                           noises=torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    if gkw.get("uc_blur"):  # the flags reach the t family's model: the blur changes the render
        off = P.sample_latents(pb, pspec, dataclasses.replace(pcfg, guidance=dataclasses.replace(
            pcfg.guidance, uc_blur=False)), x_init=torch.from_numpy(x_T),
            noises=torch.from_numpy(noises))
        assert not torch.allclose(got, off)


@pytest.mark.parametrize("sampler,kw", [("Euler", dict(s_churn=0.5)),
                                        ("DPM++ 2m", dict(sigma_schedule="karras")),
                                        ("UniPC", {}), ("iPNDM", {})])
def test_only_the_t_family_blurs(bundles, sampler, kw):
    """The sigma, solver and trig families pass no blur flags in the JAX
    package: ``uc_blur`` changes nothing there, and the port's render with
    it equals the port's without it (bits) and JAX's with it."""
    jb, pb = bundles
    jspec, pspec = _specs(jb, pb)
    g = dict(uc_blur=True, uc_blur_k=3, uc_blur_rounds=4)
    kw = dict(sampler=sampler, steps=5, width=32, height=32, batch_size=2, **kw)
    jcfg = JP.RenderConfig(guidance=JG.GuidanceConfig(**g), **kw)
    pcfg = P.RenderConfig(guidance=G.GuidanceConfig(**g), **kw)
    x_T = np.random.default_rng(42).standard_normal((2, 4, 4, 4)).astype(np.float32)
    if P.get_sampler(sampler)[0] == "sigma":  # the sigma family starts at its first sigma
        x_T = x_T * np.float32(P._sigma_schedule(pb, pcfg)[0])
    noises = np.random.default_rng(43).standard_normal((6, 2, 4, 4, 4)).astype(np.float32)
    want = JP.sample_latents(jb, jspec, jcfg, x_init=jnp.asarray(x_T), noises=jnp.asarray(noises))
    want_plain = JP.sample_latents(jb, jspec, dataclasses.replace(
        jcfg, guidance=JG.GuidanceConfig()), x_init=jnp.asarray(x_T), noises=jnp.asarray(noises))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_plain))
    got = P.sample_latents(pb, pspec, pcfg, x_init=torch.from_numpy(x_T),
                           noises=torch.from_numpy(noises))
    plain = P.sample_latents(pb, pspec, dataclasses.replace(pcfg, guidance=G.GuidanceConfig()),
                             x_init=torch.from_numpy(x_T), noises=torch.from_numpy(noises))
    assert torch.equal(got, plain)
    # the two-factor spec's denoised values reach ~30 at the first sigma, so
    # f32 rounding there is ~2e-4: the slice tolerance relative to that scale
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL * scale)
