"""Port parity: schedules, CFG, DDIM and the whole txt2img slice vs JAX.

Inputs and injected noises come from numpy with fixed seeds and go to
both packages; the tiny JAX bundle's weights reach the port through
``convert.py`` (``ModelBundle.from_jax_params``). f32 on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.samplers import ddim as JD
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.samplers import ddim as D

# f32 step math on both sides (tables are float64 numpy cast to f32)
STEP_RTOL, STEP_ATOL = 1e-6, 1e-6
# whole tiny slice: 4 DDIM steps through CLIP, UNet and VAE, f32
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4


@pytest.mark.parametrize(
    "schedule", ["linear", "scaled_linear", "exp", "squaredcos_cap_v2",
                 "sigmoid", "warmup10", "const", "jsd", "cosine"]
)
def test_beta_schedules_equal(schedule):
    np.testing.assert_array_equal(
        S.make_beta_schedule(schedule, 1000), JS.make_beta_schedule(schedule, 1000)
    )


@pytest.mark.parametrize(
    "steps,eta,discretize", [(50, 0.0, "uniform"), (20, 0.5, "quad"), (10, 0.0, "jumps")]
)
def test_tables_equal(steps, eta, discretize):
    want = JS.make_diffusion_tables()
    got = S.make_diffusion_tables()
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))
    with np.errstate(invalid="ignore"):  # the jumps walk revisits steps: NaN sigmas
        gi = S.make_inference_tables(got, steps, eta=eta, discretize=discretize)
        wi = JS.make_inference_tables(want, steps, eta=eta, discretize=discretize)
    for f in dataclasses.fields(gi):
        np.testing.assert_array_equal(getattr(gi, f.name), getattr(wi, f.name))


def test_uc_scale_schedule_equal():
    for gcfg in (JG.GuidanceConfig(), JG.GuidanceConfig(decay_scale=True, decay_scale_start=5,
                                                        decay_scale_min=1.0)):
        port_cfg = G.GuidanceConfig(**dataclasses.asdict(gcfg))
        np.testing.assert_array_equal(
            G.make_uc_scale_schedule(port_cfg, 30), JG.make_uc_scale_schedule(gcfg, 30)
        )


def _spec_pair(rng, k=2, h=4, w=4, L=5, d=8):
    uncond = rng.standard_normal((L, d)).astype(np.float32)
    factors = rng.standard_normal((k, L, d)).astype(np.float32)
    scales = np.array([1.0, -0.5][:k], np.float32)
    masks = (rng.uniform(size=(k, h, w, 1)) > 0.3).astype(np.float32)
    jspec = JG.GuidanceSpec(jnp.asarray(uncond), jnp.asarray(factors),
                            jnp.asarray(scales), jnp.asarray(masks))
    pspec = G.GuidanceSpec(*map(torch.from_numpy, (uncond, factors, scales, masks)))
    return jspec, pspec


def _toy_eps(xp):
    """A stand-in UNet of x, t and the context, in numpy-like API ``xp``."""
    def eps(x, t, ctx):
        c = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
        t = t.astype(jnp.float32) if xp is jnp else t.float()
        return x * c[:, None, None, None] + 1e-3 * t[:, None, None, None]
    return eps


def test_cfg_epsilon_multi_factor():
    rng = np.random.default_rng(0)
    jspec, pspec = _spec_pair(rng)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    want = JG.cfg_epsilon(_toy_eps(jnp), jnp.asarray(x), jnp.asarray(801), jspec,
                          jnp.float32(7.5))
    got = G.cfg_epsilon(_toy_eps(torch), torch.from_numpy(x), torch.tensor(801), pspec,
                        torch.tensor(7.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_RTOL, atol=STEP_ATOL)
    # uc blur is ported (the flag on: the blurred uncond eps)
    want = JG.cfg_epsilon(_toy_eps(jnp), jnp.asarray(x), jnp.asarray(801), jspec,
                          jnp.float32(7.5), gcfg=JG.GuidanceConfig(uc_blur=True, uc_blur_k=3),
                          uc_blur_on=jnp.asarray(True))
    got = G.cfg_epsilon(_toy_eps(torch), torch.from_numpy(x), torch.tensor(801), pspec,
                        torch.tensor(7.5), gcfg=G.GuidanceConfig(uc_blur=True, uc_blur_k=3),
                        uc_blur_on=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_RTOL, atol=STEP_ATOL)
    # attn_guide is not read by cfg_epsilon (the t family's guided steps
    # call cfg_epsilon_attn_guided), as in the JAX package
    want = JG.cfg_epsilon(_toy_eps(jnp), jnp.asarray(x), jnp.asarray(1), jspec, jnp.float32(1.0),
                          gcfg=JG.GuidanceConfig(attn_guide=True))
    got = G.cfg_epsilon(_toy_eps(torch), torch.from_numpy(x), torch.tensor(1), pspec, 1.0,
                        gcfg=G.GuidanceConfig(attn_guide=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_ddim_step_and_loop_with_injected_noise():
    rng = np.random.default_rng(1)
    itab = S.make_inference_tables(S.make_diffusion_tables(), 5, eta=0.7)
    jtab = JS.make_inference_tables(JS.make_diffusion_tables(), 5, eta=0.7)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    e = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    dt = D.DeviceTables.from_tables(itab, "cpu")
    for idx in (0, 2, 4):
        got = D.ddim_step(torch.from_numpy(x), torch.from_numpy(e), idx, dt,
                          torch.from_numpy(noise), temperature=0.9)
        want = JD.ddim_step(x, e, idx, JD._prepare(jtab), noise, temperature=0.9)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)

    jspec, pspec = _spec_pair(rng)
    noises = rng.standard_normal((5, 3, 4, 4, 4)).astype(np.float32)
    x_T = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    scales = G.make_uc_scale_schedule(G.GuidanceConfig(), itab.num_steps)
    w_x0, w_traj = JD.sample_ddim(
        lambda a, t, s, blur: JG.cfg_epsilon(_toy_eps(jnp), a, t, jspec, s),
        jnp.asarray(x_T), jtab, scales, noises=noises,
    )
    g_x0, g_traj = D.sample_ddim(
        lambda a, t, s, blur=None: G.cfg_epsilon(_toy_eps(torch), a, t, pspec, s),
        torch.from_numpy(x_T), itab, scales, noises=noises,
    )
    np.testing.assert_allclose(g_x0.numpy(), np.asarray(w_x0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_traj.numpy(), np.asarray(w_traj), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_params(
        jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params,
        jb.clip_cfg, jb.clip_params, device="cpu",
    )
    return jb, pb


def test_txt2img_slice_matches_jax(bundles):
    """The tiny slice end to end: 32x32, batch 2, 4 DDIM steps, CFG 7.5,
    the same tokens and an injected x_T in both packages."""
    jb, pb = bundles
    prompt, negative = "a red cube on a table", "blurry"
    np.testing.assert_array_equal(pb.tokenizer([prompt, negative]),
                                  jb.tokenizer([prompt, negative]))
    x_T = np.random.default_rng(2).standard_normal((2, 4, 4, 4)).astype(np.float32)
    jcfg = JP.RenderConfig(steps=4, width=32, height=32, batch_size=2, guidance_scale=7.5)
    pcfg = P.RenderConfig(steps=4, width=32, height=32, batch_size=2, guidance_scale=7.5)
    w_img, w_lat = JP.txt2img(jb, prompt, negative, cfg=jcfg, x_T=jnp.asarray(x_T))
    g_img, g_lat = P.txt2img(pb, prompt, negative, cfg=pcfg, x_T=torch.from_numpy(x_T))
    assert g_lat.dtype == torch.float32 and tuple(g_lat.shape) == (2, 4, 4, 4)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)
    assert g_img.dtype == np.uint8 and g_img.shape == w_img.shape == (2, 8, 8, 3)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1


def test_render_config_validation_and_unported_paths(bundles):
    _, pb = bundles
    for bad in (dict(unet_batch_chunk=-2), dict(solver_order=4),
                dict(solver_method="x"), dict(unipc_variant="x"),
                dict(tome_ratio=0.5, tome_mode="x"),
                dict(deepcache_interval=2, sampler="DPM fast")):
        with pytest.raises(ValueError):
            P.RenderConfig(**bad)
        with pytest.raises(ValueError):
            JP.RenderConfig(**bad)
    assert P.RenderConfig(guidance_scale=9.0).guidance.guidance_scale == 9.0
    spec = P.make_guidance_spec(pb, "a cat")
    # "Log" returns log-likelihoods [B] now (it raised until the kernels had
    # backward rules); token reduction and attention guidance render
    ll = P.sample_latents(pb, spec, P.RenderConfig(sampler="Log", width=32, height=32),
                          loglik_steps=2)
    assert tuple(ll.shape) == (1,) and bool(torch.isfinite(ll).all())
    for cfg in (P.RenderConfig(tome_ratio=0.5, width=32, height=32, steps=2),
                P.RenderConfig(guidance=G.GuidanceConfig(attn_guide=True), width=32,
                               height=32, steps=2)):
        assert bool(torch.isfinite(P.sample_latents(pb, spec, cfg)).all())
    with pytest.raises(ValueError):
        P.sample_latents(pb, spec, P.RenderConfig(width=36, height=32))
