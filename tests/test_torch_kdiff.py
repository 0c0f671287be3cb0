"""Port parity: sigma schedules, the sigma-space denoiser, the k-diffusion
samplers, the sampler registry and the k-family txt2img / img2img vs JAX.

Inputs, x_T and the injected per-step noises come from numpy with fixed
seeds and go to both packages; the tiny JAX bundle's weights reach the port
through ``ModelBundle.from_jax_params``. Everything is f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.samplers import kdiff as JK
from complex_prompt_diffusion_tpu.samplers import registry as JR
from complex_prompt_diffusion_tpu.schedules import sigma as JSig
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.samplers import kdiff as K
from complex_prompt_diffusion_tpu_torch.samplers import registry as R
from complex_prompt_diffusion_tpu_torch.schedules import sigma as Sig

# the schedules are the same float64 numpy on both sides
SIGMA_TOL = 1e-12
# f32 step math on both sides; numpy and XLA round log/exp/pow differently
# in the last place, and a trajectory carries that through its steps
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5
# the whole tiny slice through CLIP, UNet and VAE, f32
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4

MODEL_SIGMAS = S.make_diffusion_tables().sigmas


@pytest.mark.parametrize(
    "algorithm,kwargs",
    [("default", {}), ("linear", {}), ("karras", dict(sigma_min=0.03, sigma_max=14.6, rho=7.0)),
     ("exp", dict(sigma_min=0.05, sigma_max=12.0)), ("quadratic", {}), ("vp", {}),
     ("sigmoid", dict(sigma_min=0.2, sigma_max=9.0))],
)
def test_sigma_schedules_equal(algorithm, kwargs):
    got = Sig.make_sigma_schedule(algorithm, 13, model_sigmas=MODEL_SIGMAS, **kwargs)
    want = JSig.make_sigma_schedule(algorithm, 13, model_sigmas=MODEL_SIGMAS, **kwargs)
    assert got.shape == (14,) and got[-1] == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=SIGMA_TOL)


def test_sigma_t_conversions_equal():
    rng = np.random.default_rng(0)
    sig = np.exp(rng.uniform(np.log(0.03), np.log(14.0), 50))
    np.testing.assert_allclose(Sig.sigma_to_t(sig, MODEL_SIGMAS), JSig.sigma_to_t(sig, MODEL_SIGMAS),
                               rtol=0, atol=SIGMA_TOL)
    np.testing.assert_array_equal(Sig.sigma_to_t(sig, MODEL_SIGMAS, quantize=True),
                                  JSig.sigma_to_t(sig, MODEL_SIGMAS, quantize=True))
    t = rng.uniform(0, 999, 50)
    np.testing.assert_allclose(Sig.t_to_sigma(t, MODEL_SIGMAS), JSig.t_to_sigma(t, MODEL_SIGMAS),
                               rtol=0, atol=SIGMA_TOL)
    np.testing.assert_allclose(Sig.linear_sigmas(None, MODEL_SIGMAS),
                               JSig.linear_sigmas(None, MODEL_SIGMAS), rtol=0, atol=SIGMA_TOL)
    for a, b in zip(Sig.karras_scalings(sig), JSig.karras_scalings(sig)):
        np.testing.assert_allclose(a, b, rtol=0, atol=SIGMA_TOL)
    with pytest.raises(NotImplementedError):
        Sig.make_sigma_schedule("nope", 5)
    with pytest.raises(ValueError):
        Sig.make_sigma_schedule("linear", 5)


def test_sigma_to_t_cont_matches_jax():
    sig = np.array([0.01, 0.0292, 0.5, 3.3, 14.61, 20.0], np.float32)
    want = np.asarray(JG.sigma_to_t_cont(jnp.asarray(sig), jnp.asarray(MODEL_SIGMAS)))
    got = G.sigma_to_t_cont(sig, MODEL_SIGMAS)
    assert got.dtype == np.float32
    # f32 interpolation weights: the quotient of two small differences
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # a per-step host scalar gives a 0-d result
    assert np.ndim(G.sigma_to_t_cont(np.float32(1.5), MODEL_SIGMAS)) == 0


def _spec_pair(rng, k=2, h=4, w=4, L=5, d=8):
    uncond = rng.standard_normal((L, d)).astype(np.float32)
    factors = rng.standard_normal((k, L, d)).astype(np.float32)
    scales = np.array([1.0, -0.5][:k], np.float32)
    masks = (rng.uniform(size=(k, h, w, 1)) > 0.3).astype(np.float32)
    jspec = JG.GuidanceSpec(jnp.asarray(uncond), jnp.asarray(factors),
                            jnp.asarray(scales), jnp.asarray(masks))
    pspec = G.GuidanceSpec(*map(torch.from_numpy, (uncond, factors, scales, masks)))
    return jspec, pspec


@pytest.fixture(scope="module")
def jax_bundle():
    return JP.ModelBundle.random("tiny", seed=0)


@pytest.fixture(scope="module")
def bundles(jax_bundle):
    jb = jax_bundle
    pb = P.ModelBundle.from_jax_params(
        jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params,
        jb.clip_cfg, jb.clip_params, device="cpu",
    )
    return jb, pb


def test_make_denoiser_matches_jax_on_tiny_unet(bundles):
    """The sigma-space denoiser around the tiny UNet: a fractional timestep
    reaches ``timestep_embedding`` and ``cfg_epsilon`` in both packages."""
    jb, pb = bundles
    rng = np.random.default_rng(1)
    ctx_dim = jb.unet_cfg.context_dim
    jspec, pspec = _spec_pair(rng, k=1, h=1, w=1, L=77, d=ctx_dim)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32) * 3.0

    def j_unet(a, t, c):
        return JM.unet_apply(jb.unet_cfg, jb.unet_params, a, t, c)

    def p_unet(a, t, c):
        return M.unet_apply(pb.unet_cfg, pb.unet_params, a, t, c)

    _, j_den = JG.make_denoiser(j_unet, jspec, model_sigmas=jnp.asarray(MODEL_SIGMAS))
    p_eps, p_den = G.make_denoiser(p_unet, pspec, model_sigmas=MODEL_SIGMAS)
    for sigma in (0.07, 1.234, 9.5):
        want = j_den(jnp.asarray(x), jnp.float32(sigma), jnp.float32(7.5))
        with torch.inference_mode():
            got = p_den(torch.from_numpy(x), np.float32(sigma), 7.5)
        # denoised = x - sigma * eps: the two UNets' eps agree to 1e-5, and
        # sigma multiplies that difference
        atol = TRAJ_ATOL * max(1.0, sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TRAJ_RTOL, atol=atol)
    # the t-space closure is cfg_epsilon
    with torch.inference_mode():
        e = p_eps(torch.from_numpy(x), torch.tensor(500), 7.5)
        e_ref = G.cfg_epsilon(p_unet, torch.from_numpy(x), torch.tensor(500), pspec, 7.5)
    torch.testing.assert_close(e, e_ref, rtol=0, atol=0)
    # a v-model: denoised = c_skip * x + c_out * v, as the JAX package's
    _, j_den_v = JG.make_denoiser(j_unet, jspec, model_sigmas=jnp.asarray(MODEL_SIGMAS),
                                  parameterization="v")
    _, p_den_v = G.make_denoiser(p_unet, pspec, model_sigmas=MODEL_SIGMAS, parameterization="v")
    for sigma in (0.07, 1.234, 9.5):
        want = j_den_v(jnp.asarray(x), jnp.float32(sigma), jnp.float32(7.5))
        with torch.inference_mode():
            got = p_den_v(torch.from_numpy(x), np.float32(sigma), 7.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    with pytest.raises(ValueError, match="parameterization"):
        G.make_denoiser(p_unet, pspec, model_sigmas=MODEL_SIGMAS, parameterization="x0")
    with pytest.raises(ValueError):
        G.make_denoiser(p_unet, pspec)[1](torch.from_numpy(x), np.float32(1.0), 7.5)


def _toy_den(xp):
    """A stand-in denoiser of x, sigma and the scale, in API ``xp``."""
    def den(x, sigma, uc):
        if xp is jnp:
            return x / (1.0 + sigma**2) + 0.01 * uc * jnp.tanh(x) * sigma
        return x / (1.0 + float(sigma) ** 2) + 0.01 * uc * torch.tanh(x) * float(sigma)
    return den


SAMPLER_CASES = [
    ("sample_euler", dict(s_churn=4.0, s_tmin=0.1, s_tmax=10.0, s_noise=1.01)),
    ("sample_euler", {}),
    ("sample_euler_ancestral", dict(eta=0.8, temperature=0.9)),
    ("sample_heun", dict(s_churn=2.0)),
    ("sample_dpm2", dict(s_churn=1.0)),
    ("sample_dpm2_ancestral", dict(eta=1.0)),
    ("sample_dpmpp_2m", {}),
    ("sample_dpmpp_2s_ancestral", dict(eta=1.0, temperature=0.95)),
    ("sample_lms", dict(order=4)),
    ("sample_dpm_fast", dict(eta=0.5, s_noise=1.0)),
    ("sample_dpm_fast", {}),
]


@pytest.mark.parametrize("name,kwargs", SAMPLER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SAMPLER_CASES)])
def test_sampler_trajectory_matches_jax(name, kwargs):
    """Each k-sampler against the JAX function: the same toy denoiser, the
    same x and the same injected noises, a decaying scale schedule."""
    rng = np.random.default_rng(7)
    steps = 7
    sigmas = Sig.make_sigma_schedule("karras", steps, sigma_min=0.03, sigma_max=14.6, rho=7.0)
    x = (rng.standard_normal((2, 4, 4, 4)) * sigmas[0]).astype(np.float32)
    noises = rng.standard_normal((steps, 2, 4, 4, 4)).astype(np.float32)
    ucs = np.linspace(7.5, 3.0, steps)
    w_x, w_traj = getattr(JK, name)(_toy_den(jnp), jnp.asarray(x), sigmas, ucs,
                                    noises=jnp.asarray(noises), **kwargs)
    g_x, g_traj = getattr(K, name)(_toy_den(torch), torch.from_numpy(x), sigmas, ucs,
                                   noises=noises, **kwargs)
    scale = float(np.abs(np.asarray(w_x)).max())
    np.testing.assert_allclose(g_x.numpy(), np.asarray(w_x), rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL * max(scale, 1.0))
    if w_traj is None:
        assert g_traj is None
    else:
        np.testing.assert_allclose(g_traj.numpy(), np.asarray(w_traj), rtol=TRAJ_RTOL,
                                   atol=TRAJ_ATOL * max(scale, 1.0))


def test_sampler_noise_sources_and_state_slot():
    sigmas = Sig.make_sigma_schedule("karras", 4, sigma_min=0.1, sigma_max=10.0)
    x = torch.randn((1, 2, 2, 4), generator=torch.Generator().manual_seed(0)) * 10
    den = _toy_den(torch)
    runs = [K.sample_euler_ancestral(den, x, sigmas, 7.5,
                                     generator=torch.Generator().manual_seed(s))[0]
            for s in (3, 3, 4)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    # with neither a generator nor noises the noise term is zero: eta = 0
    a = K.sample_euler_ancestral(den, x, sigmas, 7.5)[0]
    b = K.sample_euler_ancestral(den, x, sigmas, 7.5, eta=0.0,
                                 generator=torch.Generator().manual_seed(1))[0]
    assert not torch.equal(a, b)
    # the state slot: a stateful denoiser, its state carried across steps
    # (tests/test_torch_deepcache.py holds every sampler to the JAX scans)
    seen = []

    def den_st(x_, sigma, uc, i, st):
        seen.append((i, st))
        return den(x_, sigma, uc), st + 1

    K.sample_euler(den_st, x, sigmas, 7.5, den_state=0)
    assert seen == [(i, i) for i in range(4)]
    down, up = K.get_ancestral_step(sigmas[:-1], sigmas[1:], 1.0)
    jd, ju = JK.get_ancestral_step(sigmas[:-1], sigmas[1:], 1.0)
    np.testing.assert_array_equal(down, jd)
    np.testing.assert_array_equal(up, ju)
    np.testing.assert_allclose(K.lms_coefficients(sigmas), JK.lms_coefficients(sigmas),
                               rtol=0, atol=SIGMA_TOL)


def test_registry_names_match_jax():
    assert sorted(R.SAMPLERS) == sorted(JR.SAMPLERS)
    for name, (family, _) in JR.SAMPLERS.items():
        assert R.SAMPLERS[name][0] == family
    for name in ("ddim", "DDIM", "Euler", "euler ancestral", "Huen", "heun", "DPM2",
                 "dpm2 ANCESTRAL", "DPM++ 2m", "DPM++ 2S Ancestral", "LMS", "DPM Fast"):
        family, fn = R.get_sampler(name)
        assert family == JR.get_sampler(name)[0]
        assert not getattr(fn, "not_ported", False)
    assert R.get_sampler("Huen")[1] is R.get_sampler("Heun")[1] is K.sample_heun
    with pytest.raises(KeyError) as port_err:
        R.get_sampler("nope")
    with pytest.raises(KeyError) as jax_err:
        JR.get_sampler("nope")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", ["PLMS", "DPM Adaptive", "Log", "dpm_solver", "DPM Solver",
                                  "UniPC", "iPNDM", "Blur"])
def test_registry_unported_names_raise(name):
    """The names outside DDIM and kdiff.py: all ported now, with the JAX
    family; "Log" is the log-likelihood estimator (it raised until the
    kernels had backward rules)."""
    family, fn = R.get_sampler(name)
    assert family == JR.get_sampler(name)[0]
    assert not getattr(fn, "not_ported", False) and callable(fn)
    if name == "Log":
        from complex_prompt_diffusion_tpu_torch.samplers.loglik import sample_log_likelihood

        assert fn is sample_log_likelihood


def _noises(steps, shape, seed):
    return np.random.default_rng(seed).standard_normal((steps,) + shape).astype(np.float32)


@pytest.mark.parametrize(
    "sampler,extra",
    [("DPM++ 2m", dict(sigma_schedule="karras")), ("Euler Ancestral", {}),
     ("Huen", dict(s_churn=1.0, sigma_schedule="exp", sigma_min=0.05, sigma_max=12.0))],
)
def test_sample_latents_sigma_family_matches_jax(bundles, sampler, extra):
    jb, pb = bundles
    steps, shape = 5, (2, 4, 4, 4)
    kw = dict(steps=steps, sampler=sampler, width=32, height=32, batch_size=2,
              guidance_scale=7.5, **extra)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    np.testing.assert_allclose(P._sigma_schedule(pb, pcfg), JP._sigma_schedule(jb, jcfg),
                               rtol=0, atol=SIGMA_TOL)
    x_T = (np.random.default_rng(3).standard_normal(shape)
           * P._sigma_schedule(pb, pcfg)[0]).astype(np.float32)
    noises = _noises(steps, shape, 4)
    jspec = JP.make_guidance_spec(jb, "a red cube", "blurry")
    pspec = P.make_guidance_spec(pb, "a red cube", "blurry")
    want = JP.sample_latents(jb, jspec, jcfg, x_init=jnp.asarray(x_T),
                             noises=jnp.asarray(noises))
    got = P.sample_latents(pb, pspec, pcfg, x_init=torch.from_numpy(x_T), noises=noises)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)


def test_txt2img_dpmpp_2m_karras_matches_jax(bundles):
    """The tiny k-diffusion slice end to end: 32x32, batch 2, 6 DPM++ 2M
    steps on the Karras schedule, CFG 7.5, the same tokens and x_T."""
    jb, pb = bundles
    kw = dict(steps=6, sampler="DPM++ 2m", sigma_schedule="karras", width=32, height=32,
              batch_size=2, guidance_scale=7.5)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    x_T = (np.random.default_rng(5).standard_normal((2, 4, 4, 4))
           * P._sigma_schedule(pb, pcfg)[0]).astype(np.float32)
    w_img, w_lat = JP.txt2img(jb, "a red cube on a table", "blurry", cfg=jcfg,
                              x_T=jnp.asarray(x_T))
    g_img, g_lat = P.txt2img(pb, "a red cube on a table", "blurry", cfg=pcfg,
                             x_T=torch.from_numpy(x_T))
    assert g_lat.dtype == torch.float32 and tuple(g_lat.shape) == (2, 4, 4, 4)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)
    assert g_img.dtype == np.uint8 and g_img.shape == w_img.shape == (2, 8, 8, 3)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1


def test_txt2img_sigma_family_draws_scaled_x_T(bundles):
    """Without an injected x_T the draw is scaled by the first sigma, and
    one seed gives one image."""
    _, pb = bundles
    cfg = P.RenderConfig(steps=3, sampler="Euler", width=32, height=32, seed=11)
    a = P.txt2img(pb, "a cat", cfg=cfg, decode=False)[1]
    b = P.txt2img(pb, "a cat", cfg=cfg, decode=False)[1]
    c = P.txt2img(pb, "a cat", cfg=dataclasses.replace(cfg, seed=12), decode=False)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("sampler", ["Euler", "Euler Ancestral", "Heun", "DPM2",
                                     "DPM2 Ancestral", "DPM++ 2m", "DPM++ 2s Ancestral", "LMS",
                                     "DPM Fast"])
def test_every_k_sampler_runs_txt2img_and_img2img(bundles, sampler):
    _, pb = bundles
    cfg = P.RenderConfig(steps=4, sampler=sampler, width=32, height=32, seed=1,
                         denoising_strength=0.5)
    img, lat = P.txt2img(pb, "a cat", cfg=cfg)
    assert img.shape == (1, 8, 8, 3) and bool(torch.isfinite(lat).all())
    image = np.random.default_rng(2).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    # the tiny VAE scales by 2: a 32x32 image is a 16x16 latent
    img2, lat2 = P.img2img(pb, image, "a cat", cfg=cfg)
    assert img2.shape == (1, 32, 32, 3) and tuple(lat2.shape) == (1, 16, 16, 4)
    assert bool(torch.isfinite(lat2).all())


def test_img2img_k_family_matches_jax_chain(bundles):
    """k-family img2img: the port's encode -> x_t = z0 + noise * sigma[idx]
    -> last steps of the schedule, against the same chain assembled from
    the JAX package's functions with the same injected noises (its
    ``img2img`` draws them from a key, so it cannot be fed directly)."""
    jb, pb = bundles
    steps, strength = 10, 0.6
    kw = dict(steps=steps, sampler="Euler Ancestral", width=32, height=32,
              guidance_scale=7.5, denoising_strength=strength)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    z_shape = (1, 16, 16, 4)  # the tiny VAE scales by 2
    enc_noise = rng.standard_normal(z_shape).astype(np.float32)
    noise = rng.standard_normal(z_shape).astype(np.float32)
    assert P.img2img_t_enc(strength, steps, "k") == JP.img2img_t_enc(strength, steps, "k") == 4
    idx = max(0, steps - 4 - 1)
    n_run = steps - idx
    noises = _noises(n_run, z_shape, 8)

    post = JM.vae_encode(jb.vae_cfg, jb.vae_params, jnp.asarray(image, jnp.float32)[None] / 127.5 - 1.0)
    z0 = (post.mean + post.std * jnp.asarray(enc_noise)) * JP.LATENT_SCALE
    sigmas = JP._sigma_schedule(jb, jcfg)
    x_t = z0 + jnp.asarray(noise) * float(sigmas[idx])
    jspec = JP.make_guidance_spec(jb, "a cat", "")
    want = JP.sample_latents(jb, jspec, jcfg, x_init=x_t, noises=jnp.asarray(noises),
                             t_start=len(sigmas) - 1 - idx)
    w_img = JP.decode_latents(jb, want)

    g_img, got = P.img2img(pb, image, "a cat", cfg=pcfg, encode_noise=enc_noise, noise=noise,
                           noises=noises)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1
