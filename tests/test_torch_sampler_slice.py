"""Port parity of the whole slice for the samplers outside DDIM and the
k-diffusion nine: txt2img through CLIP, the UNet and the VAE with PLMS,
DPM-Solver (multistep, singlestep, adaptive), UniPC (bh1, bh2,
vary_coeff), DPM Adaptive, iPNDM and Blur; PLMS img2img (the whole
schedule, as the JAX package runs it); the img2img refusals; the step
callbacks.

The tiny JAX bundle's weights reach the port through
``ModelBundle.from_jax_bundle``; x_T and the injected noises come from
numpy with fixed seeds. f32 on the CPU at a 32x32 canvas.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import samplers as JSA
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.samplers import callbacks as C

# the whole tiny slice through CLIP, UNet and VAE, f32 (as SLICE_RTOL/ATOL
# of test_torch_kdiff.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
PROMPT, NEGATIVE = "a red cube on a table", "blurry"
LATENT = (2, 4, 4, 4)  # 32x32, batch 2


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _cfgs(**kw):
    kw = dict(width=32, height=32, batch_size=2, guidance_scale=7.5, **kw)
    return JP.RenderConfig(**kw), P.RenderConfig(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)


class _UnetCalls:
    """Counts the port's UNet calls (``models.unet_apply``, which the
    pipeline calls through the module)."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = M.unet_apply

        def counted(*a, **k):
            self.n += 1
            return inner(*a, **k)

        monkeypatch.setattr(M, "unet_apply", counted)


TXT2IMG_CASES = [
    ("PLMS", dict(steps=6), 8),  # 7 table steps (6 does not divide 1000), the first twice
    ("dpm_solver", dict(steps=5, solver_order=2), 5),
    ("DPM Solver", dict(steps=6, solver_order=3, solver_method="singlestep"), 6),
    ("dpm_solver", dict(steps=4, solver_order=1, solver_method="singlestep"), 4),
    ("UniPC", dict(steps=5, solver_order=2, unipc_variant="bh2"), 5),
    ("UniPC", dict(steps=5, solver_order=3, unipc_variant="bh1"), 5),
    ("UniPC", dict(steps=6, solver_order=3, unipc_variant="vary_coeff"), 6),
    ("iPNDM", dict(steps=5), 5),
]


@pytest.mark.parametrize("sampler,kw,calls", TXT2IMG_CASES,
                         ids=[f"{s}-{i}" for i, (s, _, _) in enumerate(TXT2IMG_CASES)])
def test_txt2img_matches_jax(bundles, monkeypatch, sampler, kw, calls):
    """The same tokens and x_T in both packages (their solver and trig
    paths start from an injected x_T as the port's do); the port makes the
    UNet calls its sampler implies."""
    jb, pb = bundles
    jcfg, pcfg = _cfgs(sampler=sampler, **kw)
    x_T = np.random.default_rng(2).standard_normal(LATENT).astype(np.float32)
    w_img, w_lat = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=jcfg, x_T=jnp.asarray(x_T))
    unet = _UnetCalls(monkeypatch)
    g_img, g_lat = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T))
    assert unet.n == calls
    assert g_lat.dtype == torch.float32 and tuple(g_lat.shape) == LATENT
    _close(g_lat, w_lat)
    assert g_img.shape == (2, 8, 8, 3)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1


def _jax_adaptive_iters(jb, jcfg, x_T, spec):
    """JAX's DPM-Solver-12/23 on the tiny UNet with its model times recorded
    (its pipeline's model_fn, rebuilt, since the jitted render hides them)."""
    ns = JSA.NoiseScheduleVP("discrete", alphas_cumprod=jb.tables.alphas_cumprod)
    eps_fn, _ = JG.make_denoiser(JP._unet_eps_fn(jb), spec, gcfg=jcfg.guidance)
    times = []

    def model_fn(x, t_cont):
        jax.debug.callback(lambda v: times.append(float(v)), t_cont, ordered=True)
        t_disc = (t_cont - 1.0 / ns.total_N) * 1000.0
        return eps_fn(x, t_disc, jnp.float32(jcfg.guidance_scale), jnp.asarray(False))

    out = JSA.sample_dpm_solver_adaptive(model_fn, jnp.asarray(x_T), ns,
                                         order=jcfg.solver_order)
    out = np.asarray(out)
    jax.effects_barrier()
    return out, times


def test_txt2img_dpm_solver_adaptive_matches_jax(bundles, monkeypatch):
    """The adaptive solver in the slice: the same model times (so the same
    accept/reject at every iteration) and the same iteration count as the
    JAX loop on the same UNet, then the same latents."""
    jb, pb = bundles
    jcfg, pcfg = _cfgs(sampler="dpm_solver", solver_order=3, solver_method="adaptive")
    x_T = np.random.default_rng(3).standard_normal(LATENT).astype(np.float32)
    jspec = JP.make_guidance_spec(jb, PROMPT, NEGATIVE)
    want, w_times = _jax_adaptive_iters(jb, jcfg, x_T, jspec)
    _close(want, JP.sample_latents(jb, jspec, jcfg, x_init=jnp.asarray(x_T)))
    times = []
    inner = M.unet_apply

    def recording(cfg, params, x, t, ctx, **k):
        times.append(float(t[0]))
        return inner(cfg, params, x, t, ctx, **k)

    monkeypatch.setattr(M, "unet_apply", recording)
    got = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T), decode=False)[1]
    assert len(times) == len(w_times) and len(times) % 3 == 0
    t_disc = (np.float32(w_times) - np.float32(1e-3)) * np.float32(1000)
    # accept (the next iteration starts elsewhere) or reject, iteration by
    # iteration, exactly; the times themselves to 1e-3: the random UNet's
    # embedded pair differs little, so the f32 rounding of the error norm
    # moves each next step size by ~1e-4
    starts_p, starts_w = np.asarray(times[::3]), t_disc[::3]
    np.testing.assert_array_equal(np.diff(starts_p) != 0, np.diff(starts_w) != 0)
    np.testing.assert_allclose(times, t_disc, rtol=1e-3, atol=0.1)
    _close(got, want)


@pytest.mark.parametrize("eta_noises", [False, True])
def test_txt2img_dpm_adaptive_matches_jax(bundles, monkeypatch, eta_noises):
    """DPM Adaptive through the sigma family from the same scaled x_T; the
    injected noises reach the sampler in both packages (at the pipeline's
    eta = 0 neither uses them). The count of UNet calls is the JAX loop's
    NFE: 3 an iteration."""
    jb, pb = bundles
    jcfg, pcfg = _cfgs(sampler="DPM Adaptive", steps=8)
    sigmas = P._sigma_schedule(pb, pcfg)
    x_T = (np.random.default_rng(4).standard_normal(LATENT) * sigmas[0]).astype(np.float32)
    noises = np.random.default_rng(5).standard_normal((200,) + LATENT).astype(np.float32)
    kw = dict(noises=noises) if eta_noises else {}
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, PROMPT, NEGATIVE), jcfg,
                             x_init=jnp.asarray(x_T),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    unet = _UnetCalls(monkeypatch)
    got = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT, NEGATIVE), pcfg,
                           x_init=torch.from_numpy(x_T), **kw)
    assert unet.n > 0 and unet.n % 3 == 0
    _close(got, want)


def test_blur_matches_the_jax_sampler_core_and_pins_the_dropped_x_T(bundles, monkeypatch):
    """Blur from an injected x_T with injected noises, against the JAX
    process's own steps driven by the JAX denoiser (its pipeline draws x_T
    and the noises from its key). A known difference, pinned: the JAX
    pipeline drops an injected x_T, so two different x_T render the same
    there, and differently here."""
    jb, pb = bundles
    steps = 4
    jcfg, pcfg = _cfgs(sampler="Blur", steps=steps)
    rng = np.random.default_rng(6)
    x_T = rng.standard_normal(LATENT).astype(np.float32)
    noises = rng.standard_normal((steps,) + LATENT).astype(np.float32)
    jspec = JP.make_guidance_spec(jb, PROMPT, NEGATIVE)
    eps_fn, _ = JG.make_denoiser(JP._unet_eps_fn(jb), jspec, gcfg=jcfg.guidance)
    proc = JSA.BlurDiffusion(n=steps, resolution=LATENT[1])
    x = jnp.asarray(x_T)
    for step in range(steps):
        i = steps - step
        t = (jnp.asarray(i, jnp.float32) / steps) * 999.0
        e = eps_fn(x, t, jnp.float32(7.5), jnp.asarray(False))
        x0 = proc.get_x0_from_eps(x, e, i)
        x = x0 if i == 1 else proc.get_mean(x0, i - 1) + proc.get_std(i - 1, jnp.asarray(noises[step]))
    times = []
    inner = M.unet_apply

    def recording(cfg, params, x_, t, ctx, **k):
        times.append(float(t[0]))
        return inner(cfg, params, x_, t, ctx, **k)

    monkeypatch.setattr(M, "unet_apply", recording)
    got = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT, NEGATIVE), pcfg,
                           x_init=torch.from_numpy(x_T), noises=noises)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        times, [np.float32(i) / np.float32(steps) * np.float32(999) for i in range(steps, 0, -1)])
    # the default process is ill-conditioned at a 4x4 latent: cumulative
    # products underflow to 0, x0 takes the 1e6 gain of the clamp there,
    # and the two UNets' 1e-6 differences reach the output at ~1e-2
    # relative (7.7e-3 measured; a wrong noise or timestep is O(1))
    x = np.asarray(x)
    assert float(np.min(proc.Bs_bar_sqrt[2:])) == 0.0
    rel = float(np.linalg.norm(got.numpy() - x) / np.linalg.norm(x))
    assert rel <= 5e-2

    other = rng.standard_normal(LATENT).astype(np.float32)
    a, b = (np.asarray(JP.txt2img(jb, PROMPT, NEGATIVE, cfg=jcfg, x_T=jnp.asarray(v),
                                  decode=False)[1]) for v in (x_T, other))
    np.testing.assert_array_equal(a, b)
    c = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(other), noises=noises,
                  decode=False)[1]
    assert not np.allclose(c.numpy(), got.numpy())
    with pytest.raises(ValueError, match="square"):
        P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT), P.RenderConfig(
            sampler="Blur", steps=2, width=32, height=64))


def test_plms_img2img_runs_the_whole_schedule_as_jax(bundles, monkeypatch):
    """PLMS img2img: the JAX package passes the img2img start to DDIM only,
    so PLMS runs its whole schedule from the partly noised latent; the port
    does the same (steps + 1 UNet calls, not t_enc), against the chain
    assembled from the JAX functions with the same injected noises."""
    jb, pb = bundles
    steps, strength = 5, 0.5
    kw = dict(steps=steps, sampler="PLMS", width=32, height=32, guidance_scale=7.5,
              denoising_strength=strength)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    z_shape = (1, 16, 16, 4)  # the tiny VAE scales by 2
    enc_noise = rng.standard_normal(z_shape).astype(np.float32)
    noise = rng.standard_normal(z_shape).astype(np.float32)
    itables = P.S.make_inference_tables(pb.tables, steps)
    s = itables.num_steps
    t_enc = P.img2img_t_enc(strength, s, "t")
    assert t_enc < s

    post = JM.vae_encode(jb.vae_cfg, jb.vae_params,
                         jnp.asarray(image, jnp.float32)[None] / 127.5 - 1.0)
    z0 = (post.mean + post.std * jnp.asarray(enc_noise)) * JP.LATENT_SCALE
    a_t = float(itables.alphas_cumprod_t[t_enc - 1])
    x_t = np.sqrt(a_t) * z0 + np.sqrt(1 - a_t) * jnp.asarray(noise)
    jspec = JP.make_guidance_spec(jb, "a cat", "")
    # the JAX render donates its start: each call gets a copy
    want = JP.sample_latents(jb, jspec, jcfg, x_init=jnp.array(x_t), t_start=t_enc)
    whole = JP.sample_latents(jb, jspec, jcfg, x_init=jnp.array(x_t))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(whole))

    unet = _UnetCalls(monkeypatch)
    _, got = P.img2img(pb, image, "a cat", cfg=pcfg, encode_noise=enc_noise, noise=noise,
                       decode=False)
    assert unet.n == s + 1  # every step of the table, the first one twice
    _close(got, want)


@pytest.mark.parametrize("sampler", ["dpm_solver", "DPM Solver", "UniPC", "iPNDM"])
def test_img2img_raises_for_the_solver_and_trig_families(bundles, sampler):
    jb, pb = bundles
    jcfg, pcfg = JP.RenderConfig(sampler=sampler, steps=3, width=32, height=32), \
        P.RenderConfig(sampler=sampler, steps=3, width=32, height=32)
    image = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(ValueError) as w_err:
        JP.img2img(jb, image, "a cat", cfg=jcfg)
    with pytest.raises(ValueError) as g_err:
        P.img2img(pb, image, "a cat", cfg=pcfg)
    assert str(g_err.value) == str(w_err.value)


@pytest.mark.parametrize("sampler,kw", [("DDIM", {}), ("PLMS", {}), ("Euler", {}),
                                        ("DPM Adaptive", dict(steps=6))])
def test_step_callback_sees_what_jax_sees(bundles, sampler, kw):
    """step_callback(t, x0) at every denoiser evaluation: the same sequence
    of times and x0 predictions as the JAX package's on the CPU, as numpy
    arrays; the render itself is unchanged by the hook."""
    jb, pb = bundles
    kw = {"steps": 4, **kw}
    jcfg, pcfg = _cfgs(sampler=sampler, **kw)
    x_T = np.random.default_rng(8).standard_normal(LATENT).astype(np.float32)
    if sampler in ("Euler", "DPM Adaptive"):
        x_T = x_T * np.float32(P._sigma_schedule(pb, pcfg)[0])
    seen_j, seen_p = [], []
    w_lat = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=jcfg, x_T=jnp.asarray(x_T), decode=False,
                       step_callback=lambda t, x0: seen_j.append((np.asarray(t), np.asarray(x0))))[1]
    w_lat = np.asarray(w_lat)
    jax.effects_barrier()
    _, g_lat = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T),
                         decode=False, step_callback=lambda t, x0: seen_p.append((t, x0)))
    _close(g_lat, w_lat)
    if sampler == "DPM Adaptive":
        # the JAX loop evaluates the order-3 pair's shared first stage twice
        # (4 calls an iteration, its NFE counts 3); the port once
        assert len(seen_j) % 4 == 0
        for k in range(0, len(seen_j), 4):
            np.testing.assert_array_equal(seen_j[k + 1][1], seen_j[k + 2][1])
        seen_j = [e for k, e in enumerate(seen_j) if k % 4 != 2]
    assert len(seen_p) == len(seen_j) > 0
    for (gt, gx), (wt, wx) in zip(seen_p, seen_j):
        assert isinstance(gt, np.ndarray) and isinstance(gx, np.ndarray)
        # DPM Adaptive's sigmas come from its controller, which carries the
        # f32 rounding of each error norm into the next step (as in the
        # adaptive solver's slice test); the fixed grids agree to f32
        tol = 1e-3 if sampler == "DPM Adaptive" else None
        np.testing.assert_allclose(gt, wt, rtol=tol or 1e-6)
        assert gx.shape == wx.shape == LATENT
        if tol:  # x0 at those sigmas
            np.testing.assert_allclose(gx, wx, rtol=tol, atol=tol)
        else:
            _close(gx, wx)
    plain = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T),
                      decode=False)[1]
    torch.testing.assert_close(plain, g_lat, rtol=0, atol=0)


def test_render_callback_collects_preview_frames(bundles):
    """make_render_callback as a step_callback of the port: one uint8 frame
    an evaluation (every=1), equal to latent_preview of the x0 it saw."""
    _, pb = bundles
    xs = []
    cb = C.make_render_callback()
    _, pcfg = _cfgs(sampler="DDIM", steps=4)

    def both(t, x0):
        xs.append(x0)
        cb(t, x0)

    P.txt2img(pb, PROMPT, cfg=pcfg, decode=False, step_callback=both)
    assert cb.count == len(cb.frames) == len(xs) == 4
    for frame, x0 in zip(cb.frames, xs):
        assert frame.dtype == np.uint8 and frame.shape == (4, 4, 3)
        np.testing.assert_array_equal(frame, C.latent_preview(x0))


@pytest.mark.parametrize("sampler,kw", [("UniPC", {}), ("iPNDM", {}), ("Blur", {}),
                                        ("PLMS", dict(eta=0.3))])
def test_new_samplers_draw_from_the_generator(bundles, sampler, kw):
    """Without x_T or noises the generator seeded from cfg.seed draws them:
    one seed gives one render, another a different one."""
    _, pb = bundles
    cfg = P.RenderConfig(sampler=sampler, steps=3, width=32, height=32, seed=3, **kw)
    a, b = (P.txt2img(pb, "a cat", cfg=cfg, decode=False)[1] for _ in range(2))
    c = P.txt2img(pb, "a cat", cfg=dataclasses.replace(cfg, seed=4), decode=False)[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and bool(torch.isfinite(a).all())
