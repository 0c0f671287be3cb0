"""Port parity of the orchestration layer: the manager's JSON API
(``_make_render_config``, ``process_txt2img``, ``process_img2img`` plain and
masked through RePaint), ``sample_repaint`` and the render engine
(independent frames and the latent-feedback start).

The JAX package draws its noise from ``jax.random`` keys; the tests draw
the same numbers from the same keys and inject them into the port (x_T,
posterior and forward noise, RePaint's per-transition noise), or record
the port's draws and replay them into the JAX functions. The tiny JAX
bundle's weights reach the port through ``from_jax_bundle``; f32 on the
CPU at a 32x32 canvas (the tiny VAE's 16x16 latent).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import render as JR
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.manager import DiffusionModelManager as JManager
from complex_prompt_diffusion_tpu.prompts import compose as JC
from complex_prompt_diffusion_tpu.samplers import repaint as JRP
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import render as R
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.manager import DiffusionModelManager
from complex_prompt_diffusion_tpu_torch.prompts import compose as C
from complex_prompt_diffusion_tpu_torch.samplers import repaint as RP

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_sampler_slice.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
# f32 elementwise arithmetic on the same inputs
OP_TOL = 1e-6


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


# ---- config assembly ----

CONFIGS = [
    {},
    {"sampler": {"name": "Euler Ancestral", "args": {"ddim_eta": 0.3, "s_noise": 0.9}},
     "render": {"W": 64, "H": 32, "n_samples": 2, "steps": 7, "seed": 3, "unknown": 1}},
    {"sampler": {"name": "DPM++ 2m"}, "render": {"scheduler": "karras", "scale": 5.0,
                                                "score_corrector": "static_thresholding",
                                                "score_corrector_e_threshold": 1.5,
                                                "score_corrector_x_threshold": 2.0}},
    {"sampler": {"name": "DDIM", "args": {"steps": 9}},
     "render": {"unconditional_guidance_scale": 9.0, "steps": 11, "clip_sample": "static_thresholding",
                "score_corrector": "dynamic_thresholding"}},
]


@pytest.mark.parametrize("config", CONFIGS, ids=range(len(CONFIGS)))
def test_make_render_config_gives_jax_fields(bundles, config):
    """The reference's aliases (W, H, ddim_eta, n_samples, scheduler,
    scale, unconditional_guidance_scale) and score_corrector ->
    threshold_e: the same RenderConfig fields in both packages."""
    jb, pb = bundles
    got = DiffusionModelManager(bundle=pb)._make_render_config(config)
    want = JManager(bundle=jb)._make_render_config(config)
    assert P.render_config_to_json(got) == JP.render_config_to_json(want)


def test_manager_refuses_what_jax_refuses(bundles):
    jb, pb = bundles
    for mgr in (DiffusionModelManager(bundle=pb), JManager(bundle=jb)):
        with pytest.raises(KeyError):
            mgr._make_render_config({"sampler": {"name": "nope"}})
    with pytest.raises(ValueError):
        DiffusionModelManager()


# ---- txt2img ----

def _jax_x_T(seed, shape):
    """The x_T JAX's sample_latents draws for a render with this seed."""
    key_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.array(jax.random.normal(key_init, shape, jnp.float32))


TXT2IMG = [
    {"sampler": {"name": "DDIM"}, "prompt_json": {"class": "WeightedPrompt",
                                                  "prompt": "a cat:2.0 a dog:1.0"},
     "render": {"steps": 5, "W": 32, "H": 32, "seed": 4}},
    {"sampler": {"name": "DPM++ 2m"}, "negative_prompt": "blurry",
     "prompt_json": {"class": "CompositionalPrompt", "prompt": "a castle",
                     "conjunctions": [{"prompt": "a dragon", "scale": 1.5,
                                       "mask": "left_half_valid"}]},
     "render": {"steps": 5, "W": 32, "H": 32, "scheduler": "karras", "seed": 5,
                "score_corrector": "dynamic_thresholding"}},
    {"sampler": {"name": "DDIM"}, "prompt": "a red cube", "negative_prompt": "blurry",
     "render": {"steps": 4, "W": 32, "H": 32, "n_samples": 2, "seed": 6}},
]


@pytest.mark.parametrize("config", TXT2IMG, ids=range(len(TXT2IMG)))
def test_process_txt2img_equals_jax(bundles, config):
    """The JAX manager draws x_T from its seed; the port's is handed the
    same numbers (scaled by the first sigma for the sigma family, as JAX
    scales its draw)."""
    jb, pb = bundles
    want = JManager(bundle=jb).process_txt2img(config)
    mgr = DiffusionModelManager(bundle=pb)
    cfg = mgr._make_render_config(config)
    x_T = _jax_x_T(cfg.seed, (cfg.batch_size,) + cfg.latent_shape)
    if P.get_sampler(cfg.sampler)[0] == "sigma":
        x_T = x_T * float(P._sigma_schedule(pb, cfg)[0])
    got = mgr.process_txt2img(config, x_T=torch.from_numpy(x_T))
    _u8_close(got, want)


def _image(seed, hw=32):
    return np.random.default_rng(seed).integers(0, 256, (1, hw, hw, 3), dtype=np.uint8)


def test_process_img2img_equals_jax(bundles):
    """DDIM img2img through the manager: the posterior and forward noise JAX
    draws from its seed's keys, handed to the port."""
    jb, pb = bundles
    config = {"sampler": {"name": "DDIM"}, "prompt": "a blue sphere",
              "render": {"steps": 6, "W": 32, "H": 32, "seed": 7, "denoising_strength": 0.6}}
    image = _image(8)
    want = JManager(bundle=jb).process_img2img(image, config)
    k_enc, k_noise, _ = jax.random.split(jax.random.PRNGKey(7), 3)
    z_shape = (1, 16, 16, 4)
    enc_noise = np.array(jax.random.normal(k_enc, z_shape))
    noise = np.array(jax.random.normal(k_noise, z_shape, jnp.float32))
    got = DiffusionModelManager(bundle=pb).process_img2img(image, config, encode_noise=enc_noise,
                                                           noise=noise)
    _u8_close(got, want)


# ---- RePaint ----

def _jax_repaint_noise(seed, shape, n):
    """x_T and the per-transition noise JAX's sample_repaint draws."""
    key, k0 = jax.random.split(jax.random.PRNGKey(seed))
    x_T = np.array(jax.random.normal(k0, shape, jnp.float32))
    noises = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                                    jnp.float32)) for i in range(n)])
    return x_T, noises


@pytest.mark.parametrize("steps,jump_length,jump_n_sample,eta", [(10, 5, 2, 1.0), (8, 2, 3, 0.5),
                                                                 (6, 10, 10, 1.0)])
def test_sample_repaint_equals_jax(bundles, steps, jump_length, jump_n_sample, eta):
    """The tiny UNet under a CFG closure with eps thresholding; JAX's
    per-transition noise drawn here and injected as ``noises``."""
    jb, pb = bundles
    rows = RP.repaint_rows(pb.tables, steps, jump_length, jump_n_sample, eta)
    walk = JS.jump_timesteps(steps, 1000, jump_length, jump_n_sample)
    np.testing.assert_array_equal(rows["t"], walk)
    shape = (1, 4, 4, 4)
    rng = np.random.default_rng(9)
    original = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[:, :, :2] = 1.0
    x_T, noises = _jax_repaint_noise(10, shape, len(walk))
    jspec = JP.make_guidance_spec(jb, "a castle", "fog")
    jeps, _ = JG.make_denoiser(JP._unet_eps_fn(jb), jspec,
                               gcfg=JG.GuidanceConfig(threshold_e="static_thresholding",
                                                      threshold_e_value=2.0))
    want = JRP.sample_repaint(jeps, jnp.asarray(original), jnp.asarray(mask), jb.tables,
                              steps=steps, jump_length=jump_length, jump_n_sample=jump_n_sample,
                              eta=eta, key=jax.random.PRNGKey(10), uc_scale=7.5)
    pspec = P.make_guidance_spec(pb, "a castle", "fog")

    def unet_eps(x, t, ctx):
        return P.M.unet_apply(pb.unet_cfg, pb.unet_params, x, t, ctx)

    peps, _ = G.make_denoiser(unet_eps, pspec,
                              gcfg=G.GuidanceConfig(threshold_e="static_thresholding",
                                                    threshold_e_value=2.0))
    with torch.inference_mode():
        got = RP.sample_repaint(peps, torch.from_numpy(original), torch.from_numpy(mask),
                                pb.tables, steps=steps, jump_length=jump_length,
                                jump_n_sample=jump_n_sample, eta=eta, x_T=torch.from_numpy(x_T),
                                noises=torch.from_numpy(noises), uc_scale=7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    # the known region is the original noised to the last transition's step
    assert not torch.allclose(got[:, :, 2:], torch.from_numpy(original)[:, :, 2:])


def test_repaint_draws_from_a_generator(bundles):
    _, pb = bundles

    def eps(x, t, uc, blur_on):
        assert blur_on is False
        return torch.zeros_like(x)

    orig, mask = torch.zeros((1, 4, 4, 4)), torch.ones((1, 4, 4, 4))
    runs = [RP.sample_repaint(eps, orig, mask, pb.tables, steps=4, jump_length=2,
                              jump_n_sample=2, generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError):
        RP.sample_repaint(eps, orig, mask, pb.tables, steps=4)


def test_mask_resize_is_jax_nearest():
    """``jax.image.resize(method="nearest")`` samples at half-pixel centres:
    F.interpolate's "nearest-exact" is bit-equal to it, "nearest" is not."""
    m = (np.random.default_rng(11).random((1, 100, 100, 1)) > 0.5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (1, 12, 12, 1), method="nearest"))
    t = torch.from_numpy(m).permute(0, 3, 1, 2)
    exact = F.interpolate(t, size=(12, 12), mode="nearest-exact").permute(0, 2, 3, 1).numpy()
    plain = F.interpolate(t, size=(12, 12), mode="nearest").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(exact, want)
    assert not np.array_equal(plain, want)


def test_process_img2img_masked_repaint_equals_jax(bundles):
    """A mask whose edges fall off the 8-pixel grid (rows 5 and 27, column
    13), resized to the 16x16 latent; RePaint with steps 10, jump_length 5,
    jump_n_sample 2, a compositional prompt; JAX's draws injected. The
    factors' masks are scalar: both managers size spatial masks at
    pixels / 8, and the tiny VAE's latent is pixels / 2."""
    jb, pb = bundles
    prompt = {"class": "CompositionalPrompt", "prompt": "a castle",
              "negations": [{"prompt": "a wall", "scale": 0.5, "mask": 0.8}]}
    config = {"sampler": {"name": "DDIM"}, "prompt_json": prompt, "jump_length": 5,
              "jump_n_sample": 2, "render": {"steps": 10, "W": 32, "H": 32, "seed": 12}}
    image = _image(13)
    mask = np.ones((32, 32), np.float32)
    mask[5:27, 13:] = 0.0
    want = JManager(bundle=jb).process_img2img(image, config, mask=mask)
    n = len(JS.jump_timesteps(10, 1000, 5, 2))
    x_T, noises = _jax_repaint_noise(12, (1, 16, 16, 4), n)
    got = DiffusionModelManager(bundle=pb).process_img2img(
        image, config, mask=mask, x_T=torch.from_numpy(x_T), noises=torch.from_numpy(noises))
    _u8_close(got, want)


def test_nine_channel_inpaint_waits_for_its_item(bundles, monkeypatch):
    """A mask on a 9-channel UNet no longer raises: the manager hands it to
    ``pipeline.inpaint`` (tests/test_torch_inpaint.py holds that branch to
    JAX's), not to RePaint."""
    _, pb = bundles
    nine = P.ModelBundle.random("tiny-inpaint", device="cpu")
    seen = []
    monkeypatch.setattr(DiffusionModelManager, "_inpaint", lambda *a, **k: seen.append("repaint"))
    imgs = DiffusionModelManager(bundle=nine).process_img2img(
        _image(1, 8), {"render": {"W": 32, "H": 32, "steps": 2}}, mask=np.ones((8, 8), np.float32))
    assert not seen and imgs.shape == (1, 8, 8, 3) and imgs.dtype == np.uint8


# ---- the render engine ----

def _lerp_prompt(mod, bundle):
    p = mod.ComplexPrompt("a red cube on a table", "blurry", bundle=bundle)
    return p.add_prompt_lerp("a blue sphere on a table", magnitude=0.9, lerp_keys=["magnitude"])


def test_render_path_frames_equal_jax(bundles, monkeypatch):
    """Three independent frames along a lerp path: each frame's x_T, drawn
    from the engine's generator, is recorded and replayed into JAX's
    sample_latents with the JAX path's frame embedding."""
    jb, pb = bundles
    cfg_kw = dict(steps=4, width=32, height=32, batch_size=1, seed=14)
    seen = []
    inner = R.sample_latents

    def recording(bundle, spec, cfg, **kw):
        lat = inner(bundle, spec, cfg, **kw)
        seen.append((kw["x_init"].clone(), lat.clone()))
        return lat

    monkeypatch.setattr(R, "sample_latents", recording)
    frames = R.RenderEngine(pb, P.RenderConfig(**cfg_kw)).render_path(_lerp_prompt(C, pb), 3)
    assert len(frames) == len(seen) == 3 and frames[0].shape == (8, 8, 3)
    jp = _lerp_prompt(JC, jb)
    path, uncond = jp.embedding_path(steps=3, bundle=jb), jp.uncond_embedding(jb)
    jcfg = JP.RenderConfig(**cfg_kw)
    for cond, (x_T, got) in zip(path, seen):
        want = JP.sample_latents(jb, JG.GuidanceSpec.single(jnp.asarray(cond), jnp.asarray(uncond)),
                                 jcfg, x_init=jnp.asarray(x_T.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL,
                                   atol=SLICE_ATOL)
    assert not torch.equal(seen[0][0], seen[1][0])  # a fresh x_T a frame


@pytest.mark.parametrize("feedback", [False, True])
def test_render_path_sigma_family_start_equals_jax(bundles, monkeypatch, feedback):
    """Euler frames (independent, and the first feedback frame) start from
    x_T scaled by the schedule's first sigma (14.61 for SD's tables), as
    JAX's engine starts them: it passes a key, and JAX's sample_latents
    scales the draw it makes from it. The start reaching sample_latents is
    the engine's generator draw times sigmas[0] (std ~ 14.6, not ~1), and
    the frames equal JAX's sample_latents from that start."""
    jb, pb = bundles
    cfg_kw = dict(steps=4, width=32, height=32, batch_size=1, seed=19, sampler="Euler")
    pcfg, jcfg = P.RenderConfig(**cfg_kw), JP.RenderConfig(**cfg_kw)
    sigma0 = float(P._sigma_schedule(pb, pcfg)[0])
    assert abs(sigma0 - 14.6146) < 1e-3
    seen = []
    inner = R.sample_latents

    def recording(bundle, spec, cfg, **kw):
        lat = inner(bundle, spec, cfg, **kw)
        seen.append((kw["x_init"].clone(), lat.clone(), kw.get("t_start")))
        return lat

    monkeypatch.setattr(R, "sample_latents", recording)
    R.RenderEngine(pb, pcfg).render_path(_lerp_prompt(C, pb), 2, feedback=feedback)
    x0 = seen[0][0]
    draw = torch.randn(x0.shape, generator=torch.Generator().manual_seed(19))
    torch.testing.assert_close(x0, draw * sigma0, rtol=0, atol=0)
    assert 10.0 < float(x0.std()) < 20.0
    jp = _lerp_prompt(JC, jb)
    path, uncond = jp.embedding_path(steps=2, bundle=jb), jp.uncond_embedding(jb)
    frames = seen if not feedback else seen[:1]  # a feedback frame starts on the table
    for cond, (x_T, got, t_start) in zip(path, frames):
        assert t_start is None and float(x_T.std()) > 10.0
        spec = JG.GuidanceSpec.single(jnp.asarray(cond), jnp.asarray(uncond))
        want = JP.sample_latents(jb, spec, jcfg, x_init=jnp.asarray(x_T.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL,
                                   atol=SLICE_ATOL)
    # JAX's engine: sample_latents(key=k) starts from normal(split(k)[0]) * sigmas[0]
    k = jax.random.fold_in(jax.random.PRNGKey(19), 0)
    spec = JG.GuidanceSpec.single(jnp.asarray(path[0]), jnp.asarray(uncond))
    start = np.asarray(jax.random.normal(jax.random.split(k)[0], x0.shape, jnp.float32)) * sigma0
    np.testing.assert_allclose(np.asarray(JP.sample_latents(jb, spec, jcfg, key=k)),
                               np.asarray(JP.sample_latents(jb, spec, jcfg,
                                                            x_init=jnp.asarray(start))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("diversity", [0.0, 0.3])
def test_feedback_start_equals_jax(bundles, diversity):
    """The start of a feedback frame: the JAX loop's arithmetic on its keys'
    draws (k_n for the renoise, k_d for the diversity and the forward noise)
    against ``feedback_start`` with the same draws."""
    jb, pb = bundles
    prev = np.random.default_rng(15).standard_normal((1, 4, 4, 4)).astype(np.float32)
    k_n, k_d, _ = jax.random.split(jax.random.PRNGKey(16), 3)
    coherance, strength, steps = 0.9, 0.6, 8
    x = JR.add_noise(jnp.asarray(prev), 1.0 - coherance, k_n)
    if diversity > 0:
        x = JR.sqrt_lerp(x, jax.random.normal(k_d, x.shape, x.dtype), diversity)
    itables = JS.make_inference_tables(jb.tables, steps)
    t_start = max(1, int((1 - strength) * itables.num_steps))
    a_t = float(itables.alphas_cumprod_t[t_start - 1])
    want = np.sqrt(a_t) * x + np.sqrt(1 - a_t) * jax.random.normal(k_d, x.shape, jnp.float32)
    n = torch.from_numpy(np.array(jax.random.normal(k_n, prev.shape, jnp.float32)))
    d = torch.from_numpy(np.array(jax.random.normal(k_d, prev.shape, jnp.float32)))
    got, got_t = R.feedback_start(torch.from_numpy(prev),
                                  P.S.make_inference_tables(pb.tables, steps), strength,
                                  coherance, diversity, n, d)
    assert got_t == t_start
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(R.sqrt_lerp(n, d, 0.4).numpy(),
                               np.asarray(JR.sqrt_lerp(jnp.asarray(n.numpy()),
                                                       jnp.asarray(d.numpy()), 0.4)),
                               rtol=OP_TOL, atol=OP_TOL)


def test_render_path_feedback_runs_the_tail_of_the_table(bundles, monkeypatch):
    """Two feedback frames: the first from a fresh x_T over the whole table,
    the second from ``feedback_start`` of the first's latent over its first
    t_start steps; one seed gives the same frames."""
    _, pb = bundles
    cfg = P.RenderConfig(steps=6, width=32, height=32, seed=17, denoising_strength=0.5)
    calls = []
    inner = R.sample_latents

    def recording(bundle, spec, cfg_, **kw):
        calls.append(kw.get("t_start"))
        return inner(bundle, spec, cfg_, **kw)

    monkeypatch.setattr(R, "sample_latents", recording)
    runs = [R.RenderEngine(pb, cfg).render_path(_lerp_prompt(C, pb), 2, feedback=True,
                                                diversity=0.2) for _ in range(2)]
    assert calls == [None, 3] * 2
    assert len(runs[0]) == 2 and runs[0][1].shape == (8, 8, 3)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
