"""Port parity of a v-parameterized SD-2.x bundle through every sampler
family, and of an eps bundle of the same shape: the same x_T and noises in
both packages (DDIM with and without eta, PLMS, Euler Ancestral, DPM++ 2M
Karras, DPM-Solver++, UniPC, iPNDM, Blur, DDIM img2img, the decoded
image). Split from ``test_torch_sd2.py`` (the presets, the models and the
kernel sites stay there) so that a run distributing files over workers
runs the two halves side by side; the bundles are ``_sd2_tiny.py``'s.
f32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu_torch import pipeline as P

from _sd2_tiny import LATENT, NEGATIVE, PIXELS, PROMPT, SIDE, _close, _close_scaled
from _sd2_tiny import eps_bundles, v_bundles  # noqa: F401 (fixtures: registered by the import)
from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)


# ---- the v-parameterization through every sampler family ----

def _cfgs(**kw):
    kw = dict(width=PIXELS, height=PIXELS, batch_size=2, guidance_scale=7.5, **kw)
    return JP.RenderConfig(**kw), P.RenderConfig(**kw)


# (sampler, options, whether x_T is scaled by the first sigma)
FAMILY_CASES = [
    ("DDIM", dict(steps=4), False),
    ("DDIM", dict(steps=4, eta=0.5), False),
    ("PLMS", dict(steps=4), False),
    ("Euler Ancestral", dict(steps=4), True),
    ("DPM++ 2m", dict(steps=4, sigma_schedule="karras"), True),
    ("dpm_solver", dict(steps=4, solver_order=2, solver_method="multistep"), False),
    ("UniPC", dict(steps=4, solver_order=2, unipc_variant="bh2"), False),
    ("iPNDM", dict(steps=4), False),
]


@pytest.mark.parametrize("sampler,kw,scaled", FAMILY_CASES,
                         ids=[f"{s}-{i}" for i, (s, _, _) in enumerate(FAMILY_CASES)])
def test_v_bundle_latents_match_jax(v_bundles, sampler, kw, scaled):
    """The same x_T and noises in both packages; a v-model converts where
    the JAX package converts it (t family: eps from v at the integer t;
    sigma family: the denoiser's c_skip / c_out; the solver and trig
    families take the output as it is)."""
    jb, pb = v_bundles
    jcfg, pcfg = _cfgs(sampler=sampler, **kw)
    rng = np.random.default_rng(21)
    x_T = rng.standard_normal(LATENT).astype(np.float32)
    if scaled:
        x_T = x_T * np.float32(P._sigma_schedule(pb, pcfg)[0])
    noises = rng.standard_normal((kw["steps"] + 1,) + LATENT).astype(np.float32)
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, PROMPT, NEGATIVE), jcfg,
                             x_init=jnp.asarray(x_T), noises=jnp.asarray(noises))
    got = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT, NEGATIVE), pcfg,
                           x_init=torch.from_numpy(x_T), noises=torch.from_numpy(noises))
    _close(got, want)


def test_v_bundle_blur_matches_the_jax_sampler_core(v_bundles):
    """Blur on a v-bundle: JAX's blur family feeds the UNet's raw output to
    its process as eps; the port does the same (its core against JAX's
    steps from the same x_T and noises, as the eps slice test holds it)."""
    from complex_prompt_diffusion_tpu import samplers as JSA
    from complex_prompt_diffusion_tpu.guidance import cfg as JG

    jb, pb = v_bundles
    steps = 3
    jcfg, pcfg = _cfgs(sampler="Blur", steps=steps)
    rng = np.random.default_rng(22)
    x_T = rng.standard_normal(LATENT).astype(np.float32)
    noises = rng.standard_normal((steps,) + LATENT).astype(np.float32)
    jspec = JP.make_guidance_spec(jb, PROMPT, NEGATIVE)
    eps_fn, _ = JG.make_denoiser(JP._unet_eps_fn(jb), jspec, gcfg=jcfg.guidance)
    proc = JSA.BlurDiffusion(n=steps, resolution=SIDE)
    x = jnp.asarray(x_T)
    for step in range(steps):
        i = steps - step
        e = eps_fn(x, (jnp.asarray(i, jnp.float32) / steps) * 999.0, jnp.float32(7.5),
                   jnp.asarray(False))
        x0 = proc.get_x0_from_eps(x, e, i)
        x = x0 if i == 1 else proc.get_mean(x0, i - 1) + proc.get_std(
            i - 1, jnp.asarray(noises[step]))
    got = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT, NEGATIVE), pcfg,
                           x_init=torch.from_numpy(x_T), noises=noises)
    # the blur process's underflowed products give x0 a large gain (see the
    # eps slice test); relative L2 as there
    x = np.asarray(x)
    assert float(np.linalg.norm(got.numpy() - x) / np.linalg.norm(x)) <= 5e-2


def test_v_bundle_ddim_img2img_matches_jax(v_bundles):
    """DDIM img2img on a v-bundle: the chain assembled from the JAX
    functions with the same injected noises, started at step t_enc."""
    jb, pb = v_bundles
    steps, strength = 5, 0.6
    kw = dict(steps=steps, sampler="DDIM", width=PIXELS, height=PIXELS, guidance_scale=7.5,
              denoising_strength=strength)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    rng = np.random.default_rng(23)
    image = rng.integers(0, 256, (2 * SIDE, 2 * SIDE, 3)).astype(np.uint8)  # tiny VAE: 2x
    z_shape = (1, SIDE, SIDE, 4)
    enc_noise = rng.standard_normal(z_shape).astype(np.float32)
    noise = rng.standard_normal(z_shape).astype(np.float32)
    itables = P.S.make_inference_tables(pb.tables, steps)
    t_enc = P.img2img_t_enc(strength, itables.num_steps, "t")
    post = JM.vae_encode(jb.vae_cfg, jb.vae_params,
                         jnp.asarray(image, jnp.float32)[None] / 127.5 - 1.0)
    z0 = (post.mean + post.std * jnp.asarray(enc_noise)) * JP.LATENT_SCALE
    a_t = float(itables.alphas_cumprod_t[t_enc - 1])
    x_t = np.sqrt(a_t) * z0 + np.sqrt(1 - a_t) * jnp.asarray(noise)
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, "a cat", ""), jcfg,
                             x_init=jnp.array(x_t), t_start=t_enc)
    _, got = P.img2img(pb, image, "a cat", cfg=pcfg, encode_noise=enc_noise, noise=noise,
                       decode=False)
    _close(got, want)


def test_v_conversion_changes_the_t_and_sigma_families(v_bundles, eps_bundles):
    """The same weights read as eps and as v render differently in the
    families that convert, and alike in those that take the output as it
    is (the solver family): the conversion is applied once, where JAX
    applies it."""
    (_, pv), (_, pe) = v_bundles, eps_bundles
    x_T = torch.from_numpy(np.random.default_rng(24).standard_normal(LATENT).astype(np.float32))
    for sampler, differs in (("DDIM", True), ("Euler", True), ("UniPC", False)):
        _, cfg = _cfgs(sampler=sampler, steps=3)
        x = x_T * float(P._sigma_schedule(pv, cfg)[0]) if sampler == "Euler" else x_T
        a, b = (P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT), cfg, x_init=x)
                for pb in (pv, pe))
        assert (not torch.allclose(a, b)) == differs, sampler


@pytest.mark.parametrize("sampler,kw", [("DDIM", dict(steps=4)), ("Euler", dict(steps=4)),
                                        ("UniPC", dict(steps=4))])
def test_eps_bundle_unchanged(eps_bundles, sampler, kw):
    """An eps-model of SD 2.x's shape still renders as the JAX package does."""
    jb, pb = eps_bundles
    jcfg, pcfg = _cfgs(sampler=sampler, **kw)
    x_T = np.random.default_rng(25).standard_normal(LATENT).astype(np.float32)
    if sampler == "Euler":
        x_T = x_T * np.float32(P._sigma_schedule(pb, pcfg)[0])
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, PROMPT, NEGATIVE), jcfg,
                             x_init=jnp.asarray(x_T))
    got = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT, NEGATIVE), pcfg,
                           x_init=torch.from_numpy(x_T))
    _close_scaled(got, want)


def test_v_bundle_txt2img_decodes_as_jax(v_bundles):
    """The whole v render, prompt to uint8 image, DDIM."""
    jb, pb = v_bundles
    jcfg, pcfg = _cfgs(sampler="DDIM", steps=3)
    x_T = np.random.default_rng(26).standard_normal(LATENT).astype(np.float32)
    w_img, w_lat = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=jcfg, x_T=jnp.asarray(x_T))
    g_img, g_lat = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T))
    _close(g_lat, w_lat)
    assert g_img.shape == np.asarray(w_img).shape == (2, 2 * SIDE, 2 * SIDE, 3)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1
