"""Port parity of the SD-2.x model family: the presets, the OpenCLIP-shaped
text tower, the SD-2-shaped UNet and a v-parameterized bundle through every
sampler family.

The weights are the JAX package's (random, from its inits) at tiny widths
with SD 2.x's shapes: 64-channel heads (one at 64 channels, two at 128),
linear proj_in/out, a gelu text tower read at its penultimate layer, a
tokenizer that pads with 0. They reach the port through ``ModelBundle.from_jax_bundle``; x_T and the
injected noises come from numpy with fixed seeds. f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu.ops.attention import attention as jax_attention
from complex_prompt_diffusion_tpu.prompts.tokenizer import get_tokenizer as j_tokenizer
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.ops.attention import flash_attention

# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_sampler_slice.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
# f32 whole-model outputs of O(1), sums in another order (as
# tests/test_torch_models.py)
MODEL_RTOL, MODEL_ATOL = 2e-5, 2e-5
PROMPT, NEGATIVE = "a lighthouse on a cliff", "blurry"
SIDE = 12  # latent side: level-0 self-attention at S = 144, not a multiple of 128
LATENT = (2, SIDE, SIDE, 4)
PIXELS = 8 * SIDE


def _sd2_tiny_configs():
    """SD 2.x's shapes at tiny widths, in the JAX package's classes."""
    ucfg = dataclasses.replace(JU.UNetConfig.tiny(context_dim=64), model_channels=64,
                               num_heads=-1, num_head_channels=64,
                               use_linear_in_transformer=True, dtype="float32")
    ccfg = dataclasses.replace(JC.CLIPTextConfig.tiny(), activation="gelu")
    return ucfg, JV.VAEConfig.tiny(), ccfg


def _sd2_tiny_jax_bundle(parameterization: str):
    ucfg, vcfg, ccfg = _sd2_tiny_configs()
    key = jax.random.PRNGKey(3)
    unet = JP._unzero_kernels(jax.random.fold_in(key, 1), JM.init_unet(key, ucfg, commit=False))
    return JP.ModelBundle(
        version="sd2", unet_cfg=ucfg, unet_params=unet, vae_cfg=vcfg,
        vae_params=JM.init_vae(key, vcfg, commit=False), clip_cfg=ccfg,
        clip_params=JM.init_clip_text(key, ccfg, commit=False),
        tokenizer=j_tokenizer(vocab_size=ccfg.vocab_size, pad_with_eos=False),
        tables=JS.make_diffusion_tables(), parameterization=parameterization,
        clip_layer="penultimate")


@pytest.fixture(scope="module")
def v_bundles():
    jb = _sd2_tiny_jax_bundle("v")
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


@pytest.fixture(scope="module")
def eps_bundles():
    jb = _sd2_tiny_jax_bundle("eps")
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)


# ---- presets and plan ----

@pytest.mark.parametrize("cls,jcls,name", [
    (M.UNetConfig, JU.UNetConfig, "sd21"), (M.UNetConfig, JU.UNetConfig, "sd2_depth"),
    (M.UNetConfig, JU.UNetConfig, "sd_inpaint"), (M.UNetConfig, JU.UNetConfig, "sd15"),
    (M.CLIPTextConfig, JC.CLIPTextConfig, "sd21"), (M.CLIPTextConfig, JC.CLIPTextConfig, "sd15"),
])
def test_presets_equal_jax(cls, jcls, name):
    """Field for field: the JAX preset converts (every field the port lacks
    at its default) to the port's preset of the same name."""
    assert convert.config_from(cls, getattr(jcls, name)()) == getattr(cls, name)()


def test_sd21_preset_fields():
    cfg, clip = M.UNetConfig.sd21(), M.CLIPTextConfig.sd21()
    assert (cfg.num_head_channels, cfg.context_dim, cfg.use_linear_in_transformer) == \
        (64, 1024, True)
    assert (clip.hidden_size, clip.num_layers, clip.num_heads, clip.activation) == \
        (1024, 24, 16, "gelu")
    assert M.UNetConfig.sd2_depth().in_channels == 5
    assert M.UNetConfig.sd_inpaint().in_channels == 9


@pytest.mark.parametrize("name", ["sd21", "sd2_depth", "sd_inpaint"])
def test_build_plan_equals_jax(name):
    assert M.build_plan(getattr(M.UNetConfig, name)()) == \
        JU.build_plan(getattr(JU.UNetConfig, name)())


def test_sd21_plan_heads_are_64_wide():
    """Every transformer of SD 2.1 has 64-channel heads: 5, 10 and 20 at the
    three attention levels, 20 in the middle block."""
    inp, mid, out = M.build_plan(M.UNetConfig.sd21())
    attn = [d for block in inp + (mid,) + out for d in block if d[0] == "attn"]
    assert {d[3] for d in attn} == {64}
    assert sorted({(d[1], d[2]) for d in attn}) == [(320, 5), (640, 10), (1280, 20)]


# ---- the text tower and the UNet ----

def test_sd2_shaped_clip_matches_jax(v_bundles):
    """gelu (the erf form in both packages), read at the penultimate layer,
    on tokens padded with 0."""
    jb, pb = v_bundles
    assert pb.tokenizer.pad_id == 0 == jb.tokenizer.pad_id
    tokens = np.asarray(jb.tokenizer([PROMPT, ""]))
    assert (tokens == 0).any()
    np.testing.assert_array_equal(np.asarray(pb.tokenizer([PROMPT, ""])), tokens)
    want = JM.clip_text_apply(jb.clip_cfg, jb.clip_params, jnp.asarray(tokens),
                              layer="penultimate")
    got = M.clip_text_apply(pb.clip_cfg, pb.clip_params, torch.from_numpy(tokens),
                            layer="penultimate")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(P.encode_prompt(pb, [PROMPT, ""]).numpy(),
                               np.asarray(JP.encode_prompt(jb, [PROMPT, ""])),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_sd2_shaped_unet_matches_jax(v_bundles):
    """Linear proj_in/out and 64-channel heads on a 12x12 latent: level-0
    self-attention at S = 144 (K1's path, not a multiple of its 128-row
    tiles), level 1 at S = 36 (the short path)."""
    jb, pb = v_bundles
    rng = np.random.default_rng(11)
    x = rng.standard_normal(LATENT).astype(np.float32)
    t = np.array([999, 17], np.int32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    want = JM.unet_apply(jb.unet_cfg, jb.unet_params, x, t, ctx)
    got = M.unet_apply(pb.unet_cfg, pb.unet_params, *map(torch.from_numpy, (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("s,heads", [(144, 4), (576, 2)])
def test_k1_twin_matches_onepass_kernel_at_d64_ragged(s, heads):
    """SD 2.1's K1 shapes at head dim 64 with S = 144 and 576 (the 12^2 and
    24^2 levels of a 768^2 render), which JAX pads to its block itself:
    K1's plain twin against ``_onepass_kernel`` in interpret mode."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((1, s, heads * 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_attention(q, k, v, heads, use_pallas=True, interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


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
    _close(got, want)


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


@pytest.mark.parametrize("in_ch", [5, 9])
def test_concat_conditioned_unets_say_they_wait(in_ch):
    """A 5- or 9-channel UNet (depth2img, inpaint) loads, and the entry
    points refuse to render it, naming why."""
    ucfg, vcfg, ccfg = _sd2_tiny_configs()
    jcfg = dataclasses.replace(ucfg, in_channels=in_ch)
    key = jax.random.PRNGKey(0)
    pb = P.ModelBundle.from_jax_params(
        jcfg, JM.init_unet(key, jcfg, commit=False), vcfg,
        JM.init_vae(key, vcfg, commit=False), ccfg,
        JM.init_clip_text(key, ccfg, commit=False), device="cpu", version="sd2")
    assert pb.unet_cfg.in_channels == in_ch
    with pytest.raises(NotImplementedError, match=f"in_channels={in_ch}.*depth2img or inpaint"):
        P.txt2img(pb, "a cat", cfg=P.RenderConfig(steps=2, width=32, height=32))


# ---- the kernel sites a UNet call has (chip_smoke.py's launch predictions) ----

def test_unet_sites_reproduce_the_sd15_counts():
    """``tools/kernel_cases.unet_sites`` walks the plan: at SD 1.5's 64x64
    latent, 15 self-attention sites above 128 tokens, 61 GroupNorms, and on
    the 16^2 and 32^2 planes the 22 convs of ``B1_UNET_CONVS`` with their
    counts."""
    from collections import Counter

    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        B1_UNET_CONV_COUNTS,
        B1_UNET_CONVS,
        unet_sites,
    )

    sites = unet_sites(M.UNetConfig.sd15(), 64)
    assert sum(1 for side, *_ in sites["attn"] if side * side > 128) == 15
    assert sites["gn"] == 61
    gated = Counter(c for c in sites["conv"] if 256 <= c[0] ** 2 <= 1024)
    assert gated == dict(zip(B1_UNET_CONVS, B1_UNET_CONV_COUNTS))


@pytest.mark.parametrize("latent,k1,convs", [(96, 16, 11), (24, 10, 13)])
def test_unet_sites_of_sd21(latent, k1, convs):
    """SD 2.1 at 768x768 (96x96 latent): K1 at 16 sites a call (the middle
    block's 144 tokens too), every head 64 wide, 61 GroupNorms, 11 convs on
    the 24^2 plane that K4's gate admits at UNet batch 2; at a 24x24 latent
    10 K1 sites (576 and 144 tokens) and 13 gated convs."""
    from complex_prompt_diffusion_tpu_torch.models.layers import conv3x3_wanted
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import unet_sites

    sites = unet_sites(M.UNetConfig.sd21(), latent)
    assert sum(1 for side, *_ in sites["attn"] if side * side > 128) == k1
    assert {d for *_, d in sites["attn"]} == {64} and sites["gn"] == 61
    gated = [(s, c, co) for s, c, co in sites["conv"]
             if conv3x3_wanted(torch.empty((2, s, s, c), device="meta"), (co, c, 3, 3))]
    assert len(gated) == convs
