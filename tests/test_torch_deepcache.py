"""Port parity of DeepCache: the stateful sampler protocols (``eps_state``
of DDIM and PLMS, ``den_state`` of the eight k-samplers), the CFG forms
(``cfg_epsilon_deepcache``, ``make_denoiser_deepcache``), and renders of
every sampler of ``DEEPCACHE_SAMPLERS`` with ``deepcache_interval``
through the pipeline (eps and v bundles, txt2img and img2img), with the
RenderConfig refusals.

f32 on the CPU at 32x32, batch 2; x_T and the injected noises from numpy.
The tiny UNet's default split is output block 2 (its shallowest level's
first block).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.samplers import ddim as JDD
from complex_prompt_diffusion_tpu.samplers import kdiff as JK
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.models import unet as U
from complex_prompt_diffusion_tpu_torch.samplers import ddim as DD
from complex_prompt_diffusion_tpu_torch.samplers import kdiff as K

TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5  # f32 step math (as tests/test_torch_kdiff.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4  # a render (as tests/test_torch_sampler_slice.py)
PROMPT, NEGATIVE = "a red cube on a table", "blurry"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stateful_den(xp):
    """A stand-in stateful denoiser: the state counts evaluations and is
    refreshed on even steps, and the output depends on it."""
    def den(x, sigma, uc, i, st):
        if xp is jnp:
            st = jnp.where(i % 2 == 0, st + 1.0, st)
            return x / (1.0 + sigma**2) + 0.01 * uc * jnp.tanh(x) * st, st
        st = st + 1.0 if i % 2 == 0 else st
        return x / (1.0 + float(sigma) ** 2) + 0.01 * uc * torch.tanh(x) * st, st
    return den


K_SAMPLERS = ["sample_euler", "sample_euler_ancestral", "sample_heun", "sample_dpm2",
              "sample_dpm2_ancestral", "sample_dpmpp_2m", "sample_dpmpp_2s_ancestral",
              "sample_lms"]


@pytest.mark.parametrize("name", K_SAMPLERS)
def test_k_samplers_thread_den_state_like_jax(name):
    """Each k-sampler with ``den_state``: the same trajectory as the JAX
    scan's under the stateful protocol (multi-eval samplers evaluate twice
    with one step index)."""
    from complex_prompt_diffusion_tpu_torch.schedules import sigma as Sig

    sigmas = Sig.make_sigma_schedule("karras", 5, sigma_min=0.1, sigma_max=10.0)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, 2, 2, 4)) * 10).astype(np.float32)
    noises = rng.standard_normal((5, 1, 2, 2, 4)).astype(np.float32)
    want, _ = getattr(JK, name)(_stateful_den(jnp), jnp.asarray(x), sigmas, 7.5,
                                noises=jnp.asarray(noises), den_state=jnp.float32(0.0))
    got, traj = getattr(K, name)(_stateful_den(torch), torch.from_numpy(x), sigmas, 7.5,
                                 noises=torch.from_numpy(noises), den_state=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    assert traj.shape[0] == 5


def _stateful_eps(xp):
    def eps(x, t, uc, blur_on, i, st):
        if xp is jnp:
            st = jnp.where(i % 3 == 0, st + 1.0, st)
            tf = t.astype(jnp.float32) / 1000.0
        else:
            st = st + 1.0 if i % 3 == 0 else st
            tf = t.float() / 1000.0
        return 0.1 * x * tf + 0.01 * uc * st, st
    return eps


@pytest.mark.parametrize("name", ["sample_ddim", "sample_plms"])
def test_t_samplers_thread_eps_state_like_jax(name):
    it = S.make_inference_tables(S.make_diffusion_tables(), 6, eta=0.0)
    jit_ = JS.make_inference_tables(JS.make_diffusion_tables(), 6, eta=0.0)
    x = np.random.default_rng(1).standard_normal((1, 2, 2, 4)).astype(np.float32)
    ucs = np.full(it.num_steps, 7.5, np.float32)
    want, _ = getattr(JDD, name)(_stateful_eps(jnp), jnp.asarray(x), jit_, jnp.asarray(ucs),
                                 eps_state=jnp.float32(0.0))
    got, _ = getattr(DD, name)(_stateful_eps(torch), torch.from_numpy(x), it, ucs, eps_state=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


@pytest.fixture(scope="module")
def v_bundles(bundles):
    jb = dataclasses.replace(bundles[0], parameterization="v")
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _render(jb, pb, sampler, steps, **kw):
    """The render in both packages from one x_T (scaled by the first sigma
    for the sigma family, as their draws are) and one set of noises."""
    kw = dict(width=32, height=32, batch_size=1, steps=steps, sampler=sampler, **kw)
    rng = np.random.default_rng(7)
    x_T = rng.standard_normal((1, 4, 4, 4))
    if P.get_sampler(sampler)[0] == "sigma":
        x_T = x_T * P._sigma_schedule(pb, P.RenderConfig(**kw))[0]
    x_T = x_T.astype(np.float32)
    noises = rng.standard_normal((steps + 1, 1, 4, 4, 4)).astype(np.float32)
    _, want = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T),
                         noises=jnp.asarray(noises))
    _, got = P.txt2img(pb, PROMPT, NEGATIVE, cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T),
                       noises=torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    return got, x_T, noises


DC_SAMPLERS = ["DDIM", "PLMS", "Euler", "Euler Ancestral", "Heun", "Huen", "DPM2",
               "DPM2 Ancestral", "DPM++ 2m", "DPM++ 2s Ancestral", "LMS"]


@pytest.mark.parametrize("sampler", DC_SAMPLERS)
def test_deepcache_render_matches_jax(bundles, sampler):
    """Every sampler of DEEPCACHE_SAMPLERS at interval 2 (full, shallow,
    full): the JAX package's latents (DDIM's: not the exact render's)."""
    jb, pb = bundles
    got, x_T, noises = _render(jb, pb, sampler, 3, deepcache_interval=2)
    if sampler == "DDIM":
        _, exact = P.txt2img(pb, PROMPT, NEGATIVE, cfg=P.RenderConfig(
            width=32, height=32, steps=3, sampler=sampler), x_T=torch.from_numpy(x_T),
            noises=torch.from_numpy(noises), decode=False)
        assert not torch.equal(got, exact)
    assert {s.lower() for s in DC_SAMPLERS} == set(P.DEEPCACHE_SAMPLERS) == set(
        JP.DEEPCACHE_SAMPLERS)


@pytest.mark.parametrize("sampler,kw", [
    ("DDIM", dict(deepcache_interval=3, deepcache_block=1)),
    ("DPM++ 2m", dict(deepcache_interval=2, sigma_schedule="karras")),
])
def test_deepcache_v_model_and_split_match_jax(v_bundles, sampler, kw):
    """A v-model (converted at the eps level in the t family, at the
    denoised level in the sigma family) and another split."""
    _render(*v_bundles, sampler, 4, **kw)


def test_deepcache_callback_sees_every_evaluation(bundles):
    """The step callback wraps the stateful eps model: one call a step."""
    _, pb = bundles
    seen = []
    P.txt2img(pb, PROMPT, cfg=P.RenderConfig(width=32, height=32, steps=4,
                                             deepcache_interval=2),
              step_callback=lambda t, x0: seen.append(int(t)), decode=False)
    assert len(seen) == 4 and seen == sorted(seen, reverse=True)


def test_deepcache_img2img_matches_jax_chain(bundles):
    """DDIM img2img with DeepCache: the port's encode -> x_t -> first t_enc
    steps against the same chain from the JAX package's functions with the
    same injected noises."""
    jb, pb = bundles
    kw = dict(steps=5, width=32, height=32, denoising_strength=0.6, deepcache_interval=2)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    enc_noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    post = JM.vae_encode(jb.vae_cfg, jb.vae_params,
                         jnp.asarray(image, jnp.float32)[None] / 127.5 - 1.0)
    z0 = (post.mean + post.std * jnp.asarray(enc_noise)) * JP.LATENT_SCALE
    it = JS.make_inference_tables(jb.tables, 5)
    t_enc = JP.img2img_t_enc(0.6, it.num_steps, "t")
    a_t = float(it.alphas_cumprod_t[t_enc - 1])
    x_t = np.sqrt(a_t) * z0 + np.sqrt(1 - a_t) * jnp.asarray(noise)
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, "a cat", ""), jcfg, x_init=x_t,
                             t_start=t_enc)
    _, got = P.img2img(pb, image, "a cat", cfg=pcfg, encode_noise=torch.from_numpy(enc_noise),
                       noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)


def test_cfg_epsilon_deepcache_and_denoiser_match_jax(bundles):
    """The CFG forms on the tiny UNet's pair: a full then a shallow
    evaluation, and the sigma-space denoiser on a cache and a retrieval
    step (eps and v), each held to the JAX package's at the slice
    tolerance (the tiny UNet under CFG 7.5)."""
    jb, pb = bundles
    jfull, jshallow = JU.make_deepcache_unets(jb.unet_cfg, jb.unet_params, None)
    pfull, pshallow = U.make_deepcache_unets(pb.unet_cfg, pb.unet_params, None)
    jspec = JP.make_guidance_spec(jb, PROMPT, NEGATIVE)
    pspec = P.make_guidance_spec(pb, PROMPT, NEGATIVE)
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 4)).astype(np.float32)
    # the JAX form traces both branches: its state needs the feature's shape
    deep0 = jnp.zeros(pfull(*G._batched_inputs(torch.from_numpy(x), 500, pspec))[1].shape)
    w1, wd = JG.cfg_epsilon_deepcache(jfull, jshallow, jnp.asarray(x), jnp.asarray(500), jspec,
                                      jnp.float32(7.5), True, deep0)
    g1, gd = G.cfg_epsilon_deepcache(pfull, pshallow, torch.from_numpy(x), torch.tensor(500),
                                     pspec, 7.5, True, None)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    w2, _ = JG.cfg_epsilon_deepcache(jfull, jshallow, jnp.asarray(x * 0.5), jnp.asarray(480),
                                     jspec, jnp.float32(7.5), False, wd)
    g2, gd2 = G.cfg_epsilon_deepcache(pfull, pshallow, torch.from_numpy(x * 0.5),
                                      torch.tensor(480), pspec, 7.5, False, gd)
    assert gd2 is gd
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    for param in ("eps", "v"):
        jden = JG.make_denoiser_deepcache(jfull, jshallow, jspec, interval=2,
                                          model_sigmas=jnp.asarray(jb.tables.sigmas),
                                          parameterization=param)
        pden = G.make_denoiser_deepcache(pfull, pshallow, pspec, interval=2,
                                         model_sigmas=pb.tables.sigmas, parameterization=param)
        wd_, pd_ = deep0, None
        for i, sigma in enumerate((9.0, 4.0)):
            w, wd_ = jden(jnp.asarray(x) * sigma, jnp.float32(sigma), jnp.float32(7.5), i, wd_)
            g, pd_ = pden(torch.from_numpy(x) * sigma, sigma, 7.5, i, pd_)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SLICE_RTOL,
                                       atol=SLICE_ATOL)


def test_value_errors_match_jax(bundles):
    """RenderConfig's DeepCache refusals and make_denoiser_deepcache's
    missing sigma table raise ValueError in both packages."""
    for mod, gmod in ((JP, JG), (P, G)):
        for bad in (dict(sampler="DPM fast"), dict(sampler="UniPC"),
                    dict(sampler="DPM Adaptive"), dict(unet_tile=16),
                    dict(guidance=gmod.GuidanceConfig(attn_guide=True))):
            with pytest.raises(ValueError):
                mod.RenderConfig(deepcache_interval=2, **bad)
    for mod, spec in ((JG, None), (G, None)):
        with pytest.raises(ValueError, match="model_sigmas"):
            mod.make_denoiser_deepcache(lambda *a: None, lambda *a: None, spec, interval=2)
    _, pb = bundles
    with pytest.raises(ValueError, match="out of range"):
        P.txt2img(pb, PROMPT, cfg=P.RenderConfig(width=32, height=32, steps=2,
                                                 deepcache_interval=2, deepcache_block=4))
    # interval 0 and 1 are the exact render
    for interval in (0, 1):
        P.RenderConfig(deepcache_interval=interval, sampler="UniPC")


def test_shallow_pass_kernel_sites():
    """``tools/kernel_cases.unet_sites(deep_at=)``, the sites chip_smoke's
    launch predictions read, walks what the shallow pass runs: at SD-1.5's
    default split (9) the three level-0 input blocks and output blocks 9-11
    at 64x64: 5 self-attention sites, 16 GroupNorms, 12 convs (none in K4's
    gate at this plane; 15 with the up path fused, its three in_convs split);
    the full walk is unchanged."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        unet_batch_shapes,
        unet_sites,
    )

    cfg = M.UNetConfig.sd15()
    assert U.deepcache_default_block(cfg) == 9
    full, shallow = unet_sites(cfg, 64), unet_sites(cfg, 64, deep_at=9)
    assert len(full["self_attn"]) == 16 and full["gn"] == 61
    assert shallow["self_attn"] == [(4096, 4096, 8, 40)] * 5
    assert shallow["gn"] == 16 and len(shallow["conv"]) == 12
    assert {side for side, *_ in shallow["conv"]} == {64}
    assert unet_batch_shapes(cfg, 64, 8, deep_at=9) == {
        "attn": [(4096, 8, 40)], "attn_kv": [], "ff": [(32768, 320)],
        "gn": [(8, 64, 64, 320), (8, 64, 64, 960), (8, 64, 64, 640)], "gn_cat": [], "conv": []}
    assert len(unet_sites(cfg, 64, deep_at=0)["self_attn"]) == 15
    # the fused up path of the shallow pass: output blocks 9-11 pop the
    # level-0 skips (320 channels) beside hidden states of 640, 320, 320
    fused = unet_sites(cfg, 64, deep_at=9, fused=True)
    assert fused["gn_cat"] == [(64, 640, 320), (64, 320, 320), (64, 320, 320)]
    assert fused["gn"] == 16 and len(fused["conv"]) == 15
