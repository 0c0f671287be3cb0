"""Port parity: bf16 GroupNorm and d = 512 attention, the VAE encoder, the
bf16 VAE decode, DDIM with ``t_start``, the batch-1 slice and img2img.

The JAX package is the reference. Its Pallas kernels run in interpret mode
(``_gn_stats_kernel`` + ``_gn_apply_kernel`` through ``_gn_chunked``, the
streaming ``_attn_kernel``); the tiny JAX bundle's weights reach the port
through ``convert.py``. Inputs and injected noises come from numpy seeds.
Everything runs on the CPU, where the port's kernel wrappers take their
plain twins. Each tolerance is stated where it is used.
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
from complex_prompt_diffusion_tpu.ops import groupnorm as jax_gn
from complex_prompt_diffusion_tpu.ops.attention import attention as jax_attention
from complex_prompt_diffusion_tpu.samplers import ddim as JD
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.ops.attention import flash_attention
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_silu
from complex_prompt_diffusion_tpu_torch.samplers import ddim as D

# bf16 outputs of one f32 computation: where the f32 values straddle a
# rounding edge the two sides differ by one bf16 step (2^-8 relative)
BF16_RTOL, BF16_ATOL = 8e-3, 8e-3
# f32 whole-model outputs of O(1): sums run in another order, ~1e-5
F32_RTOL, F32_ATOL = 5e-5, 5e-5


def _bf16(a):
    """numpy f32 values rounded to bf16, as a bf16 torch tensor and a bf16
    jax array holding the same numbers."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = 2.0 * rng.standard_normal(shape) + 0.5
    return _bf16(x), _bf16(1.0 + 0.5 * rng.standard_normal(c)), _bf16(0.5 * rng.standard_normal(c))


def test_group_norm_bf16_matches_chunked_one_pass_kernels():
    """n = 2, HW = 512: ``_gn_chunked`` takes the streaming one-pass stats
    kernel (row 7 of the TPU kernel table) and the apply kernel."""
    (xt, xj), (gt, gj), (bt, bj) = _gn_inputs((2, 16, 32, 64), seed=4)
    want = jax_gn._gn_chunked(xj, gj, bj, num_groups=32, eps=1e-6, silu=True, interpret=True)
    got = group_norm_silu(xt, gt, bt, 32, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_bf16_matches_xla_mm(silu):
    """The UNet sites' bf16 GroupNorm: one-pass E[x^2] statistics in f32."""
    (xt, xj), (gt, gj), (bt, bj) = _gn_inputs((2, 8, 8, 320), seed=5)
    want = jax_gn._gn_xla_mm(xj, gj, bj, 32, 1e-5, silu)
    got = group_norm_plain(xt, gt, bt, 32, 1e-5, silu)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL, atol=BF16_ATOL)


def test_group_norm_statistics_rule_by_dtype():
    """bf16 inputs take one-pass statistics and f32 inputs two-pass: with a
    large common offset the two differ in f32, and each side matches the
    JAX form of its dtype."""
    rng = np.random.default_rng(6)
    x = (3000.0 + rng.standard_normal((1, 8, 8, 32))).astype(np.float32)
    ones, zeros = np.ones(32, np.float32), np.zeros(32, np.float32)
    mm = jax_gn._gn_xla_mm(x, ones, zeros, 32, 1e-6, False)
    two = jax_gn._gn_xla(x, ones, zeros, 32, 1e-6, False)
    assert float(jnp.abs(mm - two).max()) > 1e-3  # the forms really differ
    got_two = group_norm_plain(torch.from_numpy(x), torch.ones(32), torch.zeros(32), 32, 1e-6)
    np.testing.assert_allclose(got_two.numpy(), np.asarray(two), rtol=1e-4, atol=1e-3)
    (xt, xj), _, _ = _gn_inputs((1, 8, 8, 32), seed=7)
    xt, xj = xt + 64, xj + 64  # bf16 spacing 0.5 at 64: a coarse plane
    got_one = group_norm_plain(xt, torch.ones(32, dtype=torch.bfloat16),
                               torch.zeros(32, dtype=torch.bfloat16), 32, 1e-6)
    want_one = jax_gn._gn_xla_mm(xj, jnp.ones(32, jnp.bfloat16), jnp.zeros(32, jnp.bfloat16),
                                 32, 1e-6, False)
    np.testing.assert_allclose(_f32(got_one), _f32(want_one), rtol=BF16_RTOL, atol=BF16_ATOL)


def test_attention_bf16_d512_matches_streaming_kernel():
    """One head, d = 512 (the VAE mid-block) in bf16: the streaming
    ``_attn_kernel``. The Pallas kernel rounds the unnormalised
    probabilities to bf16 and divides after the PV product, the twin
    rounds the normalised ones: outputs differ by a few bf16 steps."""
    rng = np.random.default_rng(8)
    (qt, qj), (kt, kj), (vt, vj) = (_bf16(rng.standard_normal((1, 256, 512)))
                                    for _ in range(3))
    want = jax_attention(qj, kj, vj, 1, use_pallas=True, interpret=True)
    got = flash_attention(qt, kt, vt, 1)
    assert got.dtype == torch.bfloat16
    err = np.abs(_f32(got) - _f32(want)).max() / np.abs(_f32(want)).max()
    assert err <= 2e-2


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_params(
        jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params,
        jb.clip_cfg, jb.clip_params, device="cpu",
    )
    return jb, pb


def _image(seed, hw=32):
    return np.random.default_rng(seed).integers(0, 256, (1, hw, hw, 3), dtype=np.uint8)


def test_vae_encode_matches_jax(bundles):
    """32x32 image: the tiny encoder's mid-block attention runs at S = 256,
    so the port takes its K1 wrapper there; f32."""
    jb, pb = bundles
    x = _image(1).astype(np.float32) / 127.5 - 1.0
    want = JM.vae_encode(jb.vae_cfg, jb.vae_params, x)
    got = M.vae_encode(pb.vae_cfg, pb.vae_params, torch.from_numpy(x))
    assert got.mean.dtype == torch.float32 and tuple(got.mean.shape) == (1, 16, 16, 4)
    for g, w in ((got.mean, want.mean), (got.logvar, want.logvar), (got.mode(), want.mode())):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_RTOL, atol=F32_ATOL)
    z_port = P.encode_image(pb, _image(1))
    np.testing.assert_allclose(z_port.numpy(), np.asarray(JP.encode_image(jb, _image(1))),
                               rtol=F32_RTOL, atol=F32_ATOL)


def test_posterior_clamps_logvar_and_samples_with_injected_noise():
    moments = torch.tensor([[[[0.5, 1.0, -40.0, 25.0]]]])
    post = M.DiagonalGaussian.from_moments(moments)
    assert post.logvar.tolist() == [[[[-30.0, 20.0]]]]
    noise = torch.tensor([[[[2.0, -1.0]]]])
    torch.testing.assert_close(post.sample(noise=noise), post.mean + post.std * noise)


def test_vae_decode_bf16_matches_jax(bundles):
    """``cast_vae("bfloat16")`` on both sides, 12x12 latent (the 24^2 plane
    of the tiny decoder is inside the conv gate, so the port takes the K4
    twin there). Activations round to bf16 after every layer, at other
    points in the two frameworks, so the images agree in relative L2 to
    about the bf16 step (2^-8), not elementwise."""
    jb, pb = bundles
    jb16, pb16 = jb.cast_vae("bfloat16"), pb.cast_vae("bfloat16")
    assert pb16.vae_cfg.dtype == "bfloat16"
    assert all(a.dtype == torch.bfloat16 for a in
               _leaves(pb16.vae_params))
    z = np.random.default_rng(9).standard_normal((1, 12, 12, 4)).astype(np.float32)
    want = _f32(JM.vae_decode(jb16.vae_cfg, jb16.vae_params, z))
    got = M.vae_decode(pb16.vae_cfg, pb16.vae_params, torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) <= 2e-2


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def _toy_eps(xp):
    def eps(x, t, ctx):
        c = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
        t = t.astype(jnp.float32) if xp is jnp else t.float()
        return x * c[:, None, None, None] + 1e-3 * t[:, None, None, None]
    return eps


@pytest.mark.parametrize("t_start", [1, 3, 5])
def test_sample_ddim_t_start_matches_jax(t_start):
    rng = np.random.default_rng(10)
    itab = S.make_inference_tables(S.make_diffusion_tables(), 5, eta=0.6)
    jtab = JS.make_inference_tables(JS.make_diffusion_tables(), 5, eta=0.6)
    uncond = rng.standard_normal((5, 8)).astype(np.float32)
    factors = rng.standard_normal((1, 5, 8)).astype(np.float32)
    scales, masks = np.ones(1, np.float32), np.ones((1, 4, 4, 1), np.float32)
    jspec = JG.GuidanceSpec(*map(jnp.asarray, (uncond, factors, scales, masks)))
    pspec = G.GuidanceSpec(*map(torch.from_numpy, (uncond, factors, scales, masks)))
    noises = rng.standard_normal((t_start, 2, 4, 4, 4)).astype(np.float32)
    x_T = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    uc = G.make_uc_scale_schedule(G.GuidanceConfig(), itab.num_steps)
    w_x0, w_traj = JD.sample_ddim(
        lambda a, t, s, blur: JG.cfg_epsilon(_toy_eps(jnp), a, t, jspec, s),
        jnp.asarray(x_T), jtab, uc, noises=noises, t_start=t_start,
    )
    g_x0, g_traj = D.sample_ddim(
        lambda a, t, s, blur=None: G.cfg_epsilon(_toy_eps(torch), a, t, pspec, s),
        torch.from_numpy(x_T), itab, uc, noises=noises, t_start=t_start,
    )
    assert g_traj.shape[0] == t_start
    np.testing.assert_allclose(g_x0.numpy(), np.asarray(w_x0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_traj.numpy(), np.asarray(w_traj), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        D.sample_ddim(lambda a, t, s, blur=None: a, torch.from_numpy(x_T), itab, uc, t_start=6)


def test_img2img_t_enc_matches_jax():
    for strength in (0.0, 0.3, 0.75, 0.999, 1.0):
        for steps in (1, 10, 50):
            for family in ("t", "k"):
                assert (P.img2img_t_enc(strength, steps, family)
                        == JP.img2img_t_enc(strength, steps, family))
    assert P.img2img_t_enc(0.75, 50, "t") == 37


def test_batch1_slice_bf16_unet_and_vae_matches_jax(bundles):
    """The batch-1 render of the tiny model as the chip runs it at full
    size: bf16 UNet (``cast``), bf16 VAE (``cast_vae``), CFG 7.5, 4 DDIM
    steps, 32x32 latents-to-image, the same tokens and x_T. bf16 rounding
    at other points through 4 UNet calls (amplified by CFG 7.5) and the
    decode: latents agree to 3e-2 in relative L2 (1.7e-2 measured), the
    uint8 images to 3e-2 (6e-3 measured)."""
    jb, pb = bundles
    jb = jb.cast("bfloat16").cast_vae("bfloat16")
    pb = pb.cast("bfloat16").cast_vae("bfloat16")
    x_T = np.random.default_rng(11).standard_normal((1, 4, 4, 4)).astype(np.float32)
    kw = dict(steps=4, width=32, height=32, batch_size=1, guidance_scale=7.5)
    w_img, w_lat = JP.txt2img(jb, "a red cube", cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T))
    g_img, g_lat = P.txt2img(pb, "a red cube", cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T))
    assert g_lat.dtype == torch.float32 and tuple(g_lat.shape) == (1, 4, 4, 4)
    w_lat = np.asarray(w_lat, np.float32)
    assert np.linalg.norm(g_lat.numpy() - w_lat) / np.linalg.norm(w_lat) <= 3e-2
    assert g_img.dtype == np.uint8 and g_img.shape == w_img.shape == (1, 8, 8, 3)
    d = g_img.astype(np.float64) - np.asarray(w_img, np.float64)
    assert np.linalg.norm(d) / np.linalg.norm(np.asarray(w_img, np.float64)) <= 3e-2


def test_img2img_chain_matches_jax(bundles):
    """img2img at strength 0.75 over 8 DDIM steps (t_enc = 6), eta 0.3, f32:
    the posterior sample, the forward noise and the per-step noises are
    injected on the port side and rebuilt from the same numbers on the JAX
    side (its encoder posterior, then ``sample_latents`` with ``x_init``,
    ``t_start`` and ``noises``)."""
    jb, pb = bundles
    cfg_kw = dict(steps=8, width=32, height=32, batch_size=1, guidance_scale=7.5, eta=0.3,
                  denoising_strength=0.75)
    image = _image(12)
    rng = np.random.default_rng(13)
    enc_noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    t_enc = JP.img2img_t_enc(0.75, 8, "t")
    assert t_enc == 6
    noises = rng.standard_normal((t_enc, 1, 16, 16, 4)).astype(np.float32)

    jcfg = JP.RenderConfig(**cfg_kw)
    post = JM.vae_encode(jb.vae_cfg, jb.vae_params, image.astype(np.float32) / 127.5 - 1.0)
    z0 = (post.mean + post.std * enc_noise) * JP.LATENT_SCALE
    itab = JS.make_inference_tables(jb.tables, 8, eta=0.3)
    a_t = float(itab.alphas_cumprod_t[t_enc - 1])
    x_t = np.sqrt(a_t) * z0 + np.sqrt(1 - a_t) * noise
    spec = JP.make_guidance_spec(jb, "a blue sphere")
    w_lat = JP.sample_latents(jb, spec, jcfg, x_init=x_t, noises=noises, t_start=t_enc)
    w_img = JP.decode_latents(jb, w_lat)

    g_img, g_lat = P.img2img(pb, image, "a blue sphere", cfg=P.RenderConfig(**cfg_kw),
                             encode_noise=enc_noise, noise=noise, noises=noises)
    assert tuple(g_lat.shape) == (1, 16, 16, 4)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), rtol=1e-4, atol=1e-4)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1


def test_img2img_draws_from_generator_and_raises_for_k_samplers(bundles):
    _, pb = bundles
    cfg = P.RenderConfig(steps=4, width=32, height=32, denoising_strength=0.5)
    runs = [P.img2img(pb, _image(14), "a cat", cfg=cfg, decode=False,
                      generator=torch.Generator().manual_seed(s))[1] for s in (0, 0, 1)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    # "Log" (ported; it raised NotImplementedError before) hands back
    # log-likelihoods [B], which are no latents to decode: the decode raises,
    # as the JAX package's does (an 8x8 image, a 4x4 latent, and one thread:
    # its dopri5 integration runs ~90 small UNet VJPs, which the test
    # workers' shared cores slow many times over)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(ValueError):
            P.img2img(pb, _image(14, hw=8), "a cat", cfg=dataclasses.replace(cfg, sampler="Log"))
    finally:
        torch.set_num_threads(n)


def test_entry_points_default_to_the_gpu():
    """With no device argument the bundle goes on the GPU; this machine has
    none, so the constructors raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ModelBundle.random("tiny")
    jb = JP.ModelBundle.random("tiny", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.ModelBundle.from_jax_params(jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params,
                                      jb.clip_cfg, jb.clip_params)
