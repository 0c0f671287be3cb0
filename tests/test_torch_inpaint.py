"""Port parity of the concat channel and the inpaint model: ``depth_mask``
in ``cfg_epsilon`` and the sigma-space denoiser (eps and v models),
``ModelBundle.random("tiny-inpaint")``, ``pipeline.inpaint`` (DDIM and
Euler), the manager's 9-channel branch and its mask sense, the refusals,
``make_it_fit`` / ``zero_extend_input_conv`` and the zero-extended model's
indifference to its conditioning.

The JAX package draws from ``jax.random`` keys; the tests draw the same
numbers from the same keys and inject them into the port (x_T, the
posterior noise). The tiny JAX bundles' weights reach the port through
``from_jax_bundle``; f32 on the CPU.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.manager import DiffusionModelManager as JManager
from complex_prompt_diffusion_tpu.models import params as JPR
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.manager import DiffusionModelManager
from complex_prompt_diffusion_tpu_torch.models import params as PR

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_manager_render.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
# one guided UNet evaluation of the tiny UNet, f32
EVAL_RTOL, EVAL_ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny-inpaint", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _u8_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _image(seed, hw=16):
    return np.random.default_rng(seed).integers(0, 256, (hw, hw, 3), dtype=np.uint8)


def _mask(hw=16):
    m = np.zeros((hw, hw), np.float32)
    m[3:11, 5:13] = 0.8  # above the 0.5 threshold: the hole
    m[0:2, 0:2] = 0.4  # below it: kept
    return m


def test_tiny_inpaint_bundle_is_jaxs_config():
    """``random("tiny-inpaint")``: the tiny config at 9 input channels, the
    JAX package's preset; its conv_in takes 9 channels and no zero kernel
    is left (``_unzero_kernels``)."""
    jb = JP.ModelBundle.random("tiny-inpaint", seed=0)
    pb = P.ModelBundle.random("tiny-inpaint", seed=0, device="cpu")
    assert dataclasses.asdict(pb.unet_cfg) == dataclasses.asdict(
        convert.config_from(M.UNetConfig, jb.unet_cfg))
    assert pb.unet_cfg.in_channels == 9 and pb.unet_cfg.out_channels == 4
    assert tuple(pb.unet_params["input_blocks"][0][0]["weight"].shape[:2]) == (32, 9)
    assert P.ModelBundle.random("tiny", device="cpu").unet_cfg.in_channels == 4

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]

    assert all(bool(a.any()) for a in leaves(pb.unet_params) if a.ndim >= 2)


@pytest.mark.parametrize("in_ch", [9, 5])
def test_from_jax_bundle_carries_the_widened_conv_in(in_ch):
    """A 9-channel (inpaint) and a 5-channel (depth) tiny JAX bundle: the
    port's conv_in weight equals the JAX kernel, HWIO -> [Co, C, 3, 3]."""
    jb = JP.ModelBundle.random("tiny", seed=1)
    jcfg = dataclasses.replace(jb.unet_cfg, in_channels=in_ch)
    jb = dataclasses.replace(jb, unet_cfg=jcfg,
                             unet_params=JM.init_unet(jax.random.PRNGKey(2), jcfg))
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    assert pb.unet_cfg.in_channels == in_ch
    want = np.asarray(jb.unet_params["input_blocks"][0][0]["kernel"]).transpose(3, 2, 0, 1)
    got = pb.unet_params["input_blocks"][0][0]["weight"].numpy()
    np.testing.assert_array_equal(got, want)


# ---- the concat channel in guidance ----

def _toy_unet(xp):
    """A UNet stand-in whose output reads every input channel: 4 output
    channels from the 9 inputs by a fixed mix, times the context's mean and
    a function of t."""
    w = np.random.default_rng(3).standard_normal((9, 4)).astype(np.float32) * 0.3

    def unet(x, t, ctx):
        mix = x @ (xp.asarray(w) if xp is jnp else torch.from_numpy(w))
        scale = ctx.mean(axis=(1, 2)) if xp is jnp else ctx.mean(dim=(1, 2))
        tt = (t.astype(jnp.float32) if xp is jnp else t.float()) / 1000.0
        return mix * (1.0 + scale.reshape(-1, 1, 1, 1)) + tt.reshape(-1, 1, 1, 1)

    return unet


def _specs(k=2):
    rng = np.random.default_rng(4)
    uncond = rng.standard_normal((7, 8)).astype(np.float32)
    factors = rng.standard_normal((k, 7, 8)).astype(np.float32)
    scales = np.array([1.0, -0.5][:k], np.float32)
    masks = rng.random((k, 4, 4, 1)).astype(np.float32)
    js = JG.GuidanceSpec(*(jnp.asarray(a) for a in (uncond, factors, scales, masks)))
    ps = G.GuidanceSpec(*(torch.from_numpy(a) for a in (uncond, factors, scales, masks)))
    return js, ps


@pytest.mark.parametrize("mask_shape", [(4, 4, 5), (1, 4, 4, 5), (3, 4, 4, 5)])
def test_cfg_epsilon_concats_before_the_factor_tiling(mask_shape):
    """The conditioning is concatenated to x (broadcast over the batch)
    before the (1 + K) tiling: the same guided eps as JAX's; the tiled
    input has 9 channels."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    dm = rng.standard_normal(mask_shape).astype(np.float32)
    js, ps = _specs()
    seen = []

    def recording(x_in, t_in, ctx):
        seen.append(x_in.shape)
        return _toy_unet(torch)(x_in, t_in, ctx)

    want = JG.cfg_epsilon(_toy_unet(jnp), jnp.asarray(x), jnp.asarray(401), js, 7.5,
                          depth_mask=jnp.asarray(dm))
    got = G.cfg_epsilon(recording, torch.from_numpy(x), 401, ps, 7.5,
                        depth_mask=torch.from_numpy(dm))
    assert seen == [torch.Size((9, 4, 4, 9))]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_sigma_denoiser_scales_only_the_latents(parameterization):
    """Sigma space: x is scaled by c_in, the conditioning is not; the
    v-model's c_skip term takes the 4 latent channels. The same denoised
    as JAX's ``denoised_fn`` at three sigmas."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32) * 3.0
    dm = rng.standard_normal((1, 4, 4, 5)).astype(np.float32)
    js, ps = _specs()
    tables = P.S.make_diffusion_tables()
    _, jden = JG.make_denoiser(_toy_unet(jnp), js, model_sigmas=jnp.asarray(tables.sigmas),
                               parameterization=parameterization, depth_mask=jnp.asarray(dm))
    _, pden = G.make_denoiser(_toy_unet(torch), ps, model_sigmas=tables.sigmas,
                              parameterization=parameterization,
                              depth_mask=torch.from_numpy(dm))
    for sigma in (14.6, 1.3, 0.05):
        want = jden(jnp.asarray(x), np.float32(sigma), 5.0)
        got = pden(torch.from_numpy(x), sigma, 5.0)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- inpaint ----

def _jax_inpaint_draws(seed, z_shape, x_shape, sigma0=None):
    """The posterior noise and x_T JAX's inpaint draws from its seed."""
    k_enc, k_samp = jax.random.split(jax.random.PRNGKey(seed))
    enc = np.array(jax.random.normal(k_enc, z_shape, jnp.float32))
    key_init, _ = jax.random.split(k_samp)
    x_T = np.array(jax.random.normal(key_init, x_shape, jnp.float32))
    return enc, x_T * (sigma0 if sigma0 is not None else 1.0)


@pytest.mark.parametrize("sampler,extra", [("DDIM", {}), ("Euler", {"sigma_schedule": "karras"})])
def test_inpaint_equals_jax(bundles, sampler, extra):
    """``inpaint`` with a mask whose values straddle the 0.5 threshold, a
    16x16 image (the tiny VAE's 8x8 latent), DDIM and Euler (the sigma
    family's concat after c_in); JAX's posterior noise and x_T injected."""
    jb, pb = bundles
    kw = dict(steps=5, width=64, height=64, seed=8, sampler=sampler, **extra)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    image, mask = _image(9), _mask()
    want_img, want = JP.inpaint(jb, image, mask, "a red door", "blurry", jcfg)
    sigma0 = float(P._sigma_schedule(pb, pcfg)[0]) if sampler == "Euler" else None
    enc, x_T = _jax_inpaint_draws(8, (1, 8, 8, 4), (1, 8, 8, 4), sigma0)
    got_img, got = P.inpaint(pb, image, mask, "a red door", "blurry", pcfg,
                             encode_noise=torch.from_numpy(enc), x_T=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    _u8_close(got_img, want_img)


def test_inpaint_conditions_on_the_mask(bundles):
    """Two masks, one seed: different latents (the mask and the masked
    image reach the UNet); one mask twice: the same bits."""
    _, pb = bundles
    cfg = P.RenderConfig(steps=3, width=64, height=64, seed=2)
    image = _image(10)
    other = np.zeros((16, 16), np.float32)
    other[0:4, 0:4] = 1.0
    a = P.inpaint(pb, image, _mask(), "a cat", cfg=cfg, decode=False)[1]
    b = P.inpaint(pb, image, _mask(), "a cat", cfg=cfg, decode=False)[1]
    c = P.inpaint(pb, image, other, "a cat", cfg=cfg, decode=False)[1]
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_inpaint_refuses_a_plain_bundle_as_jax():
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    cfg_kw = dict(steps=2, width=64, height=64)
    for mod, b in ((P, pb), (JP, jb)):
        with pytest.raises(ValueError, match="not an inpaint model"):
            mod.inpaint(b, _image(1), _mask(), "a cat", cfg=mod.RenderConfig(**cfg_kw))


def test_concat_unet_refuses_a_missing_or_wrong_conditioning(bundles):
    """A 9-channel UNet without its conditioning, or with 4 channels of
    it, raises ValueError before any UNet call."""
    _, pb = bundles
    calls = []
    cfg = P.RenderConfig(steps=2, width=64, height=64)
    spec = P.make_guidance_spec(pb, "a cat")
    real = P.M.unet_apply
    try:
        P.M.unet_apply = lambda *a, **k: calls.append(1)
        with pytest.raises(ValueError, match="needs its conditioning"):
            P.sample_latents(pb, spec, cfg)
        with pytest.raises(ValueError, match="4 latent channels and 4 of depth_mask give 8"):
            P.sample_latents(pb, spec, cfg, depth_mask=torch.zeros((8, 8, 4)))
    finally:
        P.M.unet_apply = real
    assert not calls


# ---- the manager's inpaint-model branch ----

def test_manager_inpaint_model_branch_equals_jax(bundles):
    """A string prompt through the 9-channel branch: JAX's manager against
    the port's with JAX's draws injected."""
    jb, pb = bundles
    config = {"sampler": {"name": "DDIM"}, "prompt": "a window", "negative_prompt": "fog",
              "render": {"steps": 4, "W": 64, "H": 64, "seed": 11}}
    image, mask = _image(12), _mask()
    want = JManager(bundle=jb).process_img2img(image, config, mask=mask)
    enc, x_T = _jax_inpaint_draws(11, (1, 8, 8, 4), (1, 8, 8, 4))
    got = DiffusionModelManager(bundle=pb).process_img2img(
        image, config, mask=mask, encode_noise=enc, x_T=torch.from_numpy(x_T))
    _u8_close(got, want)


def test_manager_inpaint_model_composed_prompt_equals_jax(bundles):
    """A composed prompt goes through ``build_spec(H // 8, W // 8)`` and
    then the inpaint model (UNet batch 3 at b1)."""
    jb, pb = bundles
    prompt = {"class": "CompositionalPrompt", "prompt": "a castle",
              "conjunctions": [{"prompt": "a tower", "scale": 1.5, "mask": 0.7}]}
    config = {"sampler": {"name": "DDIM"}, "prompt_json": prompt,
              "render": {"steps": 3, "W": 64, "H": 64, "seed": 13}}
    image, mask = _image(14), _mask()
    want = JManager(bundle=jb).process_img2img(image, config, mask=mask)
    enc, x_T = _jax_inpaint_draws(13, (1, 8, 8, 4), (1, 8, 8, 4))
    seen = []
    real = P.M.unet_apply

    def counting(cfg, params, x, *a, **k):
        seen.append(tuple(x.shape))
        return real(cfg, params, x, *a, **k)

    P.M.unet_apply = counting
    try:
        got = DiffusionModelManager(bundle=pb).process_img2img(
            image, config, mask=mask, encode_noise=enc, x_T=torch.from_numpy(x_T))
    finally:
        P.M.unet_apply = real
    assert seen == [(3, 8, 8, 9)] * P.S.make_inference_tables(pb.tables, 3).num_steps
    _u8_close(got, want)


def test_manager_mask_senses_are_opposite():
    """The reference's quirk, kept: mask = 1 is the hole the 9-channel
    branch regenerates, and the region the RePaint branch keeps. With an
    all-ones mask the inpaint model's concat is a hole everywhere and the
    latents of an all-zero image; RePaint keeps the whole image, as JAX's
    manager does (its draws injected)."""
    jb9 = JP.ModelBundle.random("tiny-inpaint", seed=0)
    pb9 = P.ModelBundle.from_jax_bundle(jb9, device="cpu")
    image = _image(15)
    ones = np.ones((16, 16), np.float32)
    concat = []
    real = P.sample_latents

    def recording(*a, **k):
        concat.append(k["depth_mask"])
        return real(*a, **k)

    P.sample_latents = recording
    try:
        DiffusionModelManager(bundle=pb9).process_img2img(
            image, {"render": {"steps": 2, "W": 64, "H": 64}}, mask=ones,
            encode_noise=np.zeros((1, 8, 8, 4), np.float32))  # the posterior's mean
    finally:
        P.sample_latents = real
    (c,) = concat
    assert torch.equal(c[..., 0], torch.ones_like(c[..., 0]))  # the hole: everywhere
    zero_z = P.encode_image(pb9, np.zeros((16, 16, 3), np.float32))
    np.testing.assert_allclose(c[..., 1:].numpy(), zero_z.numpy(), rtol=1e-6, atol=1e-6)

    jb4 = JP.ModelBundle.random("tiny", seed=0)
    pb4 = P.ModelBundle.from_jax_bundle(jb4, device="cpu")
    config = {"render": {"steps": 4, "W": 64, "H": 64}, "jump_length": 2, "jump_n_sample": 1}
    want = JManager(bundle=jb4).process_img2img(image, config, mask=ones)
    # the x_T and per-transition noise JAX's sample_repaint draws from seed 0
    shape, n = (1, 8, 8, 4), len(JS.jump_timesteps(4, 1000, 2, 1))
    key, k0 = jax.random.split(jax.random.PRNGKey(0))
    x_T = np.array(jax.random.normal(k0, shape, jnp.float32))
    noises = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape,
                                                    jnp.float32)) for i in range(n)])
    kept = DiffusionModelManager(bundle=pb4).process_img2img(
        image, config, mask=ones, x_T=torch.from_numpy(x_T), noises=torch.from_numpy(noises))
    _u8_close(kept, want)


# ---- weight surgery ----

def _reference_fit(old, new_shape):
    """The reference's per-element loop (ddpm.py make_it_fit), its usage
    counter starting at 1."""
    new = np.zeros(new_shape, old.dtype)
    if old.ndim == 1:
        for i in range(new_shape[0]):
            new[i] = old[i % old.shape[0]]
        return new
    n_used_old = np.ones(old.shape[1])
    for j in range(new_shape[1]):
        n_used_old[j % old.shape[1]] += 1
    n_used_new = np.zeros(new_shape[1])
    for j in range(new_shape[1]):
        n_used_new[j] = n_used_old[j % old.shape[1]]
    for i in range(new_shape[0]):
        for j in range(new_shape[1]):
            new[i, j] = old[i % old.shape[0], j % old.shape[1]]
    shape = (1, -1) + (1,) * (old.ndim - 2)
    return (new / n_used_new.reshape(shape)).astype(old.dtype)


@pytest.mark.parametrize("old_shape,new_shape", [
    ((32, 4, 3, 3), (32, 9, 3, 3)), ((8, 3), (12, 7)), ((6,), (10,)), ((4, 4, 1, 1), (2, 9, 1, 1)),
    ((5, 5), (5, 5))])
def test_make_it_fit_bit_equal_to_jax(old_shape, new_shape):
    rng = np.random.default_rng(16)
    sd = {"w": rng.standard_normal(old_shape).astype(np.float32), "other": np.ones(3)}
    target = {"w": new_shape, "absent": (2, 2)}
    got = PR.make_it_fit(sd, target)
    want = JPR.make_it_fit(sd, target)
    assert got.keys() == want.keys() and "absent" not in got
    assert got["w"].dtype == want["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], want["w"])
    if old_shape == new_shape:  # left as it is
        assert got["w"] is sd["w"]
    else:
        np.testing.assert_array_equal(got["w"], _reference_fit(sd["w"], new_shape))
    assert got["other"] is sd["other"]


@pytest.mark.parametrize("sd,target", [({"w": np.zeros((2, 2))}, {"w": (2, 2, 2)}),
                                       ({"w": np.zeros((2, 2, 3, 3))}, {"w": (4, 2, 5, 5)})])
def test_make_it_fit_refuses_what_jax_refuses(sd, target):
    for fn in (PR.make_it_fit, JPR.make_it_fit):
        with pytest.raises(ValueError):
            fn(sd, target)


@pytest.mark.parametrize("new_in,keep", [(9, 4), (5, 4), (9, 2), (4, 4)])
def test_zero_extend_input_conv_bit_equal_to_jax(new_in, keep):
    """The UNet's conv_in and its EMA shadow (the EMA key kept) widened to
    ``new_in`` channels, the first ``keep`` kept, the rest zero; an input as
    wide as asked stays as it is."""
    rng = np.random.default_rng(17)
    w = rng.standard_normal((32, 4, 3, 3)).astype(np.float32)
    sd = {"model.diffusion_model.input_blocks.0.0.weight": w,
          "model_ema.diffusion_modelinput_blocks00weight": w * 0.5,
          "model.diffusion_model.out.2.bias": np.ones(4, np.float32)}
    got = PR.zero_extend_input_conv(sd, new_in, keep)
    want = JPR.zero_extend_input_conv(sd, new_in, keep)
    assert got.keys() == want.keys()
    for k in sd:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    k = "model.diffusion_model.input_blocks.0.0.weight"
    assert got[k].shape[1] == max(new_in, 4)
    np.testing.assert_array_equal(got[k][:, :keep], w[:, :keep])
    np.testing.assert_array_equal(got[k][:, keep:min(new_in, 4) if new_in > 4 else 4],
                                  0.0 if new_in > 4 else w[:, keep:])


def test_zero_extended_model_ignores_concat():
    """JAX's property, in the port: a 9-channel UNet seeded from a
    4-channel one by ``zero_extend_input_conv`` (all else shared) gives the
    base model's eps whatever the concat channels hold."""
    cfg4 = dataclasses.replace(JM.UNetConfig.tiny(), dtype="float32")
    cfg9 = dataclasses.replace(cfg4, in_channels=9)
    # the zero-initialized output layers filled (as ModelBundle.random), so
    # the output reads the input
    p4 = JP._unzero_kernels(jax.random.PRNGKey(1), JM.init_unet(jax.random.PRNGKey(0), cfg4))
    k4 = np.asarray(p4["input_blocks"][0][0]["kernel"])  # HWIO
    sd = {"model.diffusion_model.input_blocks.0.0.weight": k4.transpose(3, 2, 0, 1)}
    k9 = PR.zero_extend_input_conv(sd, 9)["model.diffusion_model.input_blocks.0.0.weight"]
    p9 = copy.deepcopy(p4)
    p9["input_blocks"][0][0] = dict(p4["input_blocks"][0][0],
                                    kernel=jnp.asarray(k9.transpose(2, 3, 1, 0)))
    pcfg4 = convert.config_from(M.UNetConfig, cfg4)
    pcfg9 = convert.config_from(M.UNetConfig, cfg9)
    q4 = convert.unet_params(p4, "cpu")
    q9 = convert.unet_params(p9, "cpu")
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 4)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 7, 32)).astype(np.float32))
    t = torch.tensor([7])
    base = M.unet_apply(pcfg4, q4, x, t, ctx)
    assert float(base.abs().max()) > 0.1
    for seed in (3, 4):
        extra = torch.from_numpy(
            np.random.default_rng(seed).standard_normal((1, 16, 16, 5)).astype(np.float32))
        wide = M.unet_apply(pcfg9, q9, torch.cat([x, extra], -1), t, ctx)
        np.testing.assert_allclose(wide.numpy(), base.numpy(), rtol=1e-5, atol=1e-5)
    want = JM.unet_apply(cfg4, p4, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
                         jnp.asarray(ctx.numpy()))
    np.testing.assert_allclose(base.numpy(), np.asarray(want), rtol=EVAL_RTOL, atol=EVAL_ATOL)


# ---- phase 1's UNet batch 3 cases (chip_smoke.py) ----

def test_ub3_group_holds_the_two_factor_inpaint_render(monkeypatch):
    """Phase 15's 2-factor inpaint render runs the 9-channel UNet at UNet
    batch 3: its K1-K4 shapes are SD-1.5's at that batch (conv_in, 9 -> 320
    on the 64^2 plane, lies outside K4's gate; the gate admits the other
    convs at batch <= 4), and the "ub3" group makes one case a shape at
    batch 3. Small stand-in shapes keep the tensors small; on the CPU each
    wrapper runs its plain twin."""
    from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

    shapes = KC.unet_batch_shapes(M.UNetConfig.sd_inpaint(), 64, 3)
    assert shapes == KC.unet_batch_shapes(M.UNetConfig.sd15(), 64, 3)
    # the materialized up path's convs; fused (the default), a subset of them
    assert sorted(KC.unet_batch_shapes(M.UNetConfig.sd_inpaint(), 64, 3, fused=False)["conv"]) == (
        sorted(KC.B1_UNET_CONVS))
    assert set(shapes["conv"]) < set(KC.B1_UNET_CONVS)
    assert {n for n, *_ in shapes["gn"]} == {3} and shapes["ff"][0] == (3 * 4096, 320)
    small = {"attn": [(256, 2, 8)], "ff": [(48, 16)], "gn": [(3, 8, 8, 64)],
             "conv": [(16, 64, 64), (16, 4, 64)]}
    monkeypatch.setattr(KC, "unet_batch_shapes", lambda cfg, latent, ub, **kw: small)
    cases = KC.kernel_cases("cpu", ["ub3"])
    assert [(c.kernel, c.label) for c in cases] == [
        ("attention_sm90", "bf16 B3 S256 H2 d8"), ("geglu_ff", "bf16 M48 C16 H4 64"),
        ("group_norm", "bf16 3x8x8x64 silu"), ("conv3x3_sm90", "bf16 B3 16x16 64->64"),
        ("conv3x3_narrow", "bf16 B3 16x16 4->64")]
    for case in cases:
        torch.testing.assert_close(case.run(), case.plain(), rtol=0, atol=0)
