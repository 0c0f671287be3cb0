"""Port parity of depth conditioning and the latent upscaler: the resize
helper against ``jax.image.resize`` (every mode, down- and up-scales),
``depth.py``'s conditioning half (the Sobel estimator, ``create_depth_mask``,
``build_depth_mask``, ``get_depth``, ``DepthManager``), ``depth2img`` (t and
sigma families), the concat channel through the solver, trig and blur
families, and ``upscale_latents`` on a tiny 7-channel UNet, with the raise
both packages share on the upscaler preset's class conditioning.

JAX's draws (posterior, forward and augmentation noise, x_T) are made here
from its keys and injected into the port; the tiny JAX bundles' weights
reach the port through ``from_jax_bundle``; f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import depth as JD
from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu_torch import depth as D
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_manager_render.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
# jax.image.resize's and F.interpolate's f32 weights: equal sums of
# differently rounded products (unit-scale data)
RESIZE_ATOL = 2e-5
# a [-1, 1] depth mask through that resize
MASK_ATOL = 2e-6


def _tiny_bundles(in_ch, num_classes=None, seed=0):
    jb = JP.ModelBundle.random("tiny", seed=seed)
    jcfg = dataclasses.replace(jb.unet_cfg, in_channels=in_ch, num_classes=num_classes)
    # the zero-initialized output layers filled, as ModelBundle.random fills
    # them, so the UNet's output reads its input
    params = JP._unzero_kernels(jax.random.PRNGKey(seed + 2),
                                JM.init_unet(jax.random.PRNGKey(seed + 1), jcfg))
    jb = dataclasses.replace(jb, unet_cfg=jcfg, unet_params=params)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


@pytest.fixture(scope="module")
def depth_bundles():
    return _tiny_bundles(5)


def _image(seed, hw=16):
    return np.random.default_rng(seed).integers(0, 256, (hw, hw, 3), dtype=np.uint8)


# ---- the resize helper ----

RESIZES = [((1, 64, 64, 3), (1, 8, 8, 3)), ((1, 64, 64, 3), (1, 96, 96, 3)),
           ((2, 24, 32, 5), (2, 8, 40, 5)), ((64, 48), (8, 6)), ((40, 30), (96, 100)),
           ((30, 30, 1), (7, 7, 1)), ((8, 8, 2), (8, 8, 2))]


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a}->{b}" for a, b in RESIZES])
def test_resize_equals_jax_image_resize(method, src, dst):
    """Down- and up-scales of [N, H, W, C], [H, W] and [H, W, C]: "nearest"
    bit-equal (a 0/1 mask), "bilinear" and "bicubic" within RESIZE_ATOL
    (jax.image.resize antialiases: ``antialias=True``)."""
    x = np.random.default_rng(sum(src)).standard_normal(src).astype(np.float32)
    if method == "nearest":
        x = (x > 0).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, method))
    got = resize(torch.from_numpy(x), dst, method).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_resize_refuses_other_axes_and_methods():
    x = torch.zeros((2, 8, 8, 3))
    for shape, method in (((1, 4, 4, 3), "bilinear"), ((2, 4, 4, 1), "nearest"),
                          ((2, 4, 4), "nearest"), ((2, 4, 4, 3), "lanczos3")):
        with pytest.raises(ValueError):
            resize(x, shape, method)


# ---- depth.py ----

@pytest.mark.parametrize("shape", [(48, 40, 3), (16, 16, 3), (9, 30, 3)])
def test_sobel_estimator_bit_equal_to_jax(shape):
    rng = np.random.default_rng(shape[0])
    for img in (rng.integers(0, 256, shape, dtype=np.uint8),
                rng.random(shape).astype(np.float32)):
        np.testing.assert_array_equal(D.SobelDepthEstimator().estimate(img),
                                      JD.SobelDepthEstimator().estimate(img))


@pytest.mark.parametrize("size", [(8, 6), (64, 64), (5, 9)])
def test_create_depth_mask_equals_jax(size):
    """Bicubic resize then [-1, 1], down and up."""
    d = JD.SobelDepthEstimator().estimate(_image(3, 40))
    got = D.create_depth_mask(d, size)
    want = np.asarray(JD.create_depth_mask(d, size))
    assert got.shape == size and got.min() == -1.0 and abs(got.max() - 1.0) < 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_ATOL)


def test_rescale_shave_build_and_get_depth_equal_jax():
    img = _image(4, 64)
    x = np.random.default_rng(5).random((6, 7)).astype(np.float32)
    np.testing.assert_array_equal(D.shave(x, 0.3), JD.shave(x, 0.3))
    np.testing.assert_array_equal(D.rescale(x), JD.rescale(x))
    for q, size in ((0.35, None), (0.1, (5, 6))):
        np.testing.assert_allclose(D.build_depth_mask(img, q=q, size=size),
                                   JD.build_depth_mask(img, q=q, size=size),
                                   rtol=0, atol=MASK_ATOL)

    class Flat:
        def estimate(self, img):
            return np.full(img.shape[:2], 0.25, np.float32)

    ests = (D.SobelDepthEstimator(), Flat())
    for w in (None, (0.7, 0.3)):
        np.testing.assert_array_equal(D.get_depth(img, ests, w),
                                      JD.get_depth(img, (JD.SobelDepthEstimator(), Flat()), w))


def test_depth_manager_equals_jax():
    """``get`` (the spatial mask) and ``conditioning_channel`` ([h, w, 1],
    f32, on the manager's device)."""
    img = _image(6, 48)
    for q, size in ((0.0, (6, 6)), (0.4, (12, 10))):
        pm = D.DepthManager(q=q, size=size, device="cpu")
        jm = JD.DepthManager(q=q, size=size)
        np.testing.assert_allclose(pm.get(img), jm.get(img), rtol=0, atol=MASK_ATOL)
        ch = pm.conditioning_channel(img)
        assert isinstance(ch, torch.Tensor) and ch.dtype == torch.float32
        assert ch.shape == size + (1,) and ch.device.type == "cpu"
        np.testing.assert_allclose(ch.numpy(), np.asarray(jm.conditioning_channel(img)),
                                   rtol=0, atol=MASK_ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.DepthManager()  # the GPU unless asked otherwise


# ---- depth2img ----

def _jax_img2img_draws(seed, z_shape):
    """The posterior and forward noise JAX's img2img draws from its seed."""
    k_enc, k_noise, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.array(jax.random.normal(k_enc, z_shape, jnp.float32)),
            np.array(jax.random.normal(k_noise, z_shape, jnp.float32)))


@pytest.mark.parametrize("sampler,extra", [("DDIM", {}), ("PLMS", {}),
                                           ("Euler", {"sigma_schedule": "karras"}),
                                           ("DPM++ 2m", {})])
def test_depth2img_equals_jax(depth_bundles, sampler, extra):
    """A 16x16 image (the tiny VAE's 8x8 latent, the depth map resized to
    it), strength 0.6, the Sobel estimator; JAX's draws injected."""
    jb, pb = depth_bundles
    kw = dict(steps=6, width=64, height=64, seed=7, sampler=sampler, denoising_strength=0.6,
              **extra)
    image = _image(8)
    want_img, want = JP.depth2img(jb, image, "a canyon", "haze", JP.RenderConfig(**kw))
    enc, noise = _jax_img2img_draws(7, (1, 8, 8, 4))
    seen = []
    real = P.M.unet_apply

    def counting(cfg, params, x, *a, **k):
        seen.append(x.shape[-1])
        return real(cfg, params, x, *a, **k)

    P.M.unet_apply = counting
    try:
        got_img, got = P.depth2img(pb, image, "a canyon", "haze", P.RenderConfig(**kw),
                                   encode_noise=enc, noise=noise)
    finally:
        P.M.unet_apply = real
    assert seen and set(seen) == {5}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    assert np.abs(got_img.astype(np.int16) - np.asarray(want_img).astype(np.int16)).max() <= 1


def test_depth2img_takes_the_estimator(depth_bundles):
    """Another estimator changes the result; the default is Sobel's."""
    _, pb = depth_bundles
    cfg = P.RenderConfig(steps=3, width=64, height=64, seed=1)
    image = _image(9)

    class Ramp:
        def estimate(self, img):
            return np.tile(np.linspace(0, 1, img.shape[1], dtype=np.float32), (img.shape[0], 1))

    a = P.depth2img(pb, image, "a cat", cfg=cfg, decode=False)[1]
    b = P.depth2img(pb, image, "a cat", cfg=cfg, estimator=D.SobelDepthEstimator(),
                    decode=False)[1]
    c = P.depth2img(pb, image, "a cat", cfg=cfg, estimator=Ramp(), decode=False)[1]
    assert torch.equal(a, b) and not torch.allclose(a, c)


@pytest.mark.parametrize("sampler,extra", [("DPM Solver", {}), ("UniPC", {}), ("iPNDM", {})])
def test_txt2img_depth_mask_through_every_family_equals_jax(depth_bundles, sampler, extra):
    """The concat reaches the UNet in the solver and trig families too:
    txt2img with a depth mask, JAX's x_T injected."""
    jb, pb = depth_bundles
    kw = dict(steps=4, width=64, height=64, seed=10, sampler=sampler, **extra)
    dm = np.random.default_rng(11).uniform(-1, 1, (8, 8, 1)).astype(np.float32)
    _, want = JP.txt2img(jb, "a hill", cfg=JP.RenderConfig(**kw), depth_mask=jnp.asarray(dm),
                         decode=False)
    key_init, _ = jax.random.split(jax.random.PRNGKey(10))
    x_T = np.array(jax.random.normal(key_init, (1, 8, 8, 4), jnp.float32))
    _, got = P.txt2img(pb, "a hill", cfg=P.RenderConfig(**kw), depth_mask=dm,
                       x_T=torch.from_numpy(x_T), decode=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)


def test_blur_family_takes_the_depth_mask(depth_bundles):
    """Blur (whose JAX sampler draws its own start) calls the UNet with
    the concat too; one seed, one result."""
    _, pb = depth_bundles
    cfg = P.RenderConfig(steps=3, width=64, height=64, seed=12, sampler="Blur")
    dm = torch.linspace(-1, 1, 64).reshape(8, 8, 1)
    seen = []
    real = P.M.unet_apply

    def counting(cfg_, params, x, *a, **k):
        seen.append(x.shape[-1])
        return real(cfg_, params, x, *a, **k)

    P.M.unet_apply = counting
    try:
        runs = [P.txt2img(pb, "a hill", cfg=cfg, depth_mask=dm, decode=False)[1]
                for _ in range(2)]
    finally:
        P.M.unet_apply = real
    assert set(seen) == {5} and torch.equal(*runs) and torch.isfinite(runs[0]).all()


# ---- upscale_latents ----

@pytest.mark.parametrize("hw,noise_level,sampler", [(24, 20, "DDIM"), (5, 350, "Euler")])
def test_upscale_latents_equals_jax(hw, noise_level, sampler):
    """A tiny 7-channel UNet without classes: the low-resolution uint8
    image mapped to [-1, 1], resized bilinearly to the 8x8 latent grid (down
    from 24, up from 5), noise-augmented at the level, concatenated; JAX's
    augmentation noise and x_T injected."""
    jb, pb = _tiny_bundles(7, seed=2)
    kw = dict(steps=4, width=64, height=64, seed=13, sampler=sampler)
    pcfg = P.RenderConfig(**kw)
    low = np.random.default_rng(hw).integers(0, 256, (hw, hw, 3), dtype=np.uint8)
    want_img, want = JP.upscale_latents(jb, low, "a harbour", JP.RenderConfig(**kw),
                                        noise_level=noise_level)
    k_aug, k_s = jax.random.split(jax.random.PRNGKey(13))
    aug = np.array(jax.random.normal(k_aug, (1, 8, 8, 3), jnp.float32))
    x_T = np.array(jax.random.normal(jax.random.split(k_s)[0], (1, 8, 8, 4), jnp.float32))
    if sampler == "Euler":
        x_T = x_T * float(P._sigma_schedule(pb, pcfg)[0])
    got_img, got = P.upscale_latents(pb, low, "a harbour", pcfg, noise_level=noise_level,
                                     aug_noise=aug, x_T=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    assert np.abs(got_img.astype(np.int16) - np.asarray(want_img).astype(np.int16)).max() <= 1


def test_upscaler_preset_raises_in_both_packages():
    """The reference's quirk, kept: the preset's noise level is a class
    label (``num_classes`` 1000) that the sampler never passes, so both
    packages' UNets raise the same ValueError on a class-conditional
    7-channel UNet (the tiny widths; the preset's own fields equal)."""
    assert dataclasses.asdict(M.UNetConfig.sd_upscaler()).items() <= {
        **dataclasses.asdict(JM.UNetConfig.sd_upscaler()), "attn_route": "bsc"}.items()
    assert M.UNetConfig.sd_upscaler().num_classes == 1000
    jb, pb = _tiny_bundles(7, num_classes=1000, seed=3)
    low = np.zeros((8, 8, 3), np.uint8)
    for mod, b in ((P, pb), (JP, jb)):
        with pytest.raises(ValueError, match="class-conditional model requires y"):
            mod.upscale_latents(b, low, "a cat", mod.RenderConfig(steps=2, width=64, height=64))


# ---- phase 1's SD-2 512^2 cases (chip_smoke.py) ----

def test_sd2_512_shapes_add_only_k1_at_head_dim_64():
    """The depth UNet at 512x512 (UNet batch 2 and 8): K1 at head dim 64
    over S = 4096, 1024, 256 (the 64 tokens of the middle block on the
    short path); its K2, K3 and K4 shapes are SD-1.5's, and its concat
    conv_in lies on the 64^2 plane, outside K4's gate."""
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import unet_batch_shapes

    for ub in (2, 8):
        sd2 = unet_batch_shapes(M.UNetConfig.sd2_depth(), 64, ub)
        sd15 = unet_batch_shapes(M.UNetConfig.sd15(), 64, ub)
        assert sd2["attn"] == [(4096, 5, 64), (1024, 10, 64), (256, 20, 64)]
        assert {k: sd2[k] for k in ("ff", "gn", "conv")} == {
            k: sd15[k] for k in ("ff", "gn", "conv")}
        assert all(c not in (5, 9) for _, c, _ in sd2["conv"])


def test_sd2_512_group_makes_each_new_case_once(monkeypatch):
    """The "sd2_512" group: one case a K1 shape at each UNet batch, K1 at
    64 tokens, and K4's narrow bodies at 9 -> 320 and 5 -> 320 on a 32^2
    plane in bf16 and f32; a shape another group already has is not
    repeated. Small stand-in shapes keep the tensors small; on the CPU each
    wrapper runs its plain twin."""
    from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

    small = {"attn": [(256, 2, 8)], "ff": [(64, 16)], "gn": [(4, 8, 8, 64)],
             "conv": [(16, 64, 64)]}
    monkeypatch.setattr(KC, "unet_batch_shapes", lambda cfg, latent, ub, **kw: small)
    cases = KC.kernel_cases("cpu", ["sd2_512"])
    labels = [(c.kernel, c.label) for c in cases]
    assert labels == [
        ("attention_sm90", "bf16 B2 S256 H2 d8"), ("attention_sm90", "bf16 B2 S64 H20 d64"),
        ("geglu_ff", "bf16 M64 C16 H4 64"), ("group_norm", "bf16 4x8x8x64 silu"),
        ("conv3x3_sm90", "bf16 B2 16x16 64->64"),
        ("attention_sm90", "bf16 B8 S256 H2 d8"), ("attention_sm90", "bf16 B8 S64 H20 d64"),
        ("conv3x3_sm90", "bf16 B8 16x16 64->64"),
        ("conv3x3_narrow", "bf16 B2 32x32 9->320"), ("conv3x3_narrow", "f32 B2 32x32 9->320"),
        ("conv3x3_narrow", "bf16 B2 32x32 5->320"), ("conv3x3_narrow", "f32 B2 32x32 5->320")]
    for case in cases:
        torch.testing.assert_close(case.run(), case.plain(), rtol=0, atol=0)
    assert cases[-1].library is not None and cases[-1].bound()[0] > 0


def test_depth2img_batch_equals_jaxs_single_image_runs(depth_bundles):
    """An [N, H, W, 3] batch (the JAX package's depth2img takes one image):
    each image on its own depth map, equal to JAX's run of that image with
    the same draws."""
    jb, pb = depth_bundles
    kw = dict(steps=5, width=64, height=64, sampler="DDIM", denoising_strength=0.7)
    images = np.stack([_image(20), _image(21)])
    wants, encs, noises = [], [], []
    for i, seed in enumerate((30, 31)):
        wants.append(np.asarray(JP.depth2img(jb, images[i], "a road", cfg=JP.RenderConfig(
            seed=seed, **kw), decode=False)[1]))
        enc, noise = _jax_img2img_draws(seed, (1, 8, 8, 4))
        encs.append(enc)
        noises.append(noise)
    _, got = P.depth2img(pb, images, "a road", cfg=P.RenderConfig(**kw), decode=False,
                         encode_noise=np.concatenate(encs), noise=np.concatenate(noises))
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.concatenate(wants), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)


# v2-midas-inference.yaml's model section (the Stable Diffusion 2
# repository's depth-model config), its comments dropped. The repository
# holds no copy of the file: the text is typed from the published config,
# and the UNet fields are the ones UNetConfig.sd2_depth has in both packages
V2_MIDAS_YAML = """\
model:
  base_learning_rate: 5.0e-07
  target: ldm.models.diffusion.ddpm.LatentDepth2ImageDiffusion
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    image_size: 64
    channels: 4
    cond_stage_trainable: false
    conditioning_key: hybrid
    scale_factor: 0.18215
    monitor: val/loss_simple_ema
    finetune_keys: null
    use_ema: False

    depth_stage_config:
      target: ldm.modules.midas.api.MiDaSInference
      params:
        model_type: "dpt_hybrid"

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        use_checkpoint: True
        image_size: 32
        in_channels: 5
        out_channels: 4
        model_channels: 320
        attention_resolutions: [ 4, 2, 1 ]
        num_res_blocks: 2
        channel_mult: [ 1, 2, 4, 4 ]
        num_head_channels: 64
        use_spatial_transformer: True
        use_linear_in_transformer: True
        transformer_depth: 1
        context_dim: 1024
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenOpenCLIPEmbedder
      params:
        freeze: True
        layer: "penultimate"
"""


def test_chip_smoke_literal_is_the_v2_midas_model_section():
    """Phase 15 builds the depth model from a Python literal of
    v2-midas-inference.yaml's ``model:`` section (the card has no PyYAML):
    the parsed text; its UNet is ``UNetConfig.sd2_depth`` in both packages'
    parsers, eps-parameterized (no ``parameterization`` key), with the
    OpenCLIP tower's penultimate layer."""
    import pathlib
    import sys

    import yaml

    from complex_prompt_diffusion_tpu import config as JCONF
    from complex_prompt_diffusion_tpu_torch import config as CONF

    root = str(pathlib.Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    lit = chip_smoke.V2_MIDAS_MODEL
    assert lit == yaml.safe_load(V2_MIDAS_YAML)["model"]
    unet = lit["params"]["unet_config"]["params"]
    assert CONF.unet_config_from_yaml(unet) == M.UNetConfig.sd2_depth()
    assert dataclasses.asdict(JCONF.unet_config_from_yaml(unet)).items() >= {
        k: v for k, v in dataclasses.asdict(M.UNetConfig.sd2_depth()).items()
        if k != "attn_route"}.items()
    assert "parameterization" not in lit["params"]
    assert CONF._COND_STAGE_MAP[lit["params"]["cond_stage_config"]["target"]] == (
        "sd21", "penultimate")
