"""Port parity of the standalone CLIP-guided txt2img
(``pipeline_clip_guided.py``): the "linear" resize, the cutout plan and
cutouts, and 3-step renders of the tiny bundle at 64x64 with and without
cutouts, against the JAX package with its own x_T injected; the pooled
fallback's width check.

f32 on the CPU; weights from the JAX package's init through
``convert.py``, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import pipeline_clip_guided as JPC
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import pipeline_clip_guided as PC
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

RENDER_TOL = 1e-4  # max |port - jax| / max |jax| of the latents
PROMPT = "a red cube on a table"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", [((2, 16, 12, 3), (2, 8, 8, 3)), ((1, 5, 7, 3), (1, 9, 9, 3))])
def test_linear_resize_equals_jax(src, dst):
    """"linear" is JAX's alias of "bilinear": antialiased on a downscale."""
    x = np.random.default_rng(sum(src)).random(src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), dst, method="linear")
    got = resize(torch.from_numpy(x), dst, "linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, resize(torch.from_numpy(x), dst, "bilinear"), rtol=0, atol=0)


def test_cutout_plan_and_cutouts_match_jax():
    """The same plan from the same seed; the cutouts within 1e-6."""
    for side, cut, n, power in ((40, 32, 6, 1.0), (16, 8, 4, 2.0), (8, 32, 3, 1.0)):
        want = JPC.make_cutout_plan(np.random.default_rng(side), side, cut, n, power)
        got = PC.make_cutout_plan(np.random.default_rng(side), side, cut, n, power)
        assert got == want
    images = np.random.default_rng(2).random((2, 40, 40, 3)).astype(np.float32)
    plan = PC.make_cutout_plan(np.random.default_rng(40), 40, 32, 6)
    want = JPC.apply_cutouts(jnp.asarray(images), plan, 32)
    got = PC.apply_cutouts(torch.from_numpy(images), plan, 32)
    assert tuple(got.shape) == (12, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# a vision tower whose 8x8 input is smaller than the tiny VAE's 16x16
# decode of an 8x8 latent, so the cutouts' sizes and offsets vary
VISION = dataclasses.replace(JC.CLIPVisionConfig.tiny(), image_size=8, patch_size=4)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _vision(projection_dim: int):
    jcfg = dataclasses.replace(VISION, projection_dim=projection_dim)
    jp = JC.init_clip_vision(np.random.default_rng(7), jcfg, commit=False)
    return jcfg, jp, convert.config_from(M.CLIPVisionConfig, jcfg), convert.clip_vision_params(jp)


def _cfgs(seed=4):
    kw = dict(steps=3, width=64, height=64, seed=seed)
    return JP.RenderConfig(**kw), P.RenderConfig(**kw)


def _jax_x_T(cfg):
    """The start the JAX function draws inside: the first of three keys
    split from PRNGKey(seed)."""
    k_init = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[0]
    return np.array(jax.random.normal(k_init, (cfg.batch_size,) + cfg.latent_shape))


@pytest.mark.parametrize("use_cutouts", [True, False])
def test_clip_guided_txt2img_matches_jax(bundles, use_cutouts):
    """With 4 cutouts and a unit random text embedding of the vision
    width; without cutouts (a plain resize) and the pooled SD text
    embedding as the guide text (the vision projection widened to the text
    tower's 64). Latents within 1e-4, uint8 images within 1."""
    jb, pb = bundles
    jcfg_r, pcfg_r = _cfgs()
    if use_cutouts:
        jv, jvp, pv, pvp = _vision(32)
        text = np.random.default_rng(8).standard_normal(32).astype(np.float32)
        text /= np.linalg.norm(text)
        jkw, pkw = dict(text_embedding_clip=jnp.asarray(text)), dict(
            text_embedding_clip=torch.from_numpy(text))
    else:
        jv, jvp, pv, pvp = _vision(64)
        jkw, pkw = {}, {}
    want_img, want = JPC.clip_guided_txt2img(jb, jv, jvp, PROMPT, cfg=jcfg_r, num_cutouts=4,
                                             use_cutouts=use_cutouts, **jkw)
    got_img, got = PC.clip_guided_txt2img(pb, pv, pvp, PROMPT, cfg=pcfg_r, num_cutouts=4,
                                          use_cutouts=use_cutouts,
                                          x_T=torch.from_numpy(_jax_x_T(jcfg_r)), **pkw)
    assert tuple(got.shape) == (1, 8, 8, 4) and not got.requires_grad
    assert _rel(got.numpy(), want) <= RENDER_TOL
    assert got_img.dtype == np.uint8 and got_img.shape == np.asarray(want_img).shape
    assert np.abs(got_img.astype(int) - np.asarray(want_img).astype(int)).max() <= 1
    plain = P.sample_latents(pb, P.make_guidance_spec(pb, PROMPT), pcfg_r,
                             x_init=torch.from_numpy(_jax_x_T(jcfg_r)))
    assert float((got - plain).abs().max()) > 1e-3


def test_clip_guided_txt2img_width_mismatch_raises_in_both(bundles):
    """The pooled fallback has the text tower's width (64 on the tiny
    bundle): against a 32-wide vision embedding the JAX package fails in
    the loss (TypeError), the port before it draws anything
    (ValueError)."""
    jb, pb = bundles
    jcfg_r, pcfg_r = _cfgs()
    jv, jvp, pv, pvp = _vision(32)
    with pytest.raises(TypeError):
        JPC.clip_guided_txt2img(jb, jv, jvp, PROMPT, cfg=jcfg_r)
    with pytest.raises(ValueError, match="width 64"):
        PC.clip_guided_txt2img(pb, pv, pvp, PROMPT, cfg=pcfg_r)
