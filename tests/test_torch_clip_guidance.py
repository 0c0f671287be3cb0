"""Port parity of CLIP gradient guidance (``guidance/clip_guidance.py``):
the spherical distance, the config, and the corrected eps of
``make_clip_guidance`` on the tiny bundle's VAE and a tiny vision tower,
with the eps inside the loss constant or re-run through the tiny UNet,
at ``grad_scale`` 0 (the raw gradient) and 1 (per-pixel inf-norm).

f32 on the CPU; weights from the JAX package's init through
``convert.py``, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.guidance import clip_guidance as JCG
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import clip_guidance as CG

TOL = 1e-4  # max |port - jax| / max |jax| of the corrected eps


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spherical_dist_loss_and_config_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    y = rng.standard_normal((1, 32)).astype(np.float32)
    want = JCG.spherical_dist_loss(jnp.asarray(x), jnp.asarray(y))
    got = CG.spherical_dist_loss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert dataclasses.asdict(CG.ClipGuidanceConfig()) == dataclasses.asdict(
        JCG.ClipGuidanceConfig())


@pytest.fixture(scope="module")
def setup():
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    vcfg = JC.CLIPVisionConfig.tiny()
    jvp = JC.init_clip_vision(np.random.default_rng(3), vcfg, commit=False)
    rng = np.random.default_rng(4)
    text = rng.standard_normal(vcfg.projection_dim).astype(np.float32)
    text /= np.linalg.norm(text)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    e_t = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    return dict(jb=jb, pb=pb, vcfg=vcfg, jvp=jvp, pcfg=convert.config_from(
        M.CLIPVisionConfig, vcfg), pvp=convert.clip_vision_params(jvp), text=text, x=x, e_t=e_t,
        ctx=ctx)


@pytest.mark.parametrize("grad_scale", [0.0, 1.0])
@pytest.mark.parametrize("through_unet", [False, True])
def test_make_clip_guidance_matches_jax(setup, through_unet, grad_scale):
    """The corrected eps at a_t = 0.42: with e_t a constant of the loss,
    and with the eps re-run through the tiny UNet (t 401, a random
    context) so that the gradient crosses the UNet, the VAE decode, the
    resize and the vision tower."""
    s = setup
    jb, pb = s["jb"], s["pb"]
    gkw = dict(grad_scale=grad_scale, loss_scale=2.0)
    a_t = np.float32(0.42)

    def jeps(x_):
        return JM.unet_apply(jb.unet_cfg, jb.unet_params, x_, jnp.full((2,), 401), s["ctx"])

    def peps(x_):
        return M.unet_apply(pb.unet_cfg, pb.unet_params, x_, torch.full((2,), 401),
                            torch.from_numpy(s["ctx"]))

    jguide = JCG.make_clip_guidance(
        lambda z: JM.vae_decode(jb.vae_cfg, jb.vae_params, z), s["vcfg"], s["jvp"], s["text"],
        JCG.ClipGuidanceConfig(**gkw), eps_in_grad_fn=jeps if through_unet else None)
    want = jax.jit(jguide)(s["x"], s["e_t"], a_t)
    pguide = CG.make_clip_guidance(
        lambda z: M.vae_decode(pb.vae_cfg, pb.vae_params, z), s["pcfg"], s["pvp"],
        torch.from_numpy(s["text"]), CG.ClipGuidanceConfig(**gkw),
        eps_in_grad_fn=peps if through_unet else None)
    with torch.inference_mode():  # the guide leaves inference mode itself
        got = pguide(torch.from_numpy(s["x"]), torch.from_numpy(s["e_t"]), a_t)
    assert not got.requires_grad
    assert _rel(got.numpy() - s["e_t"], np.asarray(want) - s["e_t"]) <= TOL
    assert _rel(got.numpy(), want) <= TOL
    # no weight took a gradient
    assert all(p.grad is None for p in jax.tree_util.tree_leaves(pb.unet_params))


# ---------------------------------------------------------------------------
# sample_latents(clip_guidance=): 3-step renders of the tiny bundle at a
# 4x4 latent (32x32 pixels), x_T from a numpy seed in both packages
# ---------------------------------------------------------------------------

RENDER_TOL = 1e-4  # max |port - jax| / max |jax| of the latents
PROMPT = "a red cube on a table"


def _render_cfgs(mod, sampler="DDIM", steps=3, **guide):
    return mod.RenderConfig(steps=steps, sampler=sampler, width=32, height=32, seed=5,
                            guidance=mod.GuidanceConfig(**guide) if guide else
                            mod.GuidanceConfig())


def _guide(s, pkg, **kw):
    cg = (JCG if pkg == "jax" else CG).ClipGuidanceConfig(grad_scale=1.0, **kw)
    if pkg == "jax":
        return (s["vcfg"], s["jvp"], s["text"], cg)
    return (s["pcfg"], s["pvp"], torch.from_numpy(s["text"]), cg)


def _specs(s, two_factors: bool):
    """The one-prompt spec of both packages, or a masked 2-factor spec (an
    AND factor at 1.5 on the left half, a NOT factor at -0.5 on the top
    row) from numpy embeddings."""
    if not two_factors:
        return JP.make_guidance_spec(s["jb"], PROMPT), P.make_guidance_spec(s["pb"], PROMPT)
    rng = np.random.default_rng(9)
    uncond = rng.standard_normal((77, 64)).astype(np.float32)
    factors = rng.standard_normal((2, 77, 64)).astype(np.float32)
    scales = np.array([1.5, -0.5], np.float32)
    masks = np.zeros((2, 4, 4, 1), np.float32)
    masks[0, :, :2] = 1.0
    masks[1, :1] = 1.0
    arrs = (uncond, factors, scales, masks)
    return (JP.GuidanceSpec(*map(jnp.asarray, arrs)),
            P.GuidanceSpec(*map(torch.from_numpy, arrs)))


def _render(s, pkg, cfg, spec, clip_guidance):
    x_T = np.random.default_rng(6).standard_normal((1, 4, 4, 4)).astype(np.float32)
    if pkg == "jax":
        return np.asarray(JP.sample_latents(s["jb"], spec, cfg, x_init=jnp.asarray(x_T),
                                            clip_guidance=clip_guidance))
    return P.sample_latents(s["pb"], spec, cfg, x_init=torch.from_numpy(x_T),
                            clip_guidance=clip_guidance).numpy()


@pytest.mark.parametrize("sampler,two_factors,attn_guide", [
    ("DDIM", False, False), ("PLMS", False, False), ("DDIM", True, True),
])
def test_sample_latents_clip_guided_matches_jax(setup, sampler, two_factors, attn_guide):
    """Guided DDIM and PLMS; a masked 2-factor spec at factor_limit 2 (the
    eps in the loss re-run on both factors, mask times scale) with
    attention guidance on its last 2 steps, then CLIP guidance. The guided
    latents differ from the unguided render of the same start."""
    s = setup
    guide = dict(attn_guide=True, attn_guide_rounds=2, attn_guide_blur_k=3) if attn_guide else {}
    kw = dict(factor_limit=2) if two_factors else {}
    jspec, pspec = _specs(s, two_factors)
    want = _render(s, "jax", _render_cfgs(JP, sampler, **guide), jspec, _guide(s, "jax", **kw))
    got = _render(s, "port", _render_cfgs(P, sampler, **guide), pspec, _guide(s, "port", **kw))
    assert got.shape == (1, 4, 4, 4) and np.isfinite(got).all()
    assert _rel(got, want) <= RENDER_TOL
    plain = _render(s, "port", _render_cfgs(P, sampler, **guide), pspec, None)
    assert np.abs(got - plain).max() > 1e-3


def test_clip_guidance_freq_gate_and_families_match_jax(setup):
    """The JAX package's behaviours, pinned in both packages: the freq gate
    reads the integer timestep, and uniform DDIM timesteps 1 + k c are odd
    wherever the stride c = 1000 // steps is even (4 steps: 1, 251, 501,
    751; also 20, 25 and 50 steps), so freq 2 renders the unguided image
    there; the sigma family (Euler Ancestral, DPM++ 2M) ignores
    clip_guidance without an error."""
    s = setup
    jspec, pspec = _specs(s, False)
    timesteps = np.asarray(S.make_inference_tables(S.make_diffusion_tables(), 4).timesteps)
    assert (timesteps % 2 == 1).all()
    for sampler, freq in (("DDIM", 2), ("Euler Ancestral", 1), ("DPM++ 2M", 1)):
        for pkg, mod, spec in (("jax", JP, jspec), ("port", P, pspec)):
            cfg = _render_cfgs(mod, sampler, steps=4 if freq == 2 else 3)
            guided = _render(s, pkg, cfg, spec, _guide(s, pkg, freq=freq))
            np.testing.assert_array_equal(guided, _render(s, pkg, cfg, spec, None))


def test_clip_guidance_refuses_deepcache_in_both(setup):
    s = setup
    jspec, pspec = _specs(s, False)
    for pkg, mod, spec in (("jax", JP, jspec), ("port", P, pspec)):
        cfg = dataclasses.replace(_render_cfgs(mod), deepcache_interval=2)
        with pytest.raises(ValueError, match="CLIP guidance"):
            _render(s, pkg, cfg, spec, _guide(s, pkg))
