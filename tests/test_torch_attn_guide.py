"""Port parity of attention-saliency guidance: the saliency mask, the
stand-alone guidance step (``guidance/attn_guidance.py``), the guided CFG
eps (``cfg_epsilon_attn_guided``) on the tiny UNet, and guided renders
through the pipeline (DDIM and PLMS, eps and v bundles; a sigma-family
sampler, which ignores the switch as the JAX package's does), with the
refusal of tiled inference.

f32 on the CPU; inputs, x_T and noises from numpy seeds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import attn_guidance as JA
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import attn_guidance as A
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G

OP_TOL = 1e-6
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4  # as tests/test_torch_sampler_slice.py
PROMPT, NEGATIVE = "a red cube on a table", "blurry"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,pct,out_hw,bi", [
    ((2, 8, 8, 16), 90.0, (16, 16), 0), ((3, 4, 6, 8), 50.0, (8, 12), 2),
    ((1, 16, 16, 4), 99.0, (16, 16), 0),
])
def test_saliency_mask_equals_jax(shape, pct, out_hw, bi):
    feat = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = JA.saliency_mask(jnp.asarray(feat), pct, out_hw, bi)
    got = A.saliency_mask(torch.from_numpy(feat), pct, out_hw, bi)
    assert tuple(got.shape) == (1,) + out_hw + (1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _toy_unets(xp):
    """Stand-ins of the skip and unconditional UNet calls, the same
    arithmetic in both packages."""
    def skips_fn(x, t):
        feat = xp.tanh(x[..., :2] * 3.0) if xp is jnp else torch.tanh(x[..., :2] * 3.0)
        return 0.5 * x, (x * 2.0, feat)

    def uncond_fn(x, t):
        return 0.3 * x + 0.1

    return skips_fn, uncond_fn


def test_make_attn_guidance_matches_jax():
    it = S.make_inference_tables(S.make_diffusion_tables(), 10)
    jit_ = JS.make_inference_tables(JS.make_diffusion_tables(), 10)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    e_cfg = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    acfg_kw = dict(scale=1.3, skip_idx=-1, mask_threshold=80.0, blur_k=7)
    want = JA.make_attn_guidance(*_toy_unets(jnp), jit_, JA.AttnGuidanceConfig(**acfg_kw))(
        jnp.asarray(x), jnp.asarray(401), 2, jnp.asarray(e_cfg))
    got = A.make_attn_guidance(*_toy_unets(torch), it, A.AttnGuidanceConfig(**acfg_kw))(
        torch.from_numpy(x), torch.tensor(401), 2, torch.from_numpy(e_cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


@pytest.mark.parametrize("skip_idx", [-1, 1])
def test_cfg_epsilon_attn_guided_matches_jax(bundles, skip_idx):
    """One guided eps on the tiny UNet at a 16x16 latent, batch 2: the mask
    from one quantile over the unconditional slice, the blur and renoise,
    the unconditional re-evaluation, the push."""
    jb, pb = bundles
    gkw = dict(attn_guide=True, attn_guide_skip_idx=skip_idx, attn_guide_blur_k=5,
               attn_guide_scale=1.5, dynamic_scale_clip=True)
    jspec = JP.make_guidance_spec(jb, PROMPT, NEGATIVE)
    pspec = P.make_guidance_spec(pb, PROMPT, NEGATIVE)
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 4)).astype(np.float32)
    a_t, s1m = np.float32(0.35), np.float32(np.sqrt(1 - 0.35))

    def junet(x_, t_, c_):
        return JP.M.unet_apply(jb.unet_cfg, jb.unet_params, x_, t_, c_)

    def junet_skips(x_, t_, c_):
        return JP.M.unet_apply(jb.unet_cfg, jb.unet_params, x_, t_, c_, return_skips=True)

    def punet(x_, t_, c_):
        return M.unet_apply(pb.unet_cfg, pb.unet_params, x_, t_, c_)

    def punet_skips(x_, t_, c_):
        return M.unet_apply(pb.unet_cfg, pb.unet_params, x_, t_, c_, return_skips=True)

    want = JG.cfg_epsilon_attn_guided(junet, junet_skips, jnp.asarray(x), jnp.asarray(301), jspec,
                                      jnp.float32(7.5), (jnp.float32(a_t), jnp.float32(s1m)),
                                      gcfg=JG.GuidanceConfig(**gkw))
    got = G.cfg_epsilon_attn_guided(punet, punet_skips, torch.from_numpy(x), torch.tensor(301),
                                    pspec, 7.5, (a_t, s1m), gcfg=G.GuidanceConfig(**gkw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    plain = G.cfg_epsilon(punet, torch.from_numpy(x), torch.tensor(301), pspec, 7.5,
                          gcfg=G.GuidanceConfig(**gkw))
    assert not torch.equal(got, plain)


def _render(jb, pb, steps, gkw, **kw):
    """The render in both packages from one x_T (scaled by the first sigma
    for the sigma family) and one set of noises; ``gkw``: the guidance
    switches."""
    kw = dict(width=64, height=64, batch_size=1, steps=steps, **kw)
    pcfg = P.RenderConfig(**kw, guidance=G.GuidanceConfig(**gkw))
    rng = np.random.default_rng(2)
    x_T = rng.standard_normal((1, 8, 8, 4))
    if P.get_sampler(pcfg.sampler)[0] == "sigma":
        x_T = x_T * P._sigma_schedule(pb, pcfg)[0]
    x_T = x_T.astype(np.float32)
    noises = rng.standard_normal((steps + 1, 1, 8, 8, 4)).astype(np.float32)
    _, want = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=JP.RenderConfig(
        **kw, guidance=JG.GuidanceConfig(**gkw)), x_T=jnp.asarray(x_T),
        noises=jnp.asarray(noises))
    _, got = P.txt2img(pb, PROMPT, NEGATIVE, cfg=pcfg, x_T=torch.from_numpy(x_T),
                       noises=torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)
    return got


GUIDED = [
    ("DDIM", dict(attn_guide=True, attn_guide_rounds=2, attn_guide_blur_k=5), "eps"),
    ("DDIM", dict(attn_guide=True, attn_guide_rounds=4, attn_guide_blur_k=3,
                  attn_guide_skip_idx=0, uc_blur=True, uc_blur_k=3, uc_blur_rounds=2), "eps"),
    ("PLMS", dict(attn_guide=True, attn_guide_rounds=2, attn_guide_blur_k=5), "eps"),
    ("DDIM", dict(attn_guide=True, attn_guide_rounds=3, attn_guide_blur_k=5), "v"),
    ("Euler", dict(attn_guide=True), "eps"),
]


@pytest.mark.parametrize("sampler,gkw,param", GUIDED,
                         ids=[f"{s}-{p}-{i}" for i, (s, _, p) in enumerate(GUIDED)])
def test_guided_render_matches_jax(bundles, sampler, gkw, param):
    """txt2img at 64x64 (an 8x8 latent: a 4x4 skip plane resized to it),
    batch 1, 4 DDIM steps (PLMS: 5 evaluations): the guided steps are the
    last ``attn_guide_rounds`` table indices."""
    jb, pb = bundles
    if param == "v":
        jb = dataclasses.replace(jb, parameterization="v")
        pb = dataclasses.replace(pb, parameterization="v")
    got = _render(jb, pb, 4, gkw, sampler=sampler)
    assert bool(torch.isfinite(got).all())


def test_unet_calls_of_a_guided_render(bundles, monkeypatch):
    """DDIM 5 with 2 guided rounds: 5 CFG calls and 2 unconditional ones,
    two of the CFG calls with the skips; no hoisted cross k/v."""
    _, pb = bundles
    calls = []
    inner = M.unet_apply

    def counted(cfg, params, x, t, ctx, *a, **k):
        calls.append((x.shape[0], bool(k.get("return_skips")), k.get("cross_kv") is None))
        return inner(cfg, params, x, t, ctx, *a, **k)

    monkeypatch.setattr(M, "unet_apply", counted)
    P.txt2img(pb, PROMPT, cfg=P.RenderConfig(
        width=32, height=32, steps=5, guidance=G.GuidanceConfig(attn_guide=True,
                                                                attn_guide_rounds=2)))
    assert len(calls) == 7
    assert sorted(calls) == [(1, False, True)] * 2 + [(2, False, True)] * 3 + [(2, True, True)] * 2


def test_tiled_with_attn_guide_raises_in_both(bundles):
    jb, pb = bundles
    kw = dict(width=32, height=32, steps=2, unet_tile=2)
    with pytest.raises(ValueError, match="saliency"):
        JP.txt2img(jb, PROMPT, cfg=JP.RenderConfig(**kw, guidance=JG.GuidanceConfig(
            attn_guide=True)))
    with pytest.raises(ValueError, match="saliency"):
        P.txt2img(pb, PROMPT, cfg=P.RenderConfig(**kw, guidance=G.GuidanceConfig(
            attn_guide=True)))


@pytest.mark.parametrize("shape,pct,out_hw", [((2, 8, 8, 16), 90.0, (16, 16)),
                                              ((3, 4, 6, 8), 50.0, (8, 12))])
def test_saliency_mask_over_the_whole_slice_equals_jax_guided_mask(shape, pct, out_hw):
    """``saliency_mask(batch_idx=None)``, the mask ``cfg_epsilon_attn_guided``
    takes: one quantile over every sample, each resized, as the JAX
    function's inline mask (``guidance/cfg.py`` there)."""
    import jax

    feat = np.random.default_rng(sum(shape) + 1).standard_normal(shape).astype(np.float32)
    m = jnp.mean(jnp.asarray(feat), axis=-1, keepdims=True)
    m = jnp.where(m > jnp.quantile(m, pct / 100.0), 1.0, 0.0)
    want = jax.image.resize(m, (shape[0],) + out_hw + (1,), method="nearest")
    got = A.saliency_mask(torch.from_numpy(feat), pct, out_hw, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- phase 1's UNet batch 1 cases (chip_smoke.py) ----

def test_ub1_group_holds_the_unconditional_guided_call(monkeypatch):
    """A guided step's second UNet call runs at UNet batch 1 (the
    unconditional context at batch 1): its K1-K4 shapes are SD-1.5's at that
    batch (K4's gate admits the 10 conv shapes of a batch-1 step), and the
    "ub1" group makes one case a shape at batch 1. Small stand-in shapes keep
    the tensors small; on the CPU each wrapper runs its plain twin."""
    from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

    shapes = KC.unet_batch_shapes(M.UNetConfig.sd15(), 64, 1, fused=False)
    assert sorted(shapes["conv"]) == sorted(KC.B1_UNET_CONVS)
    # fused (the default at UNet batch 1): the split in_convs' shapes are among them
    fused = KC.unet_batch_shapes(M.UNetConfig.sd15(), 64, 1)
    assert set(fused["conv"]) < set(shapes["conv"]) and len(fused["gn_cat"]) == 8
    assert {n for n, *_ in shapes["gn"]} == {1} and shapes["ff"][0] == (4096, 320)
    assert KC.unet_call_groups()["ub1"] == [(M.UNetConfig.sd15(), 64, 1)]
    small = {"attn": [(256, 2, 8)], "ff": [(16, 16)], "gn": [(1, 8, 8, 64)],
             "conv": [(16, 64, 64), (16, 4, 64)]}
    monkeypatch.setattr(KC, "unet_batch_shapes", lambda cfg, latent, ub, **kw: small)
    cases = KC.kernel_cases("cpu", ["ub1"])
    assert [(c.kernel, c.label) for c in cases] == [
        ("attention_sm90", "bf16 B1 S256 H2 d8"), ("geglu_ff", "bf16 M16 C16 H4 64"),
        ("group_norm", "bf16 1x8x8x64 silu"), ("conv3x3_sm90", "bf16 B1 16x16 64->64"),
        ("conv3x3_narrow", "bf16 B1 16x16 4->64")]
    for case in cases:
        torch.testing.assert_close(case.run(), case.plain(), rtol=0, atol=0)


def test_phase1_holds_every_full_width_unet_call_of_the_paths():
    """``kernel_cases.held_unet_shapes`` (the groups phase 1 runs) has every
    K1-K4 shape of the full-width UNet calls the chip check's paths make:
    SD-1.5 at UNet batch 1, 2, 3, 4, 8 and 16, DeepCache's shallow pass,
    ToDo (full and shallow), ToMe merge at 0.75 and 0.3 with tome_mlp and
    tome_crossattn, SD 2.1 at 768x768, the inpaint and depth UNets; and
    lacks a batch no path runs."""
    from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

    sd15 = M.UNetConfig.sd15()
    todo = dataclasses.replace(sd15, tome_ratio=0.75, tome_mode="downsample")
    merged = [dataclasses.replace(sd15, tome_ratio=r, tome_mode="merge", tome_mlp=True,
                                  tome_crossattn=True) for r in (0.75, 0.3)]
    calls = ([(sd15, 64, ub, None) for ub in (1, 2, 3, 4, 8, 16)]
             + [(sd15, 64, 8, 9), (todo, 64, 8, None), (todo, 64, 8, 9), (todo, 64, 2, None)]
             + [(cfg, 64, 2, None) for cfg in merged]
             + [(M.UNetConfig.sd21(), 96, ub, None) for ub in (2, 8)]
             + [(M.UNetConfig.sd_inpaint(), 64, ub, None) for ub in (2, 3, 8)]
             + [(M.UNetConfig.sd2_depth(), 64, ub, None) for ub in (2, 8)])
    held = KC.held_unet_shapes()
    for call in calls:
        assert KC.unet_shape_keys(*call) <= held, call
    assert not KC.unet_shape_keys(sd15, 64, 5) <= held
