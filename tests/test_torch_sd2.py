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
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.ops.attention import attention as jax_attention
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.ops.attention import flash_attention

from _sd2_tiny import LATENT, MODEL_ATOL, MODEL_RTOL, PROMPT, _sd2_tiny_configs
from _sd2_tiny import v_bundles  # noqa: F401 (a fixture: registered by the import)


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


@pytest.mark.parametrize("in_ch", [5, 9])
def test_concat_conditioned_unets_say_they_wait(in_ch):
    """A 5- or 9-channel UNet (depth2img, inpaint) loads, and the entry
    points refuse to render it without its conditioning channels, or with
    a conditioning of the wrong width, naming why (before any launch)."""
    ucfg, vcfg, ccfg = _sd2_tiny_configs()
    jcfg = dataclasses.replace(ucfg, in_channels=in_ch)
    key = jax.random.PRNGKey(0)
    pb = P.ModelBundle.from_jax_params(
        jcfg, JM.init_unet(key, jcfg, commit=False), vcfg,
        JM.init_vae(key, vcfg, commit=False), ccfg,
        JM.init_clip_text(key, ccfg, commit=False), device="cpu", version="sd2")
    assert pb.unet_cfg.in_channels == in_ch
    cfg = P.RenderConfig(steps=2, width=32, height=32)
    with pytest.raises(ValueError, match=f"takes {in_ch} input channels.*needs its conditioning"):
        P.txt2img(pb, "a cat", cfg=cfg)
    with pytest.raises(ValueError, match=f"takes {in_ch} input channels: 4 latent channels and "
                                         f"{in_ch - 3} of depth_mask"):
        P.txt2img(pb, "a cat", cfg=cfg, depth_mask=torch.zeros((4, 4, in_ch - 3)))


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


@pytest.mark.parametrize("ub", [1, 2, 3, 4, 8, 16])
def test_unet_batch_shapes_cover_every_kernel_site(ub):
    """``tools/kernel_cases.unet_batch_shapes`` (phase 1's "ub1" to "ub16"
    groups) at SD 1.5's 64x64 latent: K1 at the three self-attention
    levels; K2 at each level's M (``GEGLU_ROWS`` at UNet batch 8,
    ``GEGLU_B1_ROWS`` at 2); K3 on the 14 planes of ``GN_UNET_PLANES``,
    whose counts the sites' GroupNorm planes reproduce; K4 on the 10 shapes
    of ``B1_UNET_CONVS`` at UNet batch <= 4 and on none above. That is the
    materialized up path; the default form at UNet batch <= 4 is fused: K3's
    two-source form on the 8 pairs of ``GN_CAT_PLANES`` in place of the
    concat planes, K4 on the 6 of those shapes the split in_convs leave."""
    from collections import Counter

    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        B1_UNET_CONVS,
        GEGLU_B1_ROWS,
        GEGLU_ROWS,
        GN_B4_CALLS,
        GN_UNET_PLANES,
        unet_batch_shapes,
        unet_sites,
    )

    cfg = M.UNetConfig.sd15()
    assert Counter(unet_sites(cfg, 64)["gn_planes"]) == dict(zip(GN_UNET_PLANES, GN_B4_CALLS))
    shapes = unet_batch_shapes(cfg, 64, ub, fused=False)
    assert shapes["attn"] == [(4096, 8, 40), (1024, 8, 80), (256, 8, 160)]
    assert shapes["ff"] == [(ub * s, c) for s, c in ((4096, 320), (1024, 640), (256, 1280),
                                                      (64, 1280))]
    assert shapes["ff"] == {8: list(GEGLU_ROWS[:4]), 2: list(GEGLU_B1_ROWS)}.get(ub, shapes["ff"])
    assert sorted(shapes["gn"]) == sorted((ub, s, s, c) for s, c in GN_UNET_PLANES)
    assert sorted(shapes["conv"]) == (sorted(B1_UNET_CONVS) if ub <= 4 else [])
    default = unet_batch_shapes(cfg, 64, ub)
    assert len(default["gn_cat"]) == (8 if ub <= 4 else 0)
    assert len(default["conv"]) == (6 if ub <= 4 else 0)
    assert set(default["conv"]) <= set(shapes["conv"])
    assert default == shapes if ub > 4 else len(default["gn"]) == len(shapes["gn"]) - 8


def test_kernel_cases_make_a_case_for_each_unet_batch_shape(monkeypatch):
    """The "ub4" group makes one case a shape of ``unet_batch_shapes``, on
    the kernel its route takes (K4's sm90 body where C and Co are multiples
    of 64, its narrow bodies at C = 4); on the CPU each wrapper runs its plain
    twin. Small stand-in shapes keep the tensors small."""
    from complex_prompt_diffusion_tpu_torch.tools import kernel_cases as KC

    small = {"attn": [(256, 2, 8)], "ff": [(64, 16)], "gn": [(4, 8, 8, 64)],
             "conv": [(16, 64, 64), (16, 4, 64)]}
    monkeypatch.setattr(KC, "unet_batch_shapes", lambda cfg, latent, ub, **kw: small)
    cases = KC.kernel_cases("cpu", ["ub4"])
    assert [(c.kernel, c.label) for c in cases] == [
        ("attention_sm90", "bf16 B4 S256 H2 d8"), ("geglu_ff", "bf16 M64 C16 H4 64"),
        ("group_norm", "bf16 4x8x8x64 silu"), ("conv3x3_sm90", "bf16 B4 16x16 64->64"),
        ("conv3x3_narrow", "bf16 B4 16x16 4->64")]
    for case in cases:
        torch.testing.assert_close(case.run(), case.plain(), rtol=0, atol=0)
