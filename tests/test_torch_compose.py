"""Port parity of the prompt classes: ``build_spec`` of ComplexPrompt,
WeightedPrompt and CompositionalPrompt (scalar and spatial masks, negations,
a weighted blend, the embedding path of a lerp transform) against the JAX
package's, and tiny renders of a 3-factor masked spec.

The tiny JAX bundle's weights reach the port through
``ModelBundle.from_jax_bundle``; x_T and the injected noises come from
numpy with fixed seeds. f32 on the CPU at a 32x32 canvas (a 4x4 latent).
"""

import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.prompts import compose as JC
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.guidance import GuidanceSpec
from complex_prompt_diffusion_tpu_torch.prompts import compose as C

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# the specs hold CLIP outputs: f32 sums in another order, ~1e-6
SPEC_RTOL, SPEC_ATOL = 1e-5, 1e-5
# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_sampler_slice.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
H = W = 4  # latent side of the 32x32 canvas


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _spec_close(got: GuidanceSpec, want):
    for field in ("uncond", "factors", "scales", "masks"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, field
        np.testing.assert_allclose(g.numpy(), w, rtol=SPEC_RTOL, atol=SPEC_ATOL, err_msg=field)


MASKS = [1.0, 0.5, "left_half_valid", "bottom_quarter_hidden",
         np.arange(16, dtype=np.float32).reshape(4, 4) / 16]


@pytest.mark.parametrize("mask", MASKS, ids=range(len(MASKS)))
def test_complex_prompt_spec_equals_jax(bundles, mask):
    jb, pb = bundles
    want = JC.ComplexPrompt("a red cube", "blurry", scale=1.3, mask=mask).build_spec(H, W, jb)
    got = C.ComplexPrompt("a red cube", "blurry", scale=1.3, mask=mask).build_spec(H, W, pb)
    _spec_close(got, want)
    assert tuple(got.masks.shape) == ((1, H, W, 1) if np.asarray(mask).size > 1
                                      or isinstance(mask, str) else (1, 1, 1, 1))


def _compositional(mod, bundle, spatial: bool):
    p = mod.CompositionalPrompt("a castle", negative_prompt="fog", scale=1.0, bundle=bundle)
    p.add_conjunction("a dragon", scale=1.5, mask="left_half_valid" if spatial else 0.8)
    p.add_negation("a wall", scale=0.5, mask="top_third_hidden" if spatial else 1.0)
    p.add_filter("a bird", strength=-0.25)  # a negative strength: a NOT factor
    p.add_masked_filter(mod.WeightedPrompt("a cat:2.0 a dog:1.0"), "right_half_valid"
                        if spatial else 0.3, strength=0.7)
    return p


@pytest.mark.parametrize("spatial", [False, True])
def test_compositional_spec_equals_jax(bundles, spatial):
    """AND and NOT factors (NOT scales negative), a weighted factor, masks
    all scalar ([K, 1, 1, 1]) or some spatial ([K, h, w, 1])."""
    jb, pb = bundles
    want = _compositional(JC, jb, spatial).build_spec(H, W)
    got = _compositional(C, pb, spatial).build_spec(H, W)
    _spec_close(got, want)
    assert got.num_factors == 5
    assert tuple(got.masks.shape) == ((5, H, W, 1) if spatial else (5, 1, 1, 1))
    assert got.scales.tolist() == pytest.approx([1.0, 1.5, 0.7, -0.5, -0.25])


@pytest.mark.parametrize("text", ["a cat:2.0 a dog:1.0", "a cat:1 a dog:3 a bird:0.5", "one cat"])
def test_weighted_prompt_equals_jax(bundles, text):
    """The weight-normalized sum of the subprompts' embeddings (the port
    encodes them as one CLIP batch); one subprompt is a plain prompt."""
    jb, pb = bundles
    want = JC.WeightedPrompt(text, bundle=jb)
    got = C.WeightedPrompt(text, bundle=pb)
    np.testing.assert_allclose(got.cond_embedding(), want.cond_embedding(), rtol=SPEC_RTOL,
                               atol=SPEC_ATOL)
    assert isinstance(got.cond_embedding(), np.ndarray)
    _spec_close(got.build_spec(H, W), want.build_spec(H, W))


def test_weighted_prompt_encodes_one_clip_batch(bundles, monkeypatch):
    _, pb = bundles
    calls = []
    inner = P.encode_prompt

    def counted(bundle, text):
        calls.append(text)
        return inner(bundle, text)

    monkeypatch.setattr(P, "encode_prompt", counted)
    C.WeightedPrompt("a cat:2.0 a dog:1.0 a bird:0.5", bundle=pb).cond_embedding()
    assert calls == [["a cat", "a dog", "a bird"]]


@pytest.mark.parametrize("mode,args", [("slerp", {}), ("lerp", dict(token_k=6, embed_k=20)),
                                       ("slerp", dict(do_bleed=True, token_k=10))])
def test_embedding_path_equals_jax(bundles, mode, args):
    """``add_prompt_lerp`` with ``lerp_keys=["magnitude"]``: 3 frames along
    the path (token maps from the tokenizer), then each frame's spec."""
    jb, pb = bundles
    paths = []
    for mod, b in ((JC, jb), (C, pb)):
        p = mod.ComplexPrompt("a red cube on a table", "blurry", bundle=b)
        p.add_prompt_lerp("a blue sphere on a table", magnitude=0.8, mode=mode,
                          lerp_keys=["magnitude"], **args)
        paths.append(p.embedding_path(steps=3))
    want, got = paths
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=SPEC_RTOL, atol=SPEC_ATOL)
    assert not np.allclose(got[0], got[2])


def test_prompt_caches_its_embeddings(bundles, monkeypatch):
    _, pb = bundles
    p = C.ComplexPrompt("a cat", "blurry", bundle=pb)
    p.build_spec(H, W)
    monkeypatch.setattr(P, "encode_prompt", lambda *a: pytest.fail("encoded twice"))
    spec = p.build_spec(H, W)
    assert spec.factors.device == pb.device
    assert p.clone()._cache.keys() == {"cond", "uncond"}


# (sampler, options, whether x_T is scaled by the first sigma)
RENDERS = [
    ("DDIM", dict(steps=5, eta=0.5), False),
    ("Euler", dict(steps=5, s_churn=1.0), True),
    ("Euler Ancestral", dict(steps=5), True),
]


@pytest.mark.parametrize("sampler,kw,scaled", RENDERS, ids=[r[0] for r in RENDERS])
def test_three_factor_masked_render_equals_jax(bundles, sampler, kw, scaled):
    """txt2img of a 3-factor spec (AND factor on the left half, NOT factor
    off the top third) at batch 2 with the same x_T and injected noises:
    UNet batch (1 + 3) x 2 = 8."""
    jb, pb = bundles
    cfg_kw = dict(sampler=sampler, width=32, height=32, batch_size=2, guidance_scale=7.5, **kw)
    jcfg, pcfg = JP.RenderConfig(**cfg_kw), P.RenderConfig(**cfg_kw)
    specs = []
    for mod, b in ((JC, jb), (C, pb)):
        p = mod.CompositionalPrompt("a castle", negative_prompt="fog", bundle=b)
        p.add_conjunction("a dragon", scale=1.5, mask="left_half_valid")
        p.add_negation("a wall", scale=0.5, mask="top_third_hidden")
        specs.append(p.build_spec(H, W))
    rng = np.random.default_rng(31)
    x_T = rng.standard_normal((2, H, W, 4)).astype(np.float32)
    if scaled:
        x_T = x_T * np.float32(P._sigma_schedule(pb, pcfg)[0])
    noises = rng.standard_normal((kw["steps"] + 1, 2, H, W, 4)).astype(np.float32)
    w_img, w_lat = JP.txt2img(jb, specs[0], cfg=jcfg, x_T=x_T, noises=noises)
    g_img, g_lat = P.txt2img(pb, specs[1], cfg=pcfg, x_T=torch.from_numpy(x_T),
                             noises=torch.from_numpy(noises))
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(w_lat), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)
    assert np.abs(g_img.astype(np.int16) - np.asarray(w_img).astype(np.int16)).max() <= 1


def test_render_draws_from_the_seed(bundles):
    """``ComplexPrompt.render`` runs the port's txt2img: the same seed gives
    the same bits, another seed other latents."""
    _, pb = bundles
    p = C.CompositionalPrompt("a castle", bundle=pb).add_conjunction("a dragon", mask="l_3_v")
    a_img, a = p.render(steps=3, width=32, height=32, seed=4)
    _, b = p.render(steps=3, width=32, height=32, seed=4)
    _, c = p.render(steps=3, width=32, height=32, seed=5)
    assert a_img.shape == (1, 8, 8, 3) and a_img.dtype == np.uint8
    assert torch.equal(a, b) and not torch.allclose(a, c)
