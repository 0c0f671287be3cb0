"""Port parity: ``animation.py`` (keyframes, the 2D / 3D warps over
``utils/cv.py``, the LAB colour match, ``render_animation``).

The JAX package is the reference: its warps run through cv2, the port's
through its own counterparts. Criteria: the keyframe series equal; the warps
equal JAX's on at least 99% of the values and within 2 levels on all; the
colour match within 1 level on at least 99%; ``render_animation`` on the
tiny bundle (3 frames, DDIM, 2D + 3D warps, the draws JAX makes from its
keys injected): frame 0 within 1 level (the decode parity of
``tests/test_torch_vae_img2img.py``), the later frames within a mean of 0.5
and a max of 4 levels. Each test says what it reached.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import animation as JA
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.prompts import ComplexPrompt as JComplexPrompt
from complex_prompt_diffusion_tpu_torch import animation as A
from complex_prompt_diffusion_tpu_torch import depth as D
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.prompts import ComplexPrompt

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

MIN_EQUAL = 0.99


def _agree(got, want, max_levels):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d <= max_levels).all(), int(d.max())
    assert float((d == 0).mean()) >= MIN_EQUAL, float((d == 0).mean())
    return d


def _image(hw, seed):
    """A smooth colour field with random texture on its lower half."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    img = np.stack([200 * xx + 30, 180 * yy + 20, 120 * (1 - xx * yy) + 60], -1)
    img[hw // 2:] += rng.normal(0, 25, (hw - hw // 2, hw, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# ---- keyframes ----

@pytest.mark.parametrize("method", ["Linear", "Quadratic", "Cubic"])
def test_keyframe_series_equal_jax(method):
    raw = "0: (0.5), 10: (2.0), 25: (-1.5), 40: (3)"
    assert A.parse_key_frames(raw) == JA.parse_key_frames(raw)
    assert A.parse_key_frames(raw, float) == JA.parse_key_frames(raw, float)
    for integer in (False, True):
        for keys in (raw, "5: (2.0)", "0: (1), 9: (4)"):
            np.testing.assert_array_equal(
                A.build_key_frames(keys, 50, integer, method),
                JA.build_key_frames(keys, 50, integer, method))
    with pytest.raises(RuntimeError):
        A.parse_key_frames("no keyframes here")
    args = A.AnimArgs(max_frames=30, angle="0: (0), 29: (10)", zoom="0: (1.0), 15: (1.2)",
                      rotation_3d_y="0: (0), 20: (4)", coherance_schedule="0: (0.7)")
    jargs = JA.AnimArgs(**{f.name: getattr(args, f.name) for f in dataclasses.fields(args)})
    assert [f.name for f in dataclasses.fields(A.AnimArgs)] == [
        f.name for f in dataclasses.fields(JA.AnimArgs)]
    assert A.AnimArgs() == A.AnimArgs(**{f.name: getattr(JA.AnimArgs(), f.name)
                                         for f in dataclasses.fields(JA.AnimArgs)})
    keys, jkeys = A.KeyFrames(args), JA.KeyFrames(jargs)
    assert A.KeyFrames.SERIES == JA.KeyFrames.SERIES
    for name in A.KeyFrames.SERIES:
        np.testing.assert_array_equal(getattr(keys, f"{name}_series"),
                                      getattr(jkeys, f"{name}_series"))


def test_rotation_projection_and_flip_matrix_match_jax():
    for angles in ([0, 0, 0], [10, -20, 30], [45.5, 3, -7]):
        np.testing.assert_array_equal(A.make_rotation_matrix(angles), JA.make_rotation_matrix(angles))
    pts = np.random.default_rng(1).normal(size=(20, 3)) + [0, 0, 3]
    rot = JA.make_rotation_matrix([5, 10, 15])[:3, :3]
    np.testing.assert_array_equal(A._fov_project(pts, rot, np.ones(3), 40.0),
                                  JA._fov_project(pts, rot, np.ones(3), 40.0))
    for params in ((64, 48, 10.0, 0.0, 0.0, 1.0, 30.0), (512, 512, 5.0, 12.0, -7.0, 1.0, 45.0)):
        got, sl = A.warp_matrix(*params)
        want, jsl = JA.warp_matrix(*params)
        assert sl == jsl
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


# ---- the warps ----

def _keys_args(hw, flip, border, pan=(4.5, -3.0), **kw):
    fields = dict(w=hw, h=hw, max_frames=4, angle="0: (0), 3: (9)", zoom="0: (1.0), 3: (1.12)",
                  pan_x=f"0: ({pan[0]})", pan_y=f"0: ({pan[1]})", flip_2d_perspective=flip,
                  perspective_flip_theta="0: (6)", perspective_flip_phi="0: (-4)",
                  perspective_flip_gamma="0: (3)", perspective_flip_fv="0: (50)",
                  translation_x="0: (10)", translation_y="0: (-6)", translation_z="0: (15)",
                  rotation_3d_x="0: (1.5)", rotation_3d_y="0: (-2)", rotation_3d_z="0: (3)",
                  border=border, **kw)
    args, jargs = A.AnimArgs(**fields), JA.AnimArgs(**fields)
    return A.KeyFrames(args), args, JA.KeyFrames(jargs), jargs


@pytest.mark.parametrize("flip", [False, True], ids=["affine", "flip"])
@pytest.mark.parametrize("border", ["replicate", "wrap"])
@pytest.mark.parametrize("hw", [64, 512])
def test_2d_step_matches_jax(hw, border, flip):
    """Frame 2's rotation, zoom and pan (and the perspective flip). Reached:
    equal on every value at 64^2, on all but a few in a million at 512^2."""
    keys, args, jkeys, jargs = _keys_args(hw, flip, border)
    img = _image(hw, hw + flip)
    _agree(A.do_2d_animation_step(torch.from_numpy(img), 2, keys, args),
           JA.do_2d_animation_step(img, 2, jkeys, jargs), 2)


def test_flip_drops_the_pan_in_both_packages():
    """``np.matmul(np.matmul(M, post), rot_mat, trans_mat)``: the pan matrix
    is np.matmul's ``out``, so under ``flip_2d_perspective`` the pan changes
    nothing in JAX and nothing in the port; without the flip it moves the
    frame in both."""
    img = _image(64, 3)
    for flip in (True, False):
        runs = {}
        for pan in ((0.0, 0.0), (7.0, -5.0)):
            keys, args, jkeys, jargs = _keys_args(64, flip, "replicate", pan=pan)
            runs[pan] = (A.do_2d_animation_step(img, 2, keys, args).numpy(),
                         JA.do_2d_animation_step(img, 2, jkeys, jargs),
                         A.frame_transform_2d(2, keys, args))
        (p0, j0, m0), (p1, j1, m1) = runs.values()
        assert np.array_equal(j0, j1) == flip and np.array_equal(p0, p1) == flip
        assert np.array_equal(m0, m1) == flip


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("depth", [False, True], ids=["flat", "depth"])
@pytest.mark.parametrize("hw", [64, 512])
def test_3d_step_matches_jax(hw, depth, mode):
    """The reprojection grid (equal: the same float64 numpy) through remap,
    with a Sobel depth map or the flat depth 3. Reached: > 99.99% equal,
    1 level off elsewhere (bicubic's float32 summation order)."""
    img = _image(hw, 5 * hw)
    depth_map = D.SobelDepthEstimator().estimate(img) * 4 + 1 if depth else None
    keys, args, jkeys, jargs = _keys_args(hw, False, "replicate" if depth else "wrap",
                                          sampling_mode=mode, depth_map=depth_map)
    gx, gy = A.remap_grid_3d(2, keys, args)
    assert gx.dtype == np.float32 and gx.shape == (hw, hw)
    _agree(A.do_3d_animation_step(img, 2, keys, args),
           JA.do_3d_animation_step(img, 2, jkeys, jargs), 2)


@pytest.mark.parametrize("hw", [64, 512])
def test_match_colors_matches_jax(hw):
    """LAB histogram matching of one frame to another: within 1 level on at
    least 99% of the values (reached: equal on > 99.9%)."""
    x, ref = _image(hw, 11), _image(hw, 12)[::-1].copy()
    got = A.match_colors(torch.from_numpy(x), torch.from_numpy(ref)).numpy()
    want = JA.match_colors(x, ref)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (d <= 1).mean() >= MIN_EQUAL, (d <= 1).mean()


# ---- the frame loop ----

def test_render_animation_matches_jax():
    """The tiny bundle, 3 frames at 64x64 (8x8 latents, 16x16 frames), DDIM
    6 at strength 0.5 (t_start 3), CFG 7.5, 2D (angle, zoom, pan) and 3D
    (a depth map) warps, diversity 0.1; JAX's draws from its keys (x_T,
    pixel noise, posterior noise, diversity noise, forward noise) injected
    into the port. Reached: frame 0 equal, later frames max 1 level."""
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    kw = dict(steps=6, width=64, height=64, guidance_scale=7.5, denoising_strength=0.5, seed=3)
    jcfg, cfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    depth = np.linspace(1.0, 3.0, 256).reshape(16, 16).astype(np.float32)
    fields = dict(w=16, h=16, max_frames=3, angle="0: (0), 2: (4)", zoom="0: (1.04)",
                  pan_x="0: (1.5)", pan_y="0: (-1)", translation_z="0: (10)",
                  rotation_3d_y="0: (2)", depth_map=depth)
    jprompt = JComplexPrompt("a lighthouse at dusk", bundle=jb)
    prompt = ComplexPrompt("a lighthouse at dusk", bundle=pb)
    want = JA.render_animation(jb, lambda i: jprompt, jcfg, JA.AnimArgs(**fields), 3, seed=7,
                               warp_3d=True, coherance=0.9, diversity=0.1)

    # the draws JAX made: frame 0's x_T, then each later frame's from its key
    key = jax.random.PRNGKey(7)
    x_T = jax.random.normal(jax.random.split(jax.random.fold_in(key, 0))[0], (1, 8, 8, 4))
    pixel, enc, div, lat = [], [], [], []
    itab = JS.make_inference_tables(jb.tables, 6)
    assert max(1, int(0.5 * itab.num_steps)) == 3
    for i in (1, 2):
        k_n, k_e, k_s = jax.random.split(jax.random.fold_in(key, i), 3)
        pixel.append(np.asarray(jax.random.normal(k_n, (16, 16, 3))))
        enc.append(np.asarray(jax.random.normal(k_e, (1, 8, 8, 4))))
        div.append(np.asarray(jax.random.normal(k_n, (1, 8, 8, 4))))
        lat.append(np.asarray(jax.random.normal(k_s, (1, 8, 8, 4))))
    timings = []
    got = A.render_animation(pb, lambda i: prompt, cfg, A.AnimArgs(**fields), 3, warp_3d=True,
                             coherance=0.9, diversity=0.1, x_T=torch.from_numpy(np.array(x_T)),
                             pixel_noises=pixel, encode_noises=enc, diversity_noises=div,
                             latent_noises=lat, timings=timings)
    assert len(got) == len(want) == 3 and len(timings) == 3
    assert set(timings[1]) == {"match", "warp_3d", "warp_2d", "encode", "sample", "decode"}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (16, 16, 3) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        if i == 0:
            assert d.max() <= 1, d.max()
        else:
            assert d.mean() <= 0.5 and d.max() <= 4, (i, d.mean(), d.max())
    assert not np.array_equal(got[1], got[0])  # the frames move


def test_render_animation_draws_from_its_generator():
    """Without injected draws the port draws from the generator: the same
    seed gives the same frames, another seed others; the diversity noise
    comes from the pixel noise's draw state."""
    pb = P.ModelBundle.random("tiny", seed=0, device="cpu")
    cfg = P.RenderConfig(steps=2, width=32, height=32, denoising_strength=0.5)
    args = A.AnimArgs(w=8, h=8, max_frames=2, zoom="0: (1.05)", angle="0: (2)")
    prompt = ComplexPrompt("a corridor", bundle=pb)
    runs = [A.render_animation(pb, lambda i: prompt, cfg, args, 2, diversity=0.2, device="cpu",
                               generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_render_animation_seeds_from_seed_as_jax():
    """``seed=`` is JAX's parameter (``animation.py:326``, ``PRNGKey(seed)``):
    the default generator is seeded from it, and ``cfg.seed`` is not read.
    The numbers differ from JAX's (torch against JAX RNG); the seed's
    source is what is pinned."""
    assert inspect.signature(A.render_animation).parameters["seed"].default == 0
    assert inspect.signature(JA.render_animation).parameters["seed"].default == 0
    pb = P.ModelBundle.random("tiny", seed=0, device="cpu")
    args = A.AnimArgs(w=8, h=8, max_frames=2, zoom="0: (1.05)")
    prompt = ComplexPrompt("a corridor", bundle=pb)

    def run(cfg_seed, **kw):
        cfg = P.RenderConfig(steps=2, width=32, height=32, denoising_strength=0.5,
                             seed=cfg_seed)
        return A.render_animation(pb, lambda i: prompt, cfg, args, 2, device="cpu", **kw)

    seeded = run(0, seed=7)
    assert all(np.array_equal(a, b) for a, b in zip(
        seeded, run(5, generator=torch.Generator().manual_seed(7))))
    assert all(np.array_equal(a, b) for a, b in zip(seeded, run(11, seed=7)))
    assert not all(np.array_equal(a, b) for a, b in zip(seeded, run(7)))
