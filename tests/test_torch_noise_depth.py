"""Port parity: ``noise.py``, the remainder of ``depth.py`` (the estimator
adapters, boosted depth, the patch selection and the R_x search) and
``utils/{misc,image,profiling}.py``.

The JAX package is the reference. Inputs come from numpy seeds; everything
runs on the CPU. Tolerances: the numpy copies (histogram matching, the
matched outpaint noise, the seed and exemplar sequences, the patch
selection) are equal; where a ``jax.image.resize`` became
``utils/resize.resize`` the adapters agree to the resize tolerance of
``tests/test_torch_depth.py`` (2e-5 on unit-scale data, times the stand-in
network's depth scale), the boosted maps in [0, 1] to 1e-5;
``find_noise_for_image`` on the tiny f32 bundle within 1e-5 relative RMSE.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import depth as JD
from complex_prompt_diffusion_tpu import noise as JN
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.guidance import cfg as JG
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.utils import image as JI
from complex_prompt_diffusion_tpu.utils import misc as JMISC
from complex_prompt_diffusion_tpu_torch import depth as D
from complex_prompt_diffusion_tpu_torch import noise as N
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.guidance import cfg as G
from complex_prompt_diffusion_tpu_torch.models import unet as U
from complex_prompt_diffusion_tpu_torch.utils import image as I
from complex_prompt_diffusion_tpu_torch.utils import misc as MISC
from complex_prompt_diffusion_tpu_torch.utils import profiling as PROF

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

RESIZE_ATOL = 2e-5  # tests/test_torch_depth.py: jax.image.resize vs utils/resize.resize
DEPTH_ATOL = 1e-5  # the boosted maps in [0, 1] (reached: ~1e-6)
FIND_NOISE_RTOL = 1e-5


# ---- noise.py ----

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_match_histograms_equal_to_jax(dtype):
    rng = np.random.default_rng(1)
    src = (rng.random((24, 20, 3)) * 255).astype(dtype)
    ref = (rng.random((16, 16, 3)) * 200 + 30).astype(dtype)
    got, want = N.match_histograms(src, ref), JN.match_histograms(src, ref)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_matched_noise_and_flat_match_equal_to_jax():
    rng = np.random.default_rng(0)
    src = rng.random((32, 24, 3))
    mask = np.zeros((32, 24, 3))
    mask[:, 12:] = 1.0
    for q, cv in ((1.0, 0.05), (0.5, 0.3)):
        np.testing.assert_array_equal(
            N.get_matched_noise(src, mask, q, cv, rng=np.random.default_rng(3)),
            JN.get_matched_noise(src, mask, q, cv, rng=np.random.default_rng(3)))
    a, b = rng.random((50, 3)), rng.random((70, 3))
    np.testing.assert_array_equal(N._match_flat(a, b), JN._match_flat(a, b))
    for n in (2, 3, 5, 9):
        assert N.build_cycle_mod(n) == JN.build_cycle_mod(n)


@pytest.mark.parametrize("mode", ["iter", "constant", "c", "loop", "l", "random"])
def test_noise_generator_seed_sequences_equal_to_jax(mode):
    """Every mode's seed sequence; "random" from Python's ``random`` seeded
    alike. The draws differ by design (a torch generator seeded with the
    seed, not ``PRNGKey(seed)``): each is torch's N(0, 1) at its seed."""
    seqs = []
    for gen in (N.NoiseGenerator((3, 4), seed=5, seed_mode=mode, cycle_size=4, device="cpu"),
                JN.NoiseGenerator((3, 4), seed=5, seed_mode=mode, cycle_size=4)):
        random.seed(11)
        seqs.append([gen.seed for _ in range(9)] + [gen.last_seed])
    assert seqs[0] == seqs[1]
    g = N.NoiseGenerator((3, 4), seed=5, seed_mode=mode, device="cpu")
    random.seed(11)
    x = g.sample()
    assert x.dtype == np.float32 and x.shape == (3, 4)
    want = torch.randn((3, 4), generator=torch.Generator().manual_seed(g.last_seed)).numpy()
    np.testing.assert_array_equal(x, want)


def test_noise_generator_exemplar_sequences_equal_to_jax():
    """The exemplar walk (order, wrap-around, reset, clear) step for step:
    the seeds each sample used are equal, and a matched sample holds the
    exemplar's values in both packages (the same sorted values)."""
    port = N.NoiseGenerator((6,), seed=2, seed_mode="iter", device="cpu")
    ref = JN.NoiseGenerator((6,), seed=2, seed_mode="iter")
    rng = np.random.default_rng(4)
    values = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    for g in (port, ref):
        for k, v in enumerate(values):
            assert g.add_exemplar(v, seed=10 + k, uid="u", name=f"e{k}") == k + 1
    for step in range(7):
        match = step % 2 == 1
        a, b = port.sample_sequence("u", match=match), ref.sample_sequence("u", match=match)
        assert port.last_seed == ref.last_seed
        assert port._exemplar_sequence == ref._exemplar_sequence
        if match:
            np.testing.assert_array_equal(np.sort(a), np.sort(np.asarray(b)))
        else:
            np.testing.assert_array_equal(a, port.sample(seed=10 + step % 3))
    for g in (port, ref):
        g.reset_sequence("u")
        assert g._exemplar_sequence["u"] == 0
        g.clear_exemplars("u")
        with pytest.raises(KeyError):
            g.sample_sequence("u")
        with pytest.raises(KeyError):
            g.reset_sequence("u")


def test_find_noise_for_image_matches_jax():
    """The tiny f32 bundle, an 8x8 latent, CFG 2, 6 ascending sigmas from 0
    (the default schedule reversed): the JAX scan against the port's host
    loop through its own denoiser, the same spec on both sides."""
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    jspec = JP.make_guidance_spec(jb, "a foggy harbour")
    pspec = G.GuidanceSpec(*(torch.from_numpy(np.array(a)) for a in
                             (jspec.uncond, jspec.factors, jspec.scales, jspec.masks)))
    sigmas = np.asarray(JS.make_sigma_schedule("default", 5, model_sigmas=jb.tables.sigmas))[::-1]
    assert sigmas[0] == 0 and np.all(np.diff(sigmas) > 0)
    z0 = (0.5 * np.random.default_rng(6).standard_normal((1, 8, 8, 4))).astype(np.float32)

    _, jden = JG.make_denoiser(lambda x, t, c: JU.unet_apply(jb.unet_cfg, jb.unet_params, x, t, c),
                               jspec, model_sigmas=jb.tables.sigmas)
    want = np.asarray(jax.jit(lambda z: JN.find_noise_for_image(jden, z, sigmas, 2.0))(
        jnp.asarray(z0)))
    _, pden = G.make_denoiser(lambda x, t, c: U.unet_apply(pb.unet_cfg, pb.unet_params, x, t, c),
                              pspec, model_sigmas=pb.tables.sigmas)
    got = N.find_noise_for_image(pden, torch.from_numpy(z0), sigmas, 2.0).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))
    assert rel <= FIND_NOISE_RTOL, rel
    assert np.abs(got - z0).max() > 1.0  # the inversion moved the latents to sigma_max scale


# ---- depth.py: adapters ----

class _Transform:
    """A stand-in MiDaS transform: uint8 [H, W, 3] -> [1, 3, H/2, W/2] f32."""

    def __call__(self, img):
        t = torch.from_numpy(np.asarray(img, np.float32) / 255.0).permute(2, 0, 1)[None]
        return torch.nn.functional.avg_pool2d(t, 2)


class _Net(torch.nn.Module):
    """A stand-in depth network: a fixed 1x1 conv over the channels, [N, h, w]."""

    def forward(self, x):
        return (x * torch.tensor([0.3, 0.5, 0.2]).reshape(1, 3, 1, 1)).sum(1) * 40.0

    def inference(self, x):
        return self.forward(x)[:, None]

    def predict_pil(self, img):
        x = torch.from_numpy(np.asarray(img) / 255.0).permute(2, 0, 1)[None].float()
        pred = self.forward(torch.nn.functional.avg_pool2d(x, 4))
        return None, pred.numpy()[:, None]


def _image(seed, shape=(48, 40, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_midas_adapter_matches_jax():
    """The same stand-in network and transform in both adapters (the JAX
    one built without its hub download): equal to 1e-5."""
    net, tf = _Net(), _Transform()
    ref = object.__new__(JD.TorchHubMidasEstimator)
    ref.torch, ref.model, ref.transform = torch, net, tf
    img = _image(1)
    for x in (img, img.astype(np.float32) / 255.0):
        np.testing.assert_allclose(D.TorchHubMidasEstimator(net, tf).estimate(x), ref.estimate(x),
                                   rtol=0, atol=1e-5)


def test_adabins_adapter_matches_jax_and_resizes_with_its_own_bicubic():
    """512x448 (inside the area window, no input resize): equal to the JAX
    adapter to the resize tolerance (the prediction's resize back). 64x64
    (upscaled to 448^2 area): the port's bicubic, not PIL's: the network saw
    a 448x448 image and the depth comes back at 64x64."""
    net = _Net()
    img = _image(2, (512, 448, 3))
    np.testing.assert_allclose(D.AdaBinsEstimator(net).estimate(img),
                               JD.AdaBinsEstimator(net).estimate(img), rtol=0,
                               atol=RESIZE_ATOL * 40)
    seen = []

    class Spy(_Net):
        def predict_pil(self, x):
            seen.append(np.asarray(x).shape)
            return super().predict_pil(x)

    small = _image(3, (64, 64, 3))
    out = D.AdaBinsEstimator(Spy()).estimate(small.astype(np.float32) / 255.0)
    assert seen == [(448, 448, 3)] and out.shape == (64, 64) and out.dtype == np.float32


def test_leres_adapter_matches_jax():
    net = _Net()
    img = _image(4)
    np.testing.assert_allclose(D.LeResEstimator(net).estimate(img),
                               JD.LeResEstimator(net).estimate(img), rtol=0,
                               atol=RESIZE_ATOL * 40)


# ---- depth.py: boosted depth ----

def _float_image(seed, hw=96):
    """Random texture in the middle of a flat frame: gradient-dense and
    flat regions both."""
    rng = np.random.default_rng(seed)
    img = np.full((hw, hw, 3), 0.5, np.float32)
    y0, y1, x0, x1 = hw // 4, 3 * hw // 4, hw // 6, hw - hw // 6
    img[y0:y1, x0:x1] = rng.random((y1 - y0, x1 - x0, 3))
    return img


def test_patch_selection_helpers_equal_to_jax():
    img = _float_image(5)
    gray = D._rgb2gray(img)
    np.testing.assert_array_equal(gray, JD._rgb2gray(img))
    grad = D._sobel_grad(gray)
    np.testing.assert_array_equal(grad, JD._sobel_grad(gray))
    integ = D._integral(grad)
    np.testing.assert_array_equal(integ, JD._integral(grad))
    assert D._rect_sum(integ, [3, 5, 12, 9]) == JD._rect_sum(integ, [3, 5, 12, 9])
    rects = D.grid_patches((96, 80), 16, 12)
    assert rects == JD.grid_patches((96, 80), 16, 12) and rects
    gf = grad.sum() / grad.size
    for factor in (1.0, 2.0):
        assert D.adaptive_select(integ, rects, gf, factor) == JD.adaptive_select(integ, rects, gf,
                                                                                 factor)
    for base in (32, 48):
        got = D.generate_patches(img, base)
        assert got == JD.generate_patches(img, base) and got
    for h, w in ((16, 16), (30, 12)):
        np.testing.assert_array_equal(D._blend_mask(h, w), JD._blend_mask(h, w))
    binary = (grad > np.median(grad)).astype(np.float64)
    for n in (1, 3, 7):
        np.testing.assert_array_equal(D._max_pool(grad, n), JD._max_pool(grad, n))
        np.testing.assert_array_equal(D._dilate(binary, n), JD._dilate(binary, n))


@pytest.mark.parametrize("seed,base", [(8, 64), (9, 32)])
def test_calculate_processing_res_matches_jax(seed, base):
    img = _float_image(seed, 128)
    got = D.calculate_processing_res(img, base_size=base, whole_size_threshold=512)
    want = JD.calculate_processing_res(img, base_size=base, whole_size_threshold=512)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-5


def test_merge_and_double_estimate_match_jax():
    rng = np.random.default_rng(10)
    lo = rng.random((24, 24)).astype(np.float32)
    hi = rng.random((40, 40)).astype(np.float32)

    def merge_net(a, b):
        return 0.7 * a - 0.2 * b

    for model in (None, merge_net):
        np.testing.assert_allclose(D.merge_depth(lo, hi, 64, model),
                                   JD.merge_depth(lo, hi, 64, model), rtol=0, atol=DEPTH_ATOL)
    img = _float_image(11, 64)
    est = D.SobelDepthEstimator()
    np.testing.assert_allclose(D.double_estimate(img, est, 32, 48, merge_size=64),
                               JD.double_estimate(img, JD.SobelDepthEstimator(), 32, 48,
                                                  merge_size=64), rtol=0, atol=DEPTH_ATOL)


@pytest.mark.parametrize("auto_res", [False, True])
def test_boost_depth_matches_jax(auto_res):
    """The Sobel estimator on a 96x96 image at base 32, 4 patches (with
    ``auto_res`` the R_x search's size): the same patches are taken and the
    map agrees to 1e-5 (reached: ~1.3e-6)."""
    img = _float_image(7)
    assert D.generate_patches(img, 64)[:4]  # patches are re-estimated
    got = D.boost_depth(img, D.SobelDepthEstimator(), base_size=32, max_patches=4,
                        auto_res=auto_res)
    want = JD.boost_depth(img, JD.SobelDepthEstimator(), base_size=32, max_patches=4,
                          auto_res=auto_res)
    assert got.shape == (96, 96) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_ATOL)


# ---- utils ----

def test_map_and_seed_everything_match_jax():
    for cls in (MISC.Map, JMISC.Map):
        m = cls({"a": 1}, b=2)
        m.c = 3
        assert (m.a, m.b, m["c"]) == (1, 2, 3)
        del m.a
        with pytest.raises(AttributeError):
            m.a
    draws = []
    for mod in (MISC, JMISC):
        assert mod.seed_everything(17) == 17
        draws.append((random.random(), np.random.random()))
    assert draws[0] == draws[1]


def test_image_helpers_match_jax(tmp_path):
    """The conversions equal; the file functions (PIL, imported inside them)
    read and write what the JAX package's read and write."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (20, 16, 3), dtype=np.uint8)
    for arr in (img, img.astype(np.float32) / 255.0):
        for norm in (True, False):
            np.testing.assert_array_equal(I.image_to_array(arr, norm), JI.image_to_array(arr, norm))
    x = rng.uniform(-1.2, 1.2, (8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(I.array_to_image(x), JI.array_to_image(x))
    path = str(tmp_path / "x.png")
    I.save_image(img, path)
    np.testing.assert_array_equal(I.load_image(path), img)
    np.testing.assert_array_equal(I.load_image(path, (8, 10)), JI.load_image(path, (8, 10)))
    for inv in (False, True):
        np.testing.assert_array_equal(I.load_mask(path, (8, 10), inv),
                                      JI.load_mask(path, (8, 10), inv))


def test_profiling_on_the_cpu(tmp_path):
    t = PROF.StepTimer("frame", device="cpu")
    with t(count=2):
        sum(range(1000))
    t.start()
    t.stop()
    s = t.summary()
    assert s["count"] == 3.0 and s["p50_frame_ms"] >= 0 and "frames_per_sec" in s
    with pytest.raises(RuntimeError):
        t.stop()
    with PROF.trace(str(tmp_path / "tr")) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "tr" / "trace.json").is_file()
    if not torch.cuda.is_available():
        assert PROF.device_memory_stats() == {} and PROF.live_array_bytes() == 0
