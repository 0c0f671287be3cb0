"""Port parity: ``utils/cv.py`` against OpenCV itself.

The JAX package's animation warps frames with cv2 on the host; the port
computes the same five calls in PyTorch (the GPU's machine has no cv2).
Inputs are uint8 RGB images from numpy seeds at 64^2 and 512^2. The
criteria: the warps equal cv2 on at least 99% of the values and lie within 2
levels on all of them; the LAB round trip is within 1 level on at least 99%
of the values; the matrices within 1e-9 relative. Each test's docstring
says what it reached against cv2 5.0.0.
"""

import cv2
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import animation as JA
from complex_prompt_diffusion_tpu_torch.utils import cv as C

BORDERS = {"replicate": cv2.BORDER_REPLICATE, "wrap": cv2.BORDER_WRAP}
INTERP = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC}
MIN_EQUAL = 0.99


def _image(hw: int, seed: int) -> np.ndarray:
    """Half random pixels, half a smooth gradient: both kinds of content."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:hw, 0:hw]
    smooth = np.stack([xx * 255 // hw, yy * 255 // hw, (xx + yy) * 127 // hw], -1)
    img[hw // 2:] = smooth[hw // 2:].astype(np.uint8)
    return img


def _agree(got: np.ndarray, want: np.ndarray, max_levels: int):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    equal = float((d == 0).mean())
    assert equal >= MIN_EQUAL, equal
    assert int(d.max()) <= max_levels, int(d.max())
    return equal


@pytest.mark.parametrize("center,angle,scale", [((32, 32), 0.0, 1.0), ((256, 256), 13.5, 1.04),
                                                ((10.5, -3.0), -97.0, 0.7)])
def test_rotation_matrix_2d_matches_cv2(center, angle, scale):
    """Reached: equal to the last bit."""
    got = C.rotation_matrix_2d(center, angle, scale)
    want = cv2.getRotationMatrix2D(center, angle, scale)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("theta,phi,gamma,fv", [(10.0, 0.0, 0.0, 30.0), (5.0, 12.0, -7.0, 45.0),
                                                (0.0, -20.0, 3.0, 60.0)])
def test_perspective_transform_matches_cv2(theta, phi, gamma, fv):
    """The animation's perspective-flip corners (JAX ``warp_matrix``'s
    points): within 1e-9 relative of the largest entry (reached ~1e-12)."""
    W = H = 512
    pin = np.array([[0.0, H], [W, H], [W, 0.0], [0.0, 0.0]], np.float32)
    want, _ = JA.warp_matrix(W, H, theta, phi, gamma, 1.0, fv)
    rng = np.random.default_rng(1)
    pout = (pin + rng.normal(0, 20, pin.shape)).astype(np.float32)
    for src, dst, ref in ((pin, None, want), (pin, pout, cv2.getPerspectiveTransform(pin, pout))):
        if dst is None:  # rebuild warp_matrix's dst points from its matrix
            dst = cv2.perspectiveTransform(pin[None].astype(np.float64), want)[0].astype(np.float32)
            ref = cv2.getPerspectiveTransform(src, dst)
        got = C.perspective_transform(src, dst)
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()


def _frame_matrix(hw: int, flip: bool) -> np.ndarray:
    """The 2D animation step's transform at angle 7, zoom 1.05, pan (3.5,
    -2.25), with the perspective flip's homography in front when asked."""
    rot = np.vstack([cv2.getRotationMatrix2D((hw // 2, hw // 2), 7.0, 1.05), [0, 0, 1]])
    trans = np.array([[1, 0, 3.5], [0, 1, -2.25], [0, 0, 1]])
    m = rot @ trans
    if flip:
        M, sl = JA.warp_matrix(hw, hw, 8.0, -5.0, 3.0, 1.0, 40.0)
        post = np.array([[1, 0, (hw - sl) / 2], [0, 1, (hw - sl) / 2], [0, 0, 1]])
        m = M @ post @ m
    return m


@pytest.mark.parametrize("flip", [False, True], ids=["affine", "flip"])
@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("hw", [64, 512])
def test_warp_perspective_matches_cv2(hw, border, flip):
    """INTER_LINEAR. Reached: equal on every value at 64^2, all but a few
    in a million at 512^2 (1 level)."""
    img = _image(hw, seed=hw + flip)
    M = _frame_matrix(hw, flip)
    got = C.warp_perspective(torch.from_numpy(img), M, (hw, hw), border).numpy()
    want = cv2.warpPerspective(img, M, (hw, hw), borderMode=BORDERS[border])
    _agree(got, want, max_levels=2)


@pytest.mark.parametrize("interp", list(INTERP))
@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("hw", [64, 512])
def test_remap_matches_cv2(hw, border, interp):
    """Float maps that leave the frame on every side. Reached: linear equal
    on all but ~1e-6 of the values, cubic on > 99.99% (1 level off)."""
    img = _image(hw, seed=3 * hw)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float64)
    mx = (1.1 * xx + 3.0 * np.sin(yy / 7.0) - 0.1 * hw + 0.37).astype(np.float32)
    my = (0.93 * yy + 2.5 * np.cos(xx / 9.0) + 0.05 * hw - 0.21).astype(np.float32)
    got = C.remap(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my), interp,
                  border).numpy()
    want = cv2.remap(img, mx, my, INTERP[interp], borderMode=BORDERS[border])
    _agree(got, want, max_levels=2)


@pytest.mark.parametrize("hw", [64, 512])
def test_lab_round_trip_matches_cv2(hw):
    """RGB -> LAB -> RGB against cv2's round trip: within 1 level on at
    least 99% of the values (reached: equal on > 99.99%; where a or b was 1
    level off in LAB a saturated colour moves by up to 8 levels in RGB, on
    a few values in a million). RGB -> LAB alone is within 1 level of cv2's
    everywhere."""
    img = _image(hw, seed=7 * hw)
    lab = C.rgb_to_lab_u8(torch.from_numpy(img))
    want_lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    _agree(lab.numpy(), want_lab, max_levels=1)
    back = C.lab_to_rgb_u8(lab).numpy().astype(np.int16)
    d = np.abs(back - cv2.cvtColor(want_lab, cv2.COLOR_LAB2RGB))
    assert (d <= 1).mean() >= MIN_EQUAL and (d == 0).mean() >= 0.9999, ((d <= 1).mean(),
                                                                        (d == 0).mean())
    # LAB -> RGB on cv2's own LAB values: equal (the integer path is exact)
    np.testing.assert_array_equal(C.lab_to_rgb_u8(torch.from_numpy(want_lab)).numpy(),
                                  cv2.cvtColor(want_lab, cv2.COLOR_LAB2RGB))


def test_lab_conversions_match_cv2_on_a_million_colours():
    """2^20 random RGB colours and 2^20 random LAB triples (most outside the
    gamut): RGB -> LAB equal on L everywhere and on a, b but for 1-level
    misses (< 1e-4 of them), LAB -> RGB equal everywhere."""
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    lab = C.rgb_to_lab_u8(torch.from_numpy(rgb)).numpy()
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2LAB)
    np.testing.assert_array_equal(lab[..., 0], want[..., 0])
    d = np.abs(lab.astype(np.int16) - want)
    assert d.max() <= 1 and (d > 0).mean() < 1e-4
    labs = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    np.testing.assert_array_equal(C.lab_to_rgb_u8(torch.from_numpy(labs)).numpy(),
                                  cv2.cvtColor(labs, cv2.COLOR_LAB2RGB))


def test_bad_inputs_raise():
    img = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="border"):
        C.warp_perspective(img, np.eye(3), (8, 8), "reflect")
    with pytest.raises(ValueError, match="uint8"):
        C.warp_perspective(img.float(), np.eye(3), (8, 8))
    with pytest.raises(ValueError, match="interpolation"):
        C.remap(img, torch.zeros(8, 8), torch.zeros(8, 8), "nearest")
    with pytest.raises(ValueError, match="uint8"):
        C.rgb_to_lab_u8(img[..., :2])
    # the identity map and an identity warp leave the image as it is
    x = torch.from_numpy(_image(16, 0))
    assert torch.equal(C.warp_perspective(x, np.eye(3), (16, 16)), x)
    yy, xx = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
    assert torch.equal(C.remap(x, xx, yy, "cubic"), x)
