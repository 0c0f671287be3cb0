"""The port's counterparts of the five OpenCV calls the JAX package's
animation makes on the host: ``getRotationMatrix2D``,
``getPerspectiveTransform``, ``warpPerspective``, ``remap`` and the 8-bit
``cvtColor`` RGB <-> LAB.

The warps and the colour conversions are plain PyTorch on uint8 [H, W, C]
tensors, on the tensor's device; the matrices are float64 numpy arrays on
the host, as OpenCV returns them. Nothing here imports cv2. Each function
follows the arithmetic of OpenCV 5.0's kernels, which these rules were
matched to on uint8 RGB images (64^2 to 512^2, random and smooth content):

  * ``warp_perspective``: OpenCV inverts the forward map in float64 with
    the 3x3 cofactor formula, casts the inverse to float32 and computes
    each source coordinate as fma(m0, x, f32(m1 * y) + m2) / (the same for
    the third row), in float32; then bilinear interpolation in float32
    (a = sx - floor(sx); v0 = p00 + a (p01 - p00), the same for the next
    row, v = v0 + b (v1 - v0)) and round-half-even to uint8. Equal to
    OpenCV on every value tested at 64^2, on all but a few in a million at
    512^2 (1 level: the fma emulated in float64 rounds twice), both borders.
  * ``remap``: the same coordinates taken from float maps; INTER_LINEAR as
    above (the same agreement), INTER_CUBIC with OpenCV's kernel
    A = -0.75 in float32 over 4 x 4 taps, all four weights from the
    polynomial (the fourth is not 1 - the others), rows summed first:
    equal on more than 99.99% of values, 1 level off on the rest (float32
    summation order).
  * BORDER_REPLICATE and BORDER_WRAP apply to each neighbour's coordinate
    on its own (clamped, or taken modulo the side).
  * ``rgb_to_lab_u8`` / ``lab_to_rgb_u8``: OpenCV's integer 8-bit paths
    (sRGB gamma and cube-root tables, D65, L scaled by 255/100, a and b
    offset by 128, descaled sums, saturating casts). RGB -> LAB: L equal on
    all 2^24 colours, a and b on 99.994% (OpenCV rounds two entries of its
    cube-root table in float32; this table is rounded from float64), 1 level
    off on the rest. LAB -> RGB: equal on all 2^24 inputs.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "rotation_matrix_2d",
    "perspective_transform",
    "warp_perspective",
    "remap",
    "rgb_to_lab_u8",
    "lab_to_rgb_u8",
]

BORDERS = ("replicate", "wrap")
_CUBIC_A = -0.75


def rotation_matrix_2d(center: Sequence[float], angle: float, scale: float) -> np.ndarray:
    """``getRotationMatrix2D``: the [2, 3] float64 affine map rotating by
    ``angle`` degrees (counter-clockwise) about ``center`` (x, y) and
    scaling by ``scale``."""
    a = np.deg2rad(float(angle))
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = float(center[0]), float(center[1])
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def perspective_transform(src, dst) -> np.ndarray:
    """``getPerspectiveTransform``: the [3, 3] float64 homography taking the
    four ``src`` points to the four ``dst`` points ([4, 2] each, read as
    float32 as OpenCV reads them), from the 8 x 8 linear system solved in
    float64 (LU), with M[2, 2] = 1."""
    s = np.asarray(src, np.float32).reshape(4, 2).astype(np.float64)
    d = np.asarray(dst, np.float32).reshape(4, 2).astype(np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        a[i, 0] = a[i + 4, 3] = s[i, 0]
        a[i, 1] = a[i + 4, 4] = s[i, 1]
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6] = -s[i, 0] * d[i, 0]
        a[i, 7] = -s[i, 1] * d[i, 0]
        a[i + 4, 6] = -s[i, 0] * d[i, 1]
        a[i + 4, 7] = -s[i, 1] * d[i, 1]
        b[i], b[i + 4] = d[i, 0], d[i, 1]
    x = torch.linalg.solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    return np.append(x, 1.0).reshape(3, 3)


def _invert_3x3(m) -> np.ndarray:
    """The inverse of a 3x3 matrix by OpenCV's float64 cofactor formula
    (``invert`` with DECOMP_LU at n = 3); a singular matrix gives zeros."""
    m = [[float(v) for v in row] for row in np.asarray(m, np.float64).reshape(3, 3)]
    d = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
         - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
         + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [(m[1][1] * m[2][2] - m[1][2] * m[2][1]) * d, (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * d,
         (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * d, (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * d,
         (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * d, (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * d,
         (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * d, (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * d,
         (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * d]
    return np.array(t).reshape(3, 3)


def _check_image(img: torch.Tensor, border: str) -> None:
    if img.dtype != torch.uint8 or img.ndim != 3:
        raise ValueError(f"expected a uint8 [H, W, C] tensor, got {img.dtype} {tuple(img.shape)}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} ({'|'.join(BORDERS)})")


def _border_index(i: torch.Tensor, n: int, border: str) -> torch.Tensor:
    return i.clamp(0, n - 1) if border == "replicate" else torch.remainder(i, n)


def _floor_frac(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(floor(s) as int64, s - floor(s) in float32); coordinates far
    outside any image are clamped first so the int conversion is defined."""
    s = s.clamp(-(2.0 ** 30), 2.0 ** 30)
    fl = torch.floor(s)
    return fl.to(torch.int64), s - fl


def _gather(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, border: str) -> torch.Tensor:
    """The f32 pixels [..., C] at (iy, ix) under ``border``."""
    h, w, c = img.shape
    flat = img.reshape(h * w, c)
    idx = _border_index(iy, h, border) * w + _border_index(ix, w, border)
    return flat[idx].float()


def _bilinear(img, sx, sy, border) -> torch.Tensor:
    ix, a = _floor_frac(sx)
    iy, b = _floor_frac(sy)
    a, b = a[..., None], b[..., None]
    p00, p01 = _gather(img, iy, ix, border), _gather(img, iy, ix + 1, border)
    p10, p11 = _gather(img, iy + 1, ix, border), _gather(img, iy + 1, ix + 1, border)
    v0 = p00 + a * (p01 - p00)
    v1 = p10 + a * (p11 - p10)
    return v0 + b * (v1 - v0)


def _cubic_weights(t: torch.Tensor):
    """OpenCV's four cubic weights (A = -0.75) at fraction ``t``, float32,
    each from its polynomial."""
    A = _CUBIC_A

    def far(u):  # 1 <= u < 2
        return ((A * u - 5 * A) * u + 8 * A) * u - 4 * A

    def near(u):  # 0 <= u < 1
        return ((A + 2) * u - (A + 3)) * u * u + 1

    return far(1.0 + t), near(t), near(1.0 - t), far(2.0 - t)


def _bicubic(img, sx, sy, border) -> torch.Tensor:
    ix, a = _floor_frac(sx)
    iy, b = _floor_frac(sy)
    wx = [w[..., None] for w in _cubic_weights(a)]
    wy = [w[..., None] for w in _cubic_weights(b)]
    out = None
    for k1 in range(4):
        yy = iy + (k1 - 1)
        row = None
        for k2 in range(4):
            term = _gather(img, yy, ix + (k2 - 1), border) * wx[k2]
            row = term if row is None else row + term
        out = row * wy[k1] if out is None else out + row * wy[k1]
    return out


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    """Round half to even and saturate, as OpenCV's float -> uint8 cast."""
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def warp_perspective(img: torch.Tensor, M, size: Tuple[int, int],
                     border: str = "replicate") -> torch.Tensor:
    """``warpPerspective(img, M, size, INTER_LINEAR, border)``: ``M`` is the
    forward map (destination = M source, as OpenCV reads it without
    WARP_INVERSE_MAP), ``size`` = (width, height) of the output; uint8 [H,
    W, C] on ``img``'s device. See the module docstring for the arithmetic."""
    _check_image(img, border)
    m = _invert_3x3(M).astype(np.float32)
    w_out, h_out = int(size[0]), int(size[1])
    dev = img.device
    x = torch.arange(w_out, device=dev, dtype=torch.float64)[None, :]
    y = torch.arange(h_out, device=dev, dtype=torch.float32)[:, None]

    def row(r):
        # fma(m0, x, f32(f32(m1 y) + m2)): the product and sum once rounded
        t = (y * float(m[r, 1]) + float(m[r, 2])).double()
        return (float(m[r, 0]) * x + t).float()

    wgt = row(2)
    return _to_u8(_bilinear(img, row(0) / wgt, row(1) / wgt, border))


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          interp: str = "linear", border: str = "replicate") -> torch.Tensor:
    """``remap(img, map_x, map_y, INTER_LINEAR | INTER_CUBIC, border)`` with
    float32 maps [H', W'] (source x and y of each output pixel); uint8 [H',
    W', C] on ``img``'s device."""
    _check_image(img, border)
    sx = torch.as_tensor(map_x, device=img.device).float()
    sy = torch.as_tensor(map_y, device=img.device).float()
    if interp == "linear":
        return _to_u8(_bilinear(img, sx, sy, border))
    if interp == "cubic":
        return _to_u8(_bicubic(img, sx, sy, border))
    raise ValueError(f"unknown interpolation {interp!r} (linear|cubic)")


# ---------------------------------------------------------------------------
# 8-bit RGB <-> LAB (OpenCV's integer paths)
# ---------------------------------------------------------------------------

_LAB_SHIFT, _GAMMA_SHIFT = 12, 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_BASE = 1 << 14  # the LAB -> RGB path's fixed point
_MIN_AB = -8145
_SRGB2XYZ = np.array([0.412453, 0.357580, 0.180423, 0.212671, 0.715160, 0.072169,
                      0.019334, 0.119193, 0.950227]).reshape(3, 3)
_XYZ2SRGB = np.array([3.240479, -1.53715, -0.498535, -0.969256, 1.875991, 0.041556,
                      0.055648, -0.204043, 1.057311]).reshape(3, 3)
_D65 = np.array([0.950456, 1.0, 1.088754])


def _cdiv(a, b):
    """C's integer division (truncating toward 0)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


@functools.lru_cache(maxsize=None)
def _lab_tables() -> dict:
    """OpenCV's 8-bit LAB tables and coefficients, as int64 numpy arrays."""
    f32 = np.float32
    i = np.arange(256)
    # RGB -> LAB: sRGB gamma to 255 * 8, cube root (linear below (6/29)^3)
    # to 2^15, the XYZ rows over the white point to 2^12
    x = i / 255.0
    gamma = np.where(x <= 809 / 20000, x / (323 / 25), ((x + 11 / 200) / (1 + 11 / 200)) ** 2.4)
    srgb = np.rint(255.0 * (1 << _GAMMA_SHIFT) * gamma).astype(np.int64)
    xc = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (255.0 * (1 << _GAMMA_SHIFT))
    cbrt = np.where(xc < 216 / 24389, xc * (841 / 108) + 16 / 116, np.cbrt(xc))
    cbrt = np.rint((1 << _LAB_SHIFT2) * cbrt).astype(np.int64)
    to_xyz = np.rint((1 << _LAB_SHIFT) * _SRGB2XYZ / _D65[:, None]).astype(np.int64)
    # LAB -> RGB: y and f(y) of each L, f^-1 of f(x), f(z), the inverse
    # gamma over 4096 steps (float32 where OpenCV computes in float32)
    y_tab, fy_tab = np.empty(256, np.int64), np.empty(256, np.int64)
    for k in range(256):
        if k <= 20:
            y_tab[k] = np.rint(f32(k * _BASE * 20 * 9) / f32(17 * 29 * 29 * 29))
            fy_tab[k] = np.rint(f32(_BASE) * (f32(f32(16) / f32(116))
                                              + f32(f32(k * 5) / f32(3 * 17 * 29))))
        else:
            fy = f32(f32(k * 100 * _BASE) / f32(255 * 116)) + f32(f32(16 * _BASE) / f32(116))
            fy_tab[k] = np.rint(fy)
            y_tab[k] = np.rint(f32(f32(fy * fy) * fy) / f32(_BASE * _BASE))
    v = np.arange(_MIN_AB, _BASE * 9 // 4 + _MIN_AB, dtype=np.int64)
    xz = np.where(v <= 3390, _cdiv(v * 108, 841) - _BASE * 16 // 116 * 108 // 841,
                  _cdiv(_cdiv(v * v, _BASE) * v, _BASE))
    from_xyz = np.rint(4096 * _XYZ2SRGB * _D65[None, :]).astype(np.int64)
    xg = (np.arange(4096, dtype=np.float32) / f32(4096)).astype(np.float64)
    inv = np.where(xg <= 7827 / 2500000, xg * (323 / 25), xg ** (1 / 2.4) * (1 + 11 / 200) - 11 / 200)
    inv = np.rint(f32(255) * inv.astype(np.float32)).astype(np.int64)
    return {"srgb": srgb, "cbrt": cbrt, "to_xyz": to_xyz, "y": y_tab, "fy": fy_tab, "xz": xz,
            "from_xyz": from_xyz, "inv_gamma": inv}


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def _tab(name: str, device) -> torch.Tensor:
    return torch.as_tensor(_lab_tables()[name], device=device)


def rgb_to_lab_u8(img: torch.Tensor) -> torch.Tensor:
    """``cvtColor(img, COLOR_RGB2LAB)`` on uint8 [..., 3]: L in [0, 255]
    (L * 255 / 100), a and b offset by 128; on ``img``'s device."""
    if img.dtype != torch.uint8 or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., 3], got {img.dtype} {tuple(img.shape)}")
    dev = img.device
    srgb, cbrt, c = _tab("srgb", dev), _tab("cbrt", dev), _lab_tables()["to_xyz"]
    rgb = [srgb[img[..., k].long()] for k in range(3)]
    f = [cbrt[_descale(rgb[0] * int(c[r, 0]) + rgb[1] * int(c[r, 1]) + rgb[2] * int(c[r, 2]),
                       _LAB_SHIFT)] for r in range(3)]
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << _LAB_SHIFT2)
    lab = torch.stack([_descale(l_scale * f[1] + l_shift, _LAB_SHIFT2),
                       _descale(500 * (f[0] - f[1]) + half, _LAB_SHIFT2),
                       _descale(200 * (f[1] - f[2]) + half, _LAB_SHIFT2)], dim=-1)
    return lab.clamp(0, 255).to(torch.uint8)


def lab_to_rgb_u8(img: torch.Tensor) -> torch.Tensor:
    """``cvtColor(img, COLOR_LAB2RGB)`` on uint8 [..., 3] (OpenCV's 8-bit
    LAB encoding); on ``img``'s device."""
    if img.dtype != torch.uint8 or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., 3], got {img.dtype} {tuple(img.shape)}")
    dev = img.device
    ll, aa, bb = (img[..., k].long() for k in range(3))
    y = _tab("y", dev)[ll]
    fy = _tab("fy", dev)[ll]
    adiv = ((5 * aa * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((bb * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    xz = _tab("xz", dev)
    x = xz[fy + adiv - _MIN_AB]
    z = xz[fy - bdiv - _MIN_AB]
    c, inv = _lab_tables()["from_xyz"], _tab("inv_gamma", dev)
    out = [inv[_descale(int(c[r, 0]) * x + int(c[r, 1]) * y + int(c[r, 2]) * z, 14).clamp(0, 4095)]
           for r in range(3)]
    return torch.stack(out, dim=-1).clamp(0, 255).to(torch.uint8)
