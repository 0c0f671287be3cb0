"""Depth estimation, depth-mask conditioning and boosted depth.

Counterpart of ``complex_prompt_diffusion_tpu/depth.py``:

  * the ``DepthEstimator`` protocol, the offline ``SobelDepthEstimator``
    (pseudo-depth from blurred luminance contrast and a vertical prior; no
    weights) and the adapters of the monocular models
    (``TorchHubMidasEstimator``, ``AdaBinsEstimator``, ``LeResEstimator``),
    each wrapping a model the caller passes: nothing is downloaded, and
    nothing is loaded at import;
  * the depth -> mask arithmetic (``create_depth_mask``: bicubic resize,
    then [-1, 1]; ``build_depth_mask``, ``rescale``, ``shave``,
    ``get_depth``) and ``DepthManager``, whose ``conditioning_channel`` is
    depth2img's fifth UNet input;
  * boosted depth: ``double_estimate`` (two resolutions merged by
    ``merge_depth``: a merge model, or a frequency blend), the
    gradient-guided patch proposal (``generate_patches``: Sobel mass,
    integral image, ``grid_patches``, ``adaptive_select``) and
    ``boost_depth``, which re-estimates the patches and blends them into the
    whole-image estimate; ``calculate_processing_res`` (the R_x search).

Host-side numpy, with ``utils/resize.py`` wherever the JAX package calls
``jax.image.resize``; a depth map is made once an image, not a step.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol, Tuple

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = [
    "DepthEstimator",
    "SobelDepthEstimator",
    "TorchHubMidasEstimator",
    "AdaBinsEstimator",
    "LeResEstimator",
    "DepthManager",
    "create_depth_mask",
    "build_depth_mask",
    "get_depth",
    "double_estimate",
    "merge_depth",
    "boost_depth",
    "generate_patches",
    "adaptive_select",
    "grid_patches",
    "calculate_processing_res",
    "rescale",
    "shave",
]


class DepthEstimator(Protocol):
    def estimate(self, img: np.ndarray) -> np.ndarray:
        """uint8/float [H, W, 3] image -> depth [H, W] (near = larger)."""
        ...


class SobelDepthEstimator:
    """Offline stand-in for a monocular depth model: pseudo-depth from the
    box-blurred gradient magnitude of the luminance and a vertical prior
    (the bottom of the frame nearer). Deterministic; needs no weights."""

    def estimate(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        grey = img.mean(axis=-1)
        h, w = grey.shape
        prior = np.linspace(0.0, 1.0, h)[:, None] * np.ones((1, w))
        gy, gx = np.gradient(grey)
        mag = np.sqrt(gx**2 + gy**2)
        k = max(3, min(h, w) // 16)
        kernel = np.ones(k) / k
        mag = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, mag)
        mag = np.apply_along_axis(lambda c: np.convolve(c, kernel, mode="same"), 0, mag)
        d = 0.6 * prior + 0.4 * (mag / (mag.max() + 1e-8))
        return d.astype(np.float32)


def _to_uint8(img: np.ndarray, scale: float = 255.0) -> np.ndarray:
    return np.clip(np.asarray(img) * scale, 0, 255).astype(np.uint8)


class TorchHubMidasEstimator:
    """MiDaS (DPT or small) adapter. ``model``: the loaded network (e.g.
    ``torch.hub.load("intel-isl/MiDaS", "DPT_Large")``, done by the caller);
    ``transform``: its input transform (uint8 [H, W, 3] -> [1, 3, h, w]
    batch; the hub's ``dpt_transform`` or ``small_transform``). The
    prediction is resized back to the image bicubically with
    ``F.interpolate`` (align_corners False), as the JAX package's adapter
    does with the same call, and aligned as (50 - d) / 19."""

    def __init__(self, model, transform: Callable):
        self.model = model.eval() if hasattr(model, "eval") else model
        self.transform = transform

    def estimate(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = _to_uint8(np.clip(img, 0, 1))
        with torch.no_grad():
            pred = self.model(self.transform(img))
            pred = torch.nn.functional.interpolate(
                pred.unsqueeze(1), size=img.shape[:2], mode="bicubic", align_corners=False,
            ).squeeze()
        depth = pred.cpu().numpy()
        return ((50.0 - depth) / 19.0).astype(np.float32)


class AdaBinsEstimator:
    """AdaBins adapter: ``model`` has ``predict_pil(image) -> (bin_centers,
    depth)`` (the AdaBins ``InferenceHelper``, which reads its argument with
    ``np.asarray``; here it gets the uint8 [h, w, 3] array). Images above
    500000 pixels are scaled down, below 448^2 up, to that area; the JAX
    package resizes them with PIL (Lanczos down, bicubic up), the port with
    its own antialiased bicubic (``utils/resize.py``), so a resized input
    differs from the JAX package's by a level here and there. The
    prediction is resized back to the image bicubically."""

    MAX_AREA = 500_000
    MIN_AREA = 448 * 448

    def __init__(self, model):
        self.model = model

    def estimate(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = _to_uint8(img, 255.0 if img.max() <= 2.0 else 1.0)
        h, w = img.shape[:2]
        area = h * w
        if area > self.MAX_AREA or area < self.MIN_AREA:
            s = ((self.MAX_AREA if area > self.MAX_AREA else self.MIN_AREA) / area) ** 0.5
            sized = resize(torch.from_numpy(img.astype(np.float32)), (int(h * s), int(w * s), 3),
                           "bicubic")
            img = torch.round(sized).clamp(0, 255).to(torch.uint8).numpy()
        _, depth = self.model.predict_pil(img)
        depth = np.asarray(depth, np.float32)
        depth = depth.reshape(depth.shape[-2], depth.shape[-1])
        if depth.shape != (h, w):
            depth = _resize(depth, (h, w))
        return depth.astype(np.float32)


class LeResEstimator:
    """LeReS adapter: ``model`` has ``inference(x) -> depth`` (the LeReS
    ``RelDepthModel`` interface) on an ImageNet-normalized [1, 3, 448, 448]
    f32 tensor; the input is resized to 448 x 448 and the prediction back to
    the image, bicubically (``utils/resize.py``)."""

    IMAGENET_MEAN = (0.485, 0.456, 0.406)
    IMAGENET_STD = (0.229, 0.224, 0.225)

    def __init__(self, model):
        self.model = model

    def estimate(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        h, w = img.shape[:2]
        small = _resize(img, (448, 448, img.shape[-1]))
        mean = np.asarray(self.IMAGENET_MEAN, np.float32)
        std = np.asarray(self.IMAGENET_STD, np.float32)
        small = (small - mean) / std
        chw = torch.from_numpy(np.ascontiguousarray(small.transpose(2, 0, 1))).float()[None]
        with torch.no_grad():
            pred = self.model.inference(chw)
        depth = np.asarray(pred.detach().cpu().numpy(), np.float32)
        depth = depth.reshape(depth.shape[-2], depth.shape[-1])
        if depth.shape != (h, w):
            depth = _resize(depth, (h, w))
        return depth.astype(np.float32)


def rescale(x):
    """(x - min) / (max - min)."""
    return (x - x.min()) / (x.max() - x.min() + 1e-12)


def shave(x, q: float):
    """Zero the values below the ``q`` quantile of each row."""
    x = np.array(x, np.float32, copy=True)
    v = np.quantile(x, q, axis=-1, keepdims=True)
    x[x < v] = 0.0
    return x


def create_depth_mask(depth_map: np.ndarray, size: Tuple[int, int] = (64, 64)) -> np.ndarray:
    """Depth map [H, W] -> mask [h, w] in [-1, 1]: a bicubic resize (as
    ``jax.image.resize``), then a min/max rescale, in f32."""
    sized = resize(torch.as_tensor(np.asarray(depth_map, np.float32)), size, "bicubic")
    lo, hi = sized.min(), sized.max()
    return (2.0 * (sized - lo) / (hi - lo + 1e-12) - 1.0).numpy()


def build_depth_mask(img: np.ndarray, estimator: Optional[DepthEstimator] = None,
                     q: float = 0.35, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Image -> spatial mask with 1 nearest: 1 - the depth mask, the lowest
    ``q`` quantile shaved to 0, rescaled to [0, 1]; ``size`` defaults to the
    depth map's / 8."""
    estimator = estimator or SobelDepthEstimator()
    depth = estimator.estimate(img)
    if size is None:
        size = (depth.shape[0] // 8, depth.shape[1] // 8)
    mask = 1.0 - create_depth_mask(depth, size=size)
    return rescale(shave(mask, q))


def get_depth(img: np.ndarray, estimators: Tuple[DepthEstimator, ...],
              weights: Optional[Tuple[float, ...]] = None) -> np.ndarray:
    """The weighted sum of several estimators' depth maps (equal weights by
    default)."""
    if weights is None:
        weights = tuple([1.0 / len(estimators)] * len(estimators))
    out = None
    for est, w in zip(estimators, weights):
        d = est.estimate(img)
        out = d * w if out is None else out + d * w
    return out


class DepthManager:
    """An estimator (``SobelDepthEstimator`` by default), a shave quantile
    ``q`` and the mask's ``size``; ``conditioning_channel`` puts depth2img's
    channel on ``device`` (the GPU unless asked otherwise)."""

    def __init__(self, estimator: Optional[DepthEstimator] = None, q: float = 0.0,
                 size: Tuple[int, int] = (64, 64), device="cuda"):
        from complex_prompt_diffusion_tpu_torch.pipeline import _device

        self.estimator = estimator or SobelDepthEstimator()
        self.q = q
        self.size = size
        self.device = _device(device)

    def apply_depth(self, img) -> np.ndarray:
        return self.estimator.estimate(img)

    def get(self, img) -> np.ndarray:
        """The spatial mask of ``img`` (1 nearest, in [0, 1]), as
        :func:`build_depth_mask` with this manager's ``q`` and ``size``."""
        return build_depth_mask(img, self.estimator, self.q, self.size)

    def conditioning_channel(self, img) -> torch.Tensor:
        """depth2img's UNet channel: :func:`create_depth_mask` of the
        image's depth at ``size``, f32 [h, w, 1] on the device."""
        d = create_depth_mask(self.apply_depth(img), size=self.size)
        return torch.as_tensor(d, device=self.device)[..., None]


# ---------------------------------------------------------------------------
# Boosted depth (two-resolution merging and patch-based local boosting)
# ---------------------------------------------------------------------------


def _resize(img: np.ndarray, size: Tuple[int, ...]) -> np.ndarray:
    """Bicubic resize in f32 (``jax.image.resize``'s, ``utils/resize.py``)."""
    return resize(torch.from_numpy(np.asarray(img, np.float32)), size, "bicubic").numpy()


def merge_depth(low_res: np.ndarray, high_res: np.ndarray, merge_size: int = 1024,
                merge_model: Optional[Callable] = None) -> np.ndarray:
    """Merge a coarse and a fine depth estimate, both resized to
    ``merge_size`` and rescaled to [0, 1]. With a merge model (a pix2pix
    merge net, say): its output (in [-1, 1]) mapped to [0, 1] and rescaled.
    Without: the coarse estimate plus the fine one's detail (the fine
    estimate less its own blur, an 8x down-and-up resize), rescaled."""
    e1 = rescale(_resize(low_res, (merge_size, merge_size)))
    e2 = rescale(_resize(high_res, (merge_size, merge_size)))
    if merge_model is not None:
        out = merge_model(e1, e2)
        out = (np.asarray(out) + 1.0) / 2.0
        return rescale(out)
    blur = _resize(_resize(e2, (merge_size // 8, merge_size // 8)), (merge_size, merge_size))
    detail = e2 - blur
    return rescale(e1 + detail)


def double_estimate(img: np.ndarray, estimator: DepthEstimator, size1: int, size2: int,
                    merge_size: int = 1024, merge_model: Optional[Callable] = None) -> np.ndarray:
    """Estimate on the image resized to ``size1`` and to ``size2`` squares
    and merge the two (:func:`merge_depth`)."""
    img = np.asarray(img, np.float32)

    def resize_img(n):
        return _resize(img, (n, n) if img.ndim == 2 else (n, n, img.shape[-1]))

    e1 = estimator.estimate(resize_img(size1))
    e2 = estimator.estimate(resize_img(size2))
    return merge_depth(e1, e2, merge_size=merge_size, merge_model=merge_model)


def _rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """Luma with the 0.2989 / 0.5870 / 0.1140 weights, float64."""
    if rgb.ndim == 2:
        return np.asarray(rgb, np.float64)
    return np.dot(rgb[..., :3], [0.2989, 0.5870, 0.1140])


def _sobel_grad(gray: np.ndarray) -> np.ndarray:
    """|d/dy| + |d/dx| from 3x3 Sobel kernels, edge-padded, float64."""
    g = np.pad(np.asarray(gray, np.float64), 1, mode="edge")
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    h, w = gray.shape
    gx = np.zeros((h, w), np.float64)
    gy = np.zeros((h, w), np.float64)
    for dy in range(3):
        for dx in range(3):
            win = g[dy:dy + h, dx:dx + w]
            gx += kx[dy, dx] * win
            gy += kx.T[dy, dx] * win
    return np.abs(gx) + np.abs(gy)


def _integral(img: np.ndarray) -> np.ndarray:
    """Summed-area table with a zero first row and column."""
    s = np.cumsum(np.cumsum(np.asarray(img, np.float64), 0), 1)
    return np.pad(s, ((1, 0), (1, 0)))


def _rect_sum(integral: np.ndarray, rect) -> float:
    """The sum inside rect [x, y, w, h] from the summed-area table."""
    x, y, w, h = rect
    return float(integral[y + h, x + w] - integral[y, x + w]
                 - integral[y + h, x] + integral[y, x])


def grid_patches(shape: Tuple[int, int], blsize: int, stride: int):
    """The initial grid of overlapping square rects [x, y, w, h], side
    2 ``blsize``, every ``stride``."""
    hgt, wdt = shape
    rects = []
    for x in range(blsize, wdt - blsize, stride):
        for y in range(blsize, hgt - blsize, stride):
            rects.append([x - blsize, y - blsize, 2 * blsize, 2 * blsize])
    return rects


def adaptive_select(integral_grad: np.ndarray, rects, gf: float, factor: float):
    """The rects whose gradient density reaches ``gf``, each grown by
    32 / ``factor`` pixels a step while it stays inside the image and its
    density stays at or above ``gf``."""
    height, width = integral_grad.shape[0] - 1, integral_grad.shape[1] - 1
    step = int(32 / factor)
    out = []
    for rect in rects:
        bbox = list(rect)
        if _rect_sum(integral_grad, bbox) / (bbox[2] * bbox[3]) < gf:
            continue
        while True:
            test = [bbox[0] - step // 2, bbox[1] - step // 2, bbox[2] + step, bbox[3] + step]
            if (test[0] < 0 or test[1] < 0
                    or test[1] + test[3] >= height or test[0] + test[2] >= width):
                break
            if _rect_sum(integral_grad, test) / (test[2] * test[3]) < gf:
                break
            bbox = test
        out.append(bbox)
    return out


def generate_patches(img: np.ndarray, base_size: int, factor: float = 1.0):
    """Gradient-guided patch proposal: Sobel mass thresholded at the mean of
    its nonzero values, integral image, the grid at half ``base_size``
    every 3/4 of that, adaptive growth, biggest first."""
    grad = _sobel_grad(_rgb2gray(img))
    nz = grad[grad > 0]
    if nz.size:
        grad[grad < nz.mean()] = 0
    gf = grad.sum() / grad.size
    integral = _integral(grad)
    blsize = int(round(base_size / 2))
    stride = int(round(blsize * 0.75))
    rects = grid_patches(img.shape[:2], blsize, stride)
    sel = adaptive_select(integral, rects, gf, factor)
    return sorted(sel, key=lambda r: r[2], reverse=True)


def _blend_mask(h: int, w: int) -> np.ndarray:
    """Blending window that falls to 0 at the borders (ramps over a sixth
    of each side)."""
    y = np.minimum(np.arange(h), np.arange(h)[::-1]) / max(h / 6.0, 1)
    x = np.minimum(np.arange(w), np.arange(w)[::-1]) / max(w / 6.0, 1)
    return np.clip(y[:, None], 0, 1) * np.clip(x[None, :], 0, 1)


def boost_depth(img: np.ndarray, estimator: DepthEstimator, *, base_size: int = 384,
                max_patches: int = 16, merge_model: Optional[Callable] = None,
                auto_res: bool = False) -> np.ndarray:
    """Whole-image double estimate (``base_size`` and 2 ``base_size``, or
    with ``auto_res`` the larger of that and :func:`calculate_processing_res`'s
    size), then up to ``max_patches`` patches of :func:`generate_patches`
    double-estimated, fitted to the current estimate by least squares
    (scale and shift) and blended in with :func:`_blend_mask`; rescaled to
    [0, 1]."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    size2 = 2 * base_size
    if auto_res:
        optimal, _ = calculate_processing_res(img, base_size)
        size2 = max(size2, optimal)
    base = double_estimate(img, estimator, base_size, size2, merge_model=merge_model)
    base = _resize(base, (h, w))
    patches = generate_patches(img, min(2 * base_size, min(h, w)))[:max_patches]
    updated = base.copy()
    for x, y, pw, ph in patches:
        patch_rgb = img[y:y + ph, x:x + pw]
        est = double_estimate(patch_rgb, estimator, base_size, 2 * base_size,
                              merge_model=merge_model)
        est = _resize(est, (ph, pw))
        region = updated[y:y + ph, x:x + pw]
        a, b = np.polyfit(est.reshape(-1), region.reshape(-1), 1)
        mapped = a * est + b
        m = _blend_mask(ph, pw)
        updated[y:y + ph, x:x + pw] = m * mapped + (1 - m) * region
    return rescale(updated)


def _max_pool(img: np.ndarray, n: int) -> np.ndarray:
    """Block max with block side ``n`` (ragged edges padded with -inf)."""
    n = max(int(n), 1)
    h, w = img.shape
    ph, pw = -h % n, -w % n
    p = np.pad(img, ((0, ph), (0, pw)), constant_values=-np.inf)
    return p.reshape((h + ph) // n, n, (w + pw) // n, n).max(axis=(1, 3))


def _dilate(binary: np.ndarray, k: int) -> np.ndarray:
    """Binary dilation with a k x k box (zeros outside)."""
    k = max(int(k), 1)
    if k == 1:
        return binary
    from scipy.ndimage import maximum_filter

    return maximum_filter(binary, size=k, mode="constant", cval=0.0)


def calculate_processing_res(img: np.ndarray, base_size: int = 384, confidence: float = 0.1,
                             scale_threshold: float = 3.0,
                             whole_size_threshold: int = 3000) -> Tuple[int, float]:
    """The R_x search: grow the working resolution until more than
    ``confidence`` of the pixels fall outside every edge's receptive field.
    Returns (the size, the patch scale K)."""
    speed_scale = 32
    image_dim = int(min(img.shape[:2]))

    grad = _sobel_grad(_rgb2gray(img))
    grad = _resize(grad, (image_dim, image_dim))
    m, mx = grad.min(), grad.max()
    middle = m + 0.4 * (mx - m)
    grad = (grad >= middle).astype(np.float64)

    kernel = int(base_size / speed_scale)
    kernel2 = max(int(base_size / (4 * speed_scale)), 1)
    threshold = min(whole_size_threshold, scale_threshold * max(img.shape[:2]))

    outputsize_scale = base_size / speed_scale
    grad_resized = grad
    for p_size in range(int(base_size / speed_scale), int(threshold / speed_scale),
                        max(int(base_size / (2 * speed_scale)), 1)):
        pooled = _max_pool(grad, int(np.floor(image_dim / p_size)))
        grad_resized = (_resize(pooled, (p_size, p_size)) >= 0.5).astype(np.float64)
        dilated = _dilate(grad_resized, kernel)
        if (1.0 - dilated).mean() > confidence:
            break
        outputsize_scale = p_size

    patch_scale = float(_dilate(grad_resized, kernel2).mean())
    return int(outputsize_scale * speed_scale), patch_scale
