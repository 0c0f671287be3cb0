"""Animation: keyframe schedules, 2D/3D frame warps, the frame loop.

Counterpart of ``complex_prompt_diffusion_tpu/animation.py``:

  * keyframe strings "0: (0.5), 60: (1.0)" -> interpolated series
    (``parse_key_frames``, ``interpolate_key_frames``, ``build_key_frames``,
    ``KeyFrames``, ``AnimArgs``): copies;
  * the 2D warp (rotation, zoom, pan, optional perspective flip) and the 3D
    warp (depth reprojection through a moved perspective camera), and the
    LAB colour match to frame 0: the transform matrices and the 3D remap
    grid are computed on the host in float64 exactly as the JAX package
    computes them, and the pixels move through ``utils/cv.py`` (the port's
    counterparts of the cv2 calls the JAX package makes) on the frame's
    device;
  * ``render_animation``: the frame loop. Frame 0 is ``sample_latents``;
    each later frame colour-matches the previous frame to frame 0, warps it
    (3D, then 2D), adds pixel noise times (1 - coherance), encodes it,
    mixes in ``diversity``, noises the latents to a DDIM-table ``t_start``
    and runs ``sample_latents(x_init=, t_start=)``; every frame is decoded.

Kept as the JAX package has them (not fixed):

  * with ``flip_2d_perspective`` the 2D step's product is written
    ``np.matmul(np.matmul(M, post), rot_mat, trans_mat)``: the third
    argument of ``np.matmul`` is ``out``, so the pan is dropped;
  * later frames start from the DDIM table's ``t_start`` whatever the
    sampler;
  * the diversity noise reuses the pixel noise's draw state (JAX: its key
    ``k_n``): here it is drawn from a copy of the generator's state as it was
    before the pixel noise;
  * ``match_colors`` truncates the matched LAB values (``astype(uint8)``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from functools import reduce
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.noise import match_histograms
from complex_prompt_diffusion_tpu_torch.utils import cv as C

__all__ = [
    "AnimArgs",
    "KeyFrames",
    "parse_key_frames",
    "interpolate_key_frames",
    "build_key_frames",
    "match_colors",
    "do_2d_animation_step",
    "do_3d_animation_step",
    "warp_matrix",
    "make_rotation_matrix",
    "render_animation",
]


def parse_key_frames(string: str, prompt_parser=None) -> Dict[int, str]:
    """'0: (0.5), 60: (1.0)' -> {0: '0.5', 60: '1.0'}."""
    pattern = r"((?P<frame>[0-9]+):[\s]*[\(](?P<param>[\S\s]*?)[\)])"
    frames: Dict[int, str] = {}
    for m in re.finditer(pattern, string):
        frame = int(m.groupdict()["frame"])
        param = m.groupdict()["param"]
        frames[frame] = prompt_parser(param) if prompt_parser else param
    if frames == {} and len(string) != 0:
        raise RuntimeError("Key Frame string not correctly formatted")
    return frames


def interpolate_key_frames(key_frames: Dict[int, str], max_frames: int, integer: bool = False,
                           interp_method: str = "Linear") -> np.ndarray:
    """Sparse keyframes onto [0, max_frames): "Linear" (np.interp),
    "Quadratic" or "Cubic" (scipy splines, degraded to the next lower
    method when there are too few points)."""
    items = sorted((k, float(v)) for k, v in key_frames.items())
    xs = np.array([k for k, _ in items], dtype=np.float64)
    ys = np.array([v for _, v in items], dtype=np.float64)
    grid = np.arange(max_frames)

    if interp_method == "Cubic" and len(items) <= 3:
        interp_method = "Quadratic"
    if interp_method == "Quadratic" and len(items) <= 2:
        interp_method = "Linear"

    if interp_method == "Linear" or len(items) == 1:
        series = np.interp(grid, xs, ys)
    else:
        from scipy.interpolate import interp1d

        f = interp1d(xs, ys, kind=interp_method.lower(), fill_value="extrapolate")
        series = f(np.clip(grid, xs[0], xs[-1]))
    return series.astype(int) if integer else series


def build_key_frames(raw: str, max_frames: int, integer=False, interp_method="Linear"):
    return interpolate_key_frames(parse_key_frames(raw), max_frames, integer=integer,
                                  interp_method=interp_method)


@dataclasses.dataclass
class AnimArgs:
    """The animation's settings (the JAX package's defaults)."""

    w: int = 512
    h: int = 512
    max_frames: int = 60
    angle: str = "0: (0)"
    zoom: str = "0: (1.0)"
    pan_x: str = "0: (0)"
    pan_y: str = "0: (0)"
    translation_x: str = "0: (0)"
    translation_y: str = "0: (0)"
    translation_z: str = "0: (0)"
    perspective_flip_theta: str = "0: (0)"
    perspective_flip_phi: str = "0: (0)"
    perspective_flip_gamma: str = "0: (0)"
    perspective_flip_fv: str = "0: (30)"
    rotation_3d_x: str = "0: (0)"
    rotation_3d_y: str = "0: (0)"
    rotation_3d_z: str = "0: (0)"
    coherance_schedule: str = "0: (0)"
    strength_schedule: str = "0: (0)"
    contrast_schedule: str = "0: (0)"
    near_plane: float = 200.0
    far_plane: float = 1000.0
    fov: float = 40.0
    flip_2d_perspective: bool = False
    border: str = "replicate"  # or "wrap"
    sampling_mode: str = "bicubic"
    depth_map: Optional[np.ndarray] = None


class KeyFrames:
    """Every interpolated series of :class:`AnimArgs`, as ``<name>_series``."""

    SERIES = [
        "angle", "zoom", "pan_x", "pan_y",
        "translation_x", "translation_y", "translation_z",
        "perspective_flip_theta", "perspective_flip_phi",
        "perspective_flip_gamma", "perspective_flip_fv",
        "rotation_3d_x", "rotation_3d_y", "rotation_3d_z",
        "coherance_schedule", "strength_schedule", "contrast_schedule",
    ]

    def __init__(self, args: AnimArgs):
        for name in self.SERIES:
            setattr(self, f"{name}_series", build_key_frames(getattr(args, name), args.max_frames))


def _frame(img, device=None) -> torch.Tensor:
    """A uint8 [H, W, 3] frame as a tensor on ``device`` (default: where it
    is; a numpy frame goes to the CPU)."""
    t = img if torch.is_tensor(img) else torch.from_numpy(np.ascontiguousarray(img))
    return t.to(device) if device is not None else t


def match_colors(x, s) -> torch.Tensor:
    """LAB histogram matching of frame ``x`` to the reference frame ``s``
    (uint8 [H, W, 3] each): both to LAB on ``x``'s device
    (``utils/cv.py``), the quantile mapping on the host (numpy), the
    matched values clipped and truncated to uint8, back to RGB on the
    device."""
    x = _frame(x)
    s = _frame(s, x.device)
    prev_lab = C.rgb_to_lab_u8(x)
    ref_lab = C.rgb_to_lab_u8(s)
    matched = match_histograms(prev_lab.cpu().numpy(), ref_lab.cpu().numpy())
    matched = torch.from_numpy(np.clip(matched, 0, 255).astype(np.uint8)).to(x.device)
    return C.lab_to_rgb_u8(matched)


def make_rotation_matrix(rotation_angles: List[float]) -> np.ndarray:
    """Homogeneous XYZ rotation [4, 4] from (phi, gamma, theta) degrees."""
    phi, gamma, theta = [np.deg2rad(a) for a in rotation_angles]
    Rphi = np.eye(4)
    Rphi[1, 1] = Rphi[2, 2] = np.cos(phi)
    Rphi[1, 2], Rphi[2, 1] = -np.sin(phi), np.sin(phi)
    Rgamma = np.eye(4)
    Rgamma[0, 0] = Rgamma[2, 2] = np.cos(gamma)
    Rgamma[0, 2], Rgamma[2, 0] = np.sin(gamma), -np.sin(gamma)
    Rtheta = np.eye(4)
    Rtheta[0, 0] = Rtheta[1, 1] = np.cos(theta)
    Rtheta[0, 1], Rtheta[1, 0] = -np.sin(theta), np.sin(theta)
    return reduce(np.matmul, [Rphi, Rgamma, Rtheta])


def warp_matrix(W, H, theta, phi, gamma, scale, fV):
    """The perspective-flip homography and its side length: the frame's
    corners rotated in front of a camera of field of view ``fV`` and
    projected (``utils/cv.perspective_transform``)."""
    fVhalf = np.deg2rad(fV / 2.0)
    d = np.sqrt(W * W + H * H)
    side_length = scale * d / np.cos(fVhalf)
    h = d / (2.0 * np.sin(fVhalf))

    T = np.eye(4)
    T[2, 3] = -h
    R = make_rotation_matrix([phi, gamma, theta])

    ptsIn = np.array([[[-W / 2.0, H / 2.0, 0.0], [W / 2.0, H / 2.0, 0.0],
                       [W / 2.0, -H / 2.0, 0.0], [-W / 2.0, -H / 2.0, 0.0]]])
    ptsOut = np.zeros_like(ptsIn)
    halfFov = np.tan(fVhalf)
    pts = (T @ R).dot(np.concatenate([ptsIn[0], np.ones((4, 1))], axis=1).T).T
    for i in range(4):
        x, y, z = pts[i, 0], pts[i, 1], pts[i, 2]
        ptsOut[0, i] = [x / (-z * halfFov), y / (-z * halfFov), 0.0]

    pin = ptsIn[0, :, :2] + np.array([W / 2.0, H / 2.0])
    pout = (ptsOut[0, :, :2] + 1.0) * (0.5 * side_length)
    M = C.perspective_transform(pin.astype(np.float32), pout.astype(np.float32))
    return M, side_length


def frame_transform_2d(frame_idx: int, keys: KeyFrames, args: AnimArgs) -> np.ndarray:
    """The 2D step's forward map [3, 3] (float64, as the JAX package builds
    it): rotation and zoom about the centre after the pan, or with
    ``flip_2d_perspective`` the flip homography after rotation and zoom,
    the pan dropped (the ``np.matmul`` third-argument quirk, kept)."""
    angle = keys.angle_series[frame_idx]
    zoom = keys.zoom_series[frame_idx]
    pan_x = keys.pan_x_series[frame_idx]
    pan_y = keys.pan_y_series[frame_idx]

    center = (args.w // 2, args.h // 2)
    trans_mat = np.vstack([np.float32([[1, 0, pan_x], [0, 1, pan_y]]), [0, 0, 1]])
    rot_mat = np.vstack([C.rotation_matrix_2d(center, angle, zoom), [0, 0, 1]])
    if args.flip_2d_perspective:
        M, sl = warp_matrix(
            args.w, args.h,
            keys.perspective_flip_theta_series[frame_idx],
            keys.perspective_flip_phi_series[frame_idx],
            keys.perspective_flip_gamma_series[frame_idx],
            1.0,
            keys.perspective_flip_fv_series[frame_idx],
        )
        post = np.vstack([np.float32([[1, 0, (args.w - sl) / 2], [0, 1, (args.h - sl) / 2]]),
                          [0, 0, 1]])
        # the third argument is np.matmul's ``out``: the pan is overwritten
        return np.matmul(np.matmul(M, post), rot_mat, trans_mat)
    return np.matmul(rot_mat, trans_mat)


def do_2d_animation_step(img, frame_idx: int, keys: KeyFrames, args: AnimArgs) -> torch.Tensor:
    """The 2D warp of a uint8 [H, W, 3] frame (tensor or array) by
    :func:`frame_transform_2d`, on the frame's device (``utils/cv.py``
    ``warp_perspective``, bilinear, ``args.border``)."""
    img = _frame(img)
    xform = frame_transform_2d(frame_idx, keys, args)
    return C.warp_perspective(img, xform, (img.shape[1], img.shape[0]), args.border)


def _fov_project(points: np.ndarray, R: np.ndarray, T: np.ndarray, fov_deg: float):
    """Perspective projection to NDC xy: view = p @ R + T, then f x / z with
    f = 1 / tan(fov / 2) (|z| < 1e-6 taken as 1e-6)."""
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    view = points @ R + T
    z = np.where(np.abs(view[:, 2:3]) < 1e-6, 1e-6, view[:, 2:3])
    return f * view[:, :2] / z


def remap_grid_3d(frame_idx: int, keys: KeyFrames, args: AnimArgs):
    """The 3D step's source coordinates (gx, gy), float32 [h, w] each, as
    the JAX package computes them in float64: the pixels lifted to (x, y,
    depth) (depth 3 without ``args.depth_map``), projected through the
    camera and through the camera moved by the frame's translation and
    rotation, the grid shifted back by the screen-space offset."""
    TRANSLATION_SCALE = 1.0 / 200.0
    translate = np.array([
        -keys.translation_x_series[frame_idx] * TRANSLATION_SCALE,
        keys.translation_y_series[frame_idx] * TRANSLATION_SCALE,
        -keys.translation_z_series[frame_idx] * TRANSLATION_SCALE,
    ])
    rot = make_rotation_matrix([
        keys.rotation_3d_x_series[frame_idx],
        keys.rotation_3d_y_series[frame_idx],
        keys.rotation_3d_z_series[frame_idx],
    ])[:3, :3]

    h, w = args.h, args.w
    y, x = np.meshgrid(np.linspace(-1.0, 1.0, h), np.linspace(-1.0, 1.0, w), indexing="ij")
    if args.depth_map is not None:
        z = np.asarray(args.depth_map, np.float32).reshape(h, w)
    else:
        z = np.full((h, w), 3.0, np.float32)
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    xy_old = _fov_project(pts, np.eye(3), np.zeros(3), args.fov)
    xy_new = _fov_project(pts, rot, translate, args.fov)
    offset = (xy_new - xy_old).reshape(h, w, 2)

    gx = (x - offset[:, :, 0] + 1.0) * 0.5 * (w - 1)
    gy = (y - offset[:, :, 1] + 1.0) * 0.5 * (h - 1)
    return gx.astype(np.float32), gy.astype(np.float32)


def do_3d_animation_step(img, frame_idx: int, keys: KeyFrames, args: AnimArgs) -> torch.Tensor:
    """The 3D warp of a uint8 [H, W, 3] frame: ``utils/cv.py`` ``remap`` by
    :func:`remap_grid_3d`, bicubic when ``args.sampling_mode`` is "bicubic"
    (else bilinear), ``args.border``, on the frame's device."""
    img = _frame(img)
    gx, gy = remap_grid_3d(frame_idx, keys, args)
    interp = "cubic" if args.sampling_mode == "bicubic" else "linear"
    return C.remap(img, torch.from_numpy(gx).to(img.device), torch.from_numpy(gy).to(img.device),
                   interp, args.border)


def _nth(draws: Optional[Sequence], i: int):
    return None if draws is None else draws[i - 1]


def render_animation(
    bundle,
    prompt_fn: Callable[[int], object],
    cfg,
    anim_args: AnimArgs,
    n_frames: int,
    *,
    keys: Optional[KeyFrames] = None,
    coherance: float = 0.98,
    diversity: float = 0.0,
    seed: int = 0,
    warp_3d: bool = False,
    frame_callback: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
    x_T=None,
    pixel_noises: Optional[Sequence] = None,
    encode_noises: Optional[Sequence] = None,
    diversity_noises: Optional[Sequence] = None,
    latent_noises: Optional[Sequence] = None,
    device=None,
    timings: Optional[list] = None,
) -> List[np.ndarray]:
    """The frame loop; returns the uint8 [H, W, 3] frames (numpy).

    ``prompt_fn(i)`` -> a prompt with ``build_spec`` (``ComplexPrompt``,
    ...) or a ``GuidanceSpec`` for frame i. Frame 0 is ``sample_latents``
    from ``x_T`` (default: drawn). Frame i > 0: the previous frame
    colour-matched to frame 0 (:func:`match_colors`), warped in 3D (with
    ``warp_3d``) and in 2D, mapped to [-1, 1], plus pixel noise times (1 -
    ``coherance``); encoded (the posterior sampled); with ``diversity`` > 0
    mixed as (1 - diversity) z + sqrt(diversity) n; noised to the DDIM
    table's ``t_start = max(1, int((1 - denoising_strength) * steps))``
    (whatever the sampler) with x_t = sqrt(a_t) z + sqrt(1 - a_t) noise;
    ``sample_latents(x_init=x_t, t_start=t_start)``. Every frame is decoded
    (``decode_latents``).

    Draws come from ``generator`` (default: seeded from ``seed``, as the JAX
    package's ``PRNGKey(seed)``; ``cfg.seed`` is not read) on the bundle's
    device unless injected: ``x_T``, and one entry a frame after
    the first in ``pixel_noises`` ([H, W, 3]), ``encode_noises``,
    ``diversity_noises`` and ``latent_noises`` (latent-shaped). The
    diversity noise is drawn from a copy of the generator's state before
    the pixel noise (the JAX package reuses that draw's key). The warps and
    the colour match run on ``device`` (default: the bundle's).
    ``timings``: a list that gets one dict a frame of host seconds, each
    phase synchronized (warp, colour match, encode, sample, decode)."""
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.guidance import GuidanceSpec
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        decode_latents,
        encode_image,
        sample_latents,
    )

    keys = keys or KeyFrames(anim_args)
    dev = bundle.device
    warp_dev = torch.device(device) if device is not None else dev
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    frames: List[np.ndarray] = []
    init_frame = prev = None
    clock = _Clock(warp_dev if timings is not None else None)

    for i in range(n_frames):
        prompt = prompt_fn(i)
        spec = (prompt if isinstance(prompt, GuidanceSpec)
                else prompt.build_spec(cfg.height // 8, cfg.width // 8, bundle))
        t = {}
        if prev is None:
            lat = clock(t, "sample", lambda: sample_latents(bundle, spec, cfg, x_init=x_T,
                                                            generator=generator))
        else:
            img = clock(t, "match", lambda: match_colors(_frame(prev, warp_dev), init_frame))
            if warp_3d:
                img = clock(t, "warp_3d", lambda: do_3d_animation_step(img, i, keys, anim_args))
            img = clock(t, "warp_2d", lambda: do_2d_animation_step(img, i, keys, anim_args))
            x = img.to(dev, torch.float32) / 127.5 - 1.0
            state = generator.get_state()
            n = _nth(pixel_noises, i)
            if n is None:
                n = torch.randn(x.shape, generator=generator, device=dev)
            x = x + torch.as_tensor(n, dtype=torch.float32, device=dev) * (1.0 - coherance)
            z = clock(t, "encode", lambda: encode_image(bundle, x, generator=generator,
                                                        noise=_nth(encode_noises, i)))
            if diversity > 0:
                dn = _nth(diversity_noises, i)
                if dn is None:
                    g_n = torch.Generator(device=dev)
                    g_n.set_state(state)
                    dn = torch.randn(z.shape, generator=g_n, device=dev)
                z = (1 - diversity) * z + np.sqrt(diversity) * torch.as_tensor(
                    dn, dtype=torch.float32, device=dev)
            itables = S.make_inference_tables(bundle.tables, cfg.steps, eta=cfg.eta)
            t_start = max(1, int((1 - cfg.denoising_strength) * itables.num_steps))
            a_t = float(itables.alphas_cumprod_t[t_start - 1])
            noise = _nth(latent_noises, i)
            if noise is None:
                noise = torch.randn(z.shape, generator=generator, device=dev)
            x_t = np.sqrt(a_t) * z + np.sqrt(1 - a_t) * torch.as_tensor(
                noise, dtype=torch.float32, device=dev)
            lat = clock(t, "sample", lambda: sample_latents(
                bundle, spec, cfg, x_init=x_t, generator=generator, t_start=t_start))
        img = clock(t, "decode", lambda: decode_latents(bundle, lat)[0])
        if init_frame is None:
            init_frame = torch.from_numpy(img).to(warp_dev)
        prev = img
        frames.append(img)
        if timings is not None:
            timings.append(t)
        if frame_callback:
            frame_callback(i, img)
    return frames


class _Clock:
    """Times ``fn()`` into ``t[name]`` (host seconds after a synchronize of
    ``device``) when a device is given; else just calls it."""

    def __init__(self, device):
        self.device = device

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, t: dict, name: str, fn):
        if self.device is None:
            return fn()
        import time

        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        t[name] = time.perf_counter() - t0
        return out
