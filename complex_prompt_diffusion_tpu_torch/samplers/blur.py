"""Blur (inverse-heat) diffusion: the forward blurring process and its
spectral operators.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/blur.py``: a
separable blur operator diagonalized in its eigenbasis (``Deblurring``; the
DDRM operator family ``HFunctions`` / ``Denoising`` / ``SVDDeblurring``) and
the increasing-blur forward process (``BlurDiffusion``), whose step i acts
per spectral dimension as B_i = alpha_i * D^(2 f(i)), f following a
linear / log / quadratic / cubic / quartic / triangular growth schedule.

The eigen- and singular-value decompositions and every per-step table are
float64 host numpy, computed once and kept as float32, as the JAX package
keeps them. The spectral transforms are two small matrix products a side in
torch, on the device of the tensor they are given (the matrices are moved
there once and cached).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Deblurring",
    "BlurDiffusion",
    "gaussian_kernel_1d",
    "sample_blur",
    "HFunctions",
    "SVDDeblurring",
    "Denoising",
]


def gaussian_kernel_1d(kernel_size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D gaussian taps."""
    half = (kernel_size - 1) / 2
    x = np.linspace(-half, half, kernel_size)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _conv_matrix(kernel: np.ndarray, img_dim: int) -> np.ndarray:
    """The 1-D blur as a matrix: rows are the kernel's taps, zero boundary."""
    H_small = np.zeros((img_dim, img_dim))
    ks = len(kernel)
    for i in range(img_dim):
        for j in range(i - ks // 2, i + ks // 2 + 1):
            if 0 <= j < img_dim:
                H_small[i, j] = kernel[j - i + ks // 2]
    return H_small


class _OnDevice:
    """Host float32 arrays handed out as torch tensors on the device asked
    for, moved there once."""

    def __init__(self, **arrays):
        self._host = arrays
        self._cache = {}

    def get(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._host[name], device=device)
        return self._cache[key]


class Deblurring:
    """Separable blur operator in its eigenbasis: the 1-D blur matrix,
    symmetrized and eigendecomposed on the host. U / Ut map [N, H, W, C]
    images to and from spectral coefficients."""

    def __init__(self, kernel: np.ndarray, img_dim: int):
        self.img_dim = img_dim
        H_small = _conv_matrix(kernel, img_dim)
        # symmetric by construction for symmetric kernels
        w, V = np.linalg.eigh((H_small + H_small.T) / 2.0)
        self._evals = w.astype(np.float32)  # [d]
        self._V = V.astype(np.float32)  # [d, d]
        self._dev = _OnDevice(V=self._V, Vt=np.ascontiguousarray(self._V.T))

    @property
    def singulars_2d(self) -> np.ndarray:
        """[d, d] float32 eigenvalues of the separable 2-D operator."""
        return self._evals[:, None] * self._evals[None, :]

    def Ut(self, x: torch.Tensor) -> torch.Tensor:
        """Image -> spectral coefficients. x: [N, H, W, C]."""
        Vt = self._dev.get("Vt", x.device)
        y = torch.einsum("hi,niwc->nhwc", Vt, x)
        return torch.einsum("wj,nhjc->nhwc", Vt, y)

    def U(self, coeffs: torch.Tensor) -> torch.Tensor:
        V = self._dev.get("V", coeffs.device)
        y = torch.einsum("hi,niwc->nhwc", V, coeffs)
        return torch.einsum("wj,nhjc->nhwc", V, y)


class HFunctions:
    """Generic SVD-free degradation operator (the DDRM interface).
    Subclasses implement V / Vt / U / Ut / singulars / add_zeros on flat
    [B, D] vectors; H, Ht and the pseudo-inverse derive from them."""

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self, device=None):
        raise NotImplementedError

    def add_zeros(self, vec):
        raise NotImplementedError

    def H(self, vec):
        temp = self.Vt(vec)
        s = self.singulars(vec.device)
        return self.U(s * temp[:, : s.shape[0]])

    def Ht(self, vec):
        temp = self.Ut(vec)
        s = self.singulars(vec.device)
        return self.V(self.add_zeros(s * temp[:, : s.shape[0]]))

    def H_pinv(self, vec):
        temp = self.Ut(vec)
        s = self.singulars(vec.device)
        head = temp[:, : s.shape[0]] / s
        return self.V(self.add_zeros(torch.cat([head, temp[:, s.shape[0]:]], dim=1)))


class Denoising(HFunctions):
    """The identity degradation (H = I)."""

    def __init__(self, channels: int, img_dim: int):
        self._dim = channels * img_dim * img_dim

    def V(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Vt = V
    U = V
    Ut = V
    add_zeros = V

    def singulars(self, device=None):
        return torch.ones((self._dim,), dtype=torch.float32, device=device)


class SVDDeblurring(HFunctions):
    """Separable blur with the full SVD machinery of the reference
    Deblurring: the 1-D conv matrix's SVD with a 3e-2 singular floor, the
    Kronecker 2-D singulars clipped to <= 1 and sorted descending, the
    permutation applied inside V / Vt / U / Ut, flat vectors
    [B, d^2 (permuted) x C]. The conv matrix includes the kernel's last tap
    and each singular repeats over the C channels, as in the JAX package."""

    def __init__(self, kernel: np.ndarray, channels: int, img_dim: int):
        self.img_dim = img_dim
        self.channels = channels
        U_small, s_small, _ = np.linalg.svd(_conv_matrix(kernel, img_dim))
        s_small = np.maximum(s_small, 3e-2)
        sing = np.minimum(np.outer(s_small, s_small).reshape(-1), 1.0)
        order = np.argsort(-sing, kind="stable")
        self._perm = order
        self._sing = sing[order].astype(np.float32)
        # H is symmetric: V = U
        self._U = U_small.astype(np.float32)
        self._dev = _OnDevice(
            perm=torch.as_tensor(order), U=self._U, Ut=np.ascontiguousarray(self._U.T),
            sing=np.repeat(self._sing, channels),
        )

    def _from_spectral(self, vec, name, name_t):
        """[B, d^2 (permuted) x C] -> image flat, M x M^T."""
        b = vec.shape[0]
        d, c = self.img_dim, self.channels
        M, Mt = self._dev.get(name, vec.device), self._dev.get(name_t, vec.device)
        temp = torch.zeros((b, d * d, c), dtype=vec.dtype, device=vec.device)
        temp[:, self._dev.get("perm", vec.device), :] = vec.reshape(b, d * d, c)
        img = temp.permute(0, 2, 1).reshape(b, c, d, d)
        out = torch.einsum("hi,bcij->bchj", M, img)
        out = torch.einsum("bchj,jw->bchw", out, Mt)
        return out.reshape(b, -1)

    def _to_spectral(self, vec, name, name_t):
        b = vec.shape[0]
        d, c = self.img_dim, self.channels
        M, Mt = self._dev.get(name, vec.device), self._dev.get(name_t, vec.device)
        img = vec.reshape(b, c, d, d)
        out = torch.einsum("hi,bcij->bchj", Mt, img)
        out = torch.einsum("bchj,jw->bchw", out, M)
        out = out.reshape(b, c, d * d)[:, :, self._dev.get("perm", vec.device)]
        return out.permute(0, 2, 1).reshape(b, -1)

    def V(self, vec):
        return self._from_spectral(vec, "U", "Ut")

    def Vt(self, vec):
        return self._to_spectral(vec, "U", "Ut")

    U = V
    Ut = Vt

    def singulars(self, device=None):
        # flat entry q * C + c carries s[q]
        return self._dev.get("sing", device or "cpu")

    def add_zeros(self, vec):
        return vec.reshape(vec.shape[0], -1)


def _f_schedule(f_type: str, n: int, sig: float, sig_min: float, sig_max: float):
    """Dimension-power growth schedules f(i), i = 0..n."""
    i = np.arange(n + 1, dtype=np.float64)
    f_n = (sig_max / sig) ** 2
    f_1 = (sig_min / sig) ** 2

    def linear(i):
        return (f_n - f_1) / (n - 1) * (i - 1) + f_1

    if f_type == "linear":
        return linear(i)
    if f_type == "log":
        log = lambda x: np.log(x + 1e-6) / (10 * np.log(n))  # noqa: E731
        return (f_n - f_1) / log(n) * log(i) + f_1
    if f_type == "quadratic":
        a = (f_n - f_1) / (n**2 - 1)
        return a * i**2 + (f_1 - a)
    if f_type == "cubic":
        return (f_n - f_1) / n**3 * i**3 + f_1
    if f_type == "quartic":
        return (f_n - f_1) / n**4 * i**4 + f_1
    if f_type == "triangular":
        return np.where(i < n / 2, linear(i), linear(n - i))
    raise NotImplementedError(f_type)


class BlurDiffusion:
    """The increasing-blur forward process as precomputed float32 tables:
    B_i = alpha_i * D^(2 f(i)) per spectral dimension, Bs_bar their
    cumulative product; index 0 is the identity (beta padded with 0)."""

    def __init__(
        self,
        n: int,
        resolution: int,
        beta_min: float = 1e-4,
        beta_max: float = 0.02,
        sig: float = 1.0,
        sig_min: float = 0.5,
        sig_max: float = 10.0,
        kernel_size: int = 9,
        kernel_sigma: float = 2.0,
        noise_schedule: str = "linear",
        f_type: str = "linear",
    ):
        self.n = n
        self.resolution = resolution
        self.blur = Deblurring(gaussian_kernel_1d(kernel_size, kernel_sigma), resolution)
        if noise_schedule == "linear":
            betas = np.linspace(beta_min, beta_max, n)
        elif noise_schedule == "cosine":
            from complex_prompt_diffusion_tpu_torch.schedules import beta as B

            betas = B.betas_for_alpha_bar(n)
        elif noise_schedule == "exp":
            # betas from an exponential ramp
            offset = 1e-4
            betas = offset + (beta_max - offset) * (
                np.exp(np.linspace(0, 1, n)) - 1.0
            ) / (math.e - 1.0)
        else:
            raise NotImplementedError(noise_schedule)
        betas = np.concatenate([[0.0], betas])  # index 0 = identity
        self.betas = betas.astype(np.float32)
        alphas = 1.0 - betas
        self.alphas = alphas.astype(np.float32)

        fs = _f_schedule(f_type, n, sig, sig_min, sig_max)
        D = np.asarray(self.blur.singulars_2d, np.float64).reshape(-1)  # [d*d]
        D = np.abs(D) / np.abs(D).max()  # normalized spectral decay
        Bs = alphas[:, None] * D[None, :] ** (2.0 * np.clip(fs, 0, None)[:, None])
        Bs_bar = np.concatenate(
            [np.zeros((1, Bs.shape[1])), np.cumprod(Bs[1:], axis=0)], axis=0
        )
        self.Bs = Bs.astype(np.float32)
        self.Bs_bar = Bs_bar.astype(np.float32)
        self.Bs_bar_sqrt = np.sqrt(self.Bs_bar)
        self.one_minus_Bs_bar = np.float32(1) - self.Bs_bar
        self.one_minus_Bs_bar_sqrt = np.sqrt(self.one_minus_Bs_bar)
        floor = np.float32(1e-6)
        self._dev = _OnDevice(
            mean=self.Bs_bar_sqrt, std=self.one_minus_Bs_bar_sqrt,
            inv_mean=np.float32(1) / np.maximum(self.Bs_bar_sqrt, floor),
            inv_std=np.float32(1) / np.maximum(self.one_minus_Bs_bar_sqrt, floor),
        )

    def _apply_diag(self, x, table: str, i: int):
        n, h, w, c = x.shape
        diag = self._dev.get(table, x.device)[int(i)]
        return self.blur.U(self.blur.Ut(x) * diag.reshape(1, h, w, 1))

    # the forward process -------------------------------------------------
    def get_mean(self, x0, i):
        return self._apply_diag(x0, "mean", i)

    def get_std(self, i, noise):
        return self._apply_diag(noise, "std", i)

    def get_x_i(self, x0, i, generator=None, noise=None, return_eps: bool = False):
        """Sample x_i ~ q(x_i | x_0) with ``noise``, or a draw from
        ``generator``."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        img = self.get_mean(x0, i) + self.get_std(i, noise)
        return (img, noise) if return_eps else img

    def get_x0_from_eps(self, xi, eps, i):
        """Invert the forward draw."""
        return self._apply_diag(xi - self.get_std(i, eps), "inv_mean", i)

    def get_score_from_eps(self, eps, i):
        """score = -U (1 - B_bar)^-1/2 Ut eps."""
        return -self._apply_diag(eps, "inv_std", i)


def sample_blur(
    eps_model: Callable,
    process: BlurDiffusion,
    shape: Tuple[int, ...],
    *,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noises=None,
    n_steps: Optional[int] = None,
    device=None,
):
    """The reverse blur-diffusion loop: at blur index i = n .. 1, x0 from
    the model's eps, then x_{i-1} = mean(x0, i-1) + std(i-1, noise), and x0
    itself at the last step. ``eps_model(x, i)`` takes the host index.

    The initial state is ``x_T`` if given, else a draw from ``generator``
    on ``device`` (the JAX function draws it from its key and takes no
    initial state); the step noise is ``noises[step]`` if given, else a
    draw from ``generator`` (none at the last step, which needs none)."""
    n = n_steps or process.n
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device)
    else:
        x = torch.as_tensor(x_T, dtype=torch.float32, device=device)
    if noises is not None:
        noises = torch.as_tensor(noises, dtype=torch.float32, device=x.device)
    for step in range(n):
        i = n - step
        x0 = process.get_x0_from_eps(x, eps_model(x, i), i)
        if i == 1:
            x = x0
            break
        if noises is not None:
            noise = noises[step]
        else:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
        x = process.get_mean(x0, i - 1) + process.get_std(i - 1, noise)
    return x
