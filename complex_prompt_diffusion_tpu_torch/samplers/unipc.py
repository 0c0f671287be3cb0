"""UniPC: the unified predictor-corrector sampler (arXiv:2302.04867).

Counterpart of ``complex_prompt_diffusion_tpu/samplers/unipc.py``: the
data-prediction (x0) form with the B(h) variants ``bh1`` (B_h = h) and
``bh2`` (B_h = expm1(h)) and the ``vary_coeff`` variant (a C-matrix inverse
a step with phi_k weights), multistep orders 1-3, the corrector (UniC)
after each predictor step except the last, ``lower_order_final``.

It uses the VP schedule of :mod:`.solver`. The time grid is fixed, so the
rho coefficients (a small linear solve a step) and every schedule scalar
are float64 host numbers; a step holds one model call and tensor
arithmetic, and the loop never reads the device.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.samplers.solver import NoiseScheduleVP, _time_steps

__all__ = ["sample_unipc"]


def _uni_coeffs(rks: List[float], hh: float, variant: str, corrector: bool):
    """The rho coefficients of a B(h) step for the lambda-ratio knots
    ``rks`` (one more for the corrector), and B_h."""
    rks = list(rks)
    if corrector:
        rks.append(1.0)
    rks_np = np.asarray(rks, np.float64)
    K = len(rks_np)
    h_phi_1 = math.expm1(hh)
    if variant == "bh1":
        B_h = hh
    elif variant == "bh2":
        B_h = h_phi_1
    else:
        raise ValueError(variant)

    R, b = [], []
    h_phi_k = h_phi_1 / hh - 1.0
    factorial_i = 1.0
    for i in range(1, K + 1):
        R.append(rks_np ** (i - 1))
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    if K == 1:
        # the reference takes rho = 0.5 for the 1x1 systems instead of
        # solving them: the order-2 predictor and the order-1 corrector
        rhos = np.asarray([0.5])
    else:
        rhos = np.linalg.solve(np.stack(R), np.asarray(b))
    return rhos, B_h


def _vary_coeffs(all_rks: List[float], hh: float):
    """The ``vary_coeff`` solve: ``all_rks`` ends with the 1.0 knot;
    returns (A_p [K-1, K-1] or None, A_c [K, K], h_phi_ks of length K+1),
    where C[i, k] = r_i^k / (k+1)!, A_p = inv(C[:-1, :-1]), A_c = inv(C)."""
    rks_np = np.asarray(all_rks, np.float64)
    K = len(rks_np)
    C = np.zeros((K, K))
    col = np.ones(K)
    for k in range(1, K + 1):
        C[:, k - 1] = col
        col = col * rks_np / (k + 1)
    A_p = np.linalg.inv(C[:-1, :-1]) if K > 1 else None
    A_c = np.linalg.inv(C)

    h_phi_ks = []
    factorial_k = 1.0
    h_phi_k = math.expm1(hh)
    for k in range(1, K + 2):
        h_phi_ks.append(h_phi_k)
        h_phi_k = h_phi_k / hh - 1.0 / factorial_k
        factorial_k *= k + 1
    return A_p, A_c, h_phi_ks


def _weighted_sum(coeffs, tensors):
    out = None
    for c, d in zip(coeffs, tensors):
        term = float(c) * d
        out = term if out is None else out + term
    return out


def sample_unipc(
    model_fn: Callable,
    x: torch.Tensor,
    noise_schedule: NoiseScheduleVP,
    steps: int = 20,
    order: int = 2,
    skip_type: str = "time_uniform",
    variant: str = "bh2",
    use_corrector: bool = True,
    lower_order_final: bool = True,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
):
    """Sample with UniPC; model_fn(x, t_continuous) -> eps, ``t_continuous``
    a host scalar. A run makes ``steps`` model calls: one at the start and
    one a step but the last (the corrector's evaluation is the next step's
    model value). Returns x."""
    ns = noise_schedule
    t_T = t_start if t_start is not None else ns.T
    t_0 = t_end if t_end is not None else 1.0 / ns.total_N
    ts = _time_steps(ns, skip_type, t_T, t_0, steps)

    def lam(t):
        return ns.lambda_np(float(t))

    def alpha(t):
        return ns.alpha_np(float(t))

    def sigma(t):
        return ns.std_np(float(t))

    def x0_of(x_in, t):
        eps = model_fn(x_in, np.float32(t))
        return (x_in - sigma(t) * eps) / alpha(t)

    def unipc_update(x_prev0, t_prev_list, model_prev_list, t, cur_order, corr):
        """One predictor (and corrector) update from t_prev_list[-1] to t."""
        t_prev_0 = t_prev_list[-1]
        m_prev_0 = model_prev_list[-1]
        lambda_prev_0 = lam(t_prev_0)
        h = lam(t) - lambda_prev_0
        hh = -h  # data-prediction mode

        rks, D1s = [], []
        for i in range(1, cur_order):
            r_i = (lam(t_prev_list[-(i + 1)]) - lambda_prev_0) / h
            rks.append(r_i)
            D1s.append((model_prev_list[-(i + 1)] - m_prev_0) / r_i)

        h_phi_1 = math.expm1(hh)
        alpha_t, sigma_t, sigma_prev = alpha(t), sigma(t), sigma(t_prev_0)
        x_t_base = (sigma_t / sigma_prev) * x_prev0 - alpha_t * h_phi_1 * m_prev_0

        if variant == "vary_coeff":
            # predictor rows of inv(C[:-1, :-1]), corrector rows of inv(C),
            # and the reference's row K-2 last element for the D1_t term
            A_p, A_c, h_phi_ks = _vary_coeffs(rks + [1.0], hh)
            K = len(rks) + 1
            x_t = x_t_base
            for k in range(K - 1):
                x_t = x_t - alpha_t * h_phi_ks[k + 1] * _weighted_sum(A_p[k][: K - 1], D1s)
            if not corr:
                return x_t, None
            m_t = x0_of(x_t, t)
            D1_t = m_t - m_prev_0
            x_t = x_t_base
            k = 0
            for k in range(K - 1):
                x_t = x_t - alpha_t * h_phi_ks[k + 1] * _weighted_sum(A_c[k][: K - 1], D1s)
            x_t = x_t - alpha_t * h_phi_ks[K] * float(A_c[k][-1]) * D1_t
            return x_t, m_t

        if rks:
            rhos_p, B_h = _uni_coeffs(rks, hh, variant, corrector=False)
            x_t = x_t_base - alpha_t * B_h * _weighted_sum(rhos_p, D1s)
        else:
            _, B_h = _uni_coeffs([1.0], hh, variant, corrector=False)
            x_t = x_t_base
        if not corr:
            return x_t, None

        # the corrector evaluates the model at the predicted point
        m_t = x0_of(x_t, t)
        rhos_c, B_h = _uni_coeffs(rks, hh, variant, corrector=True)
        D1_t = m_t - m_prev_0
        corr_res = float(rhos_c[-1]) * D1_t
        if D1s:
            corr_res = _weighted_sum(rhos_c[:-1], D1s) + corr_res
        x_t = x_t_base - alpha_t * B_h * corr_res
        return x_t, m_t

    t_prev_list = [float(ts[0])]
    model_prev_list = [x0_of(x, float(ts[0]))]
    for i in range(steps):
        t = float(ts[i + 1])
        cur_order = min(order, i + 1)
        if lower_order_final:
            cur_order = min(cur_order, steps - i)
        cur_order = max(1, min(cur_order, len(model_prev_list)))
        # no corrector on the final step, as the reference
        corr = use_corrector and i < steps - 1
        x, m_t = unipc_update(x, t_prev_list, model_prev_list, t, cur_order, corr)
        if m_t is None and i < steps - 1:
            m_t = x0_of(x, t)
        t_prev_list = (t_prev_list + [t])[-3:]
        model_prev_list = (model_prev_list + [m_t])[-3:]
    return x
