"""DPM-Solver: the continuous-time VP solver, orders 1-3.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/solver.py``
(DPM-Solver and DPM-Solver++, arXiv:2206.00927 and arXiv:2211.01095):

  * :class:`NoiseScheduleVP` — discrete (the trained alphas_cumprod table,
    interpolated) and continuous-linear VP schedules on the host: alpha_t,
    sigma_t, lambda_t = log(alpha/sigma) and its inverse, in float64
    (``*_np``, for the fixed time grids) and in float32 rounded where the
    JAX package's on-device f32 schedule rounds (``marginal_*``, for the
    adaptive solver's data-dependent grid).
  * :func:`model_wrapper` — a framework eps-model lifted into continuous
    time, with the four model types (noise / x_start / v / score) and the
    uncond and classifier-free guidance types.
  * :func:`sample_dpm_solver` — singlestep or multistep, order 1-3,
    time_uniform / logSNR / time_quadratic grids, ``lower_order_final``,
    eps- ("dpmsolver") or x0-prediction ("dpmsolver++").
  * :func:`sample_dpm_solver_adaptive` — DPM-Solver-12/23, an embedded
    lower/higher singlestep pair under the step controller of
    arXiv:2105.14080.

Time convention: continuous t in (0, 1], discrete timestep = (t - 1/N) *
1000. Every schedule coefficient is a host scalar, so a step loop holds only
model calls and tensor arithmetic. The one device-to-host read of a loop is
the adaptive solver's error norm, once an iteration, which decides accept or
reject.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "NoiseScheduleVP",
    "model_wrapper",
    "sample_dpm_solver",
    "sample_dpm_solver_adaptive",
]

_F = np.float32


def _softplus_f32(x) -> np.float32:
    return _F(np.logaddexp(_F(x), _F(0)))


class NoiseScheduleVP:
    """VP noise schedule in continuous time, on the host."""

    def __init__(
        self,
        schedule: str = "discrete",
        alphas_cumprod: Optional[np.ndarray] = None,
        beta_0: float = 0.1,
        beta_1: float = 20.0,
    ):
        if schedule not in ("discrete", "linear"):
            raise ValueError(f"unsupported schedule {schedule!r}")
        self.schedule = schedule
        if schedule == "discrete":
            if alphas_cumprod is None:
                raise ValueError("discrete schedule requires alphas_cumprod")
            log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, np.float64))
            self.total_N = len(log_alphas)
            self.T = 1.0
            self._t_np = np.linspace(1.0 / self.total_N, 1.0, self.total_N)
            self._log_alpha_np = log_alphas
            # the f32 tables the JAX package interpolates on the device
            self._t_f32 = self._t_np.astype(_F)
            self._log_alpha_f32 = log_alphas.astype(_F)
        else:
            self.total_N = 1000
            self.T = 1.0
            self.beta_0 = beta_0
            self.beta_1 = beta_1

    # --- float32 scalars (the adaptive solver's dynamic grid) -------------
    def marginal_log_mean_coeff(self, t) -> np.float32:
        t = _F(t)
        if self.schedule == "discrete":
            return _F(np.interp(t, self._t_f32, self._log_alpha_f32))
        return _F(_F(-0.25) * t**2 * _F(self.beta_1 - self.beta_0)
                  - _F(0.5) * t * _F(self.beta_0))

    def marginal_alpha(self, t) -> np.float32:
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t) -> np.float32:
        return np.sqrt(_F(1) - np.exp(_F(2) * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t) -> np.float32:
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = _F(0.5) * np.log(_F(1) - np.exp(_F(2) * log_mean))
        return log_mean - log_std

    def inverse_lambda(self, lamb) -> np.float32:
        lamb = _F(lamb)
        if self.schedule == "discrete":
            log_alpha = _F(-0.5) * _softplus_f32(_F(-2) * lamb)
            return _F(np.interp(log_alpha, self._log_alpha_f32[::-1], self._t_f32[::-1]))
        tmp = _F(2 * (self.beta_1 - self.beta_0)) * _softplus_f32(_F(-2) * lamb)
        delta = _F(self.beta_0**2) + tmp
        return tmp / (np.sqrt(delta) + _F(self.beta_0)) / _F(self.beta_1 - self.beta_0)

    # --- float64 (static time grids) ---------------------------------------
    def log_mean_coeff_np(self, t: float) -> float:
        if self.schedule == "discrete":
            return float(np.interp(t, self._t_np, self._log_alpha_np))
        return float(-0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0)

    def alpha_np(self, t: float) -> float:
        return math.exp(self.log_mean_coeff_np(t))

    def std_np(self, t: float) -> float:
        return math.sqrt(1.0 - math.exp(2.0 * self.log_mean_coeff_np(t)))

    def lambda_np(self, t: float) -> float:
        lm = self.log_mean_coeff_np(t)
        return lm - 0.5 * math.log(1.0 - math.exp(2.0 * lm))

    def inverse_lambda_np(self, lamb: float) -> float:
        if self.schedule == "discrete":
            # log_alpha = -0.5 * softplus(-2 * lamb)
            log_alpha = -0.5 * math.log1p(math.exp(-2.0 * lamb))
            return float(np.interp(log_alpha, self._log_alpha_np[::-1], self._t_np[::-1]))
        tmp = 2.0 * (self.beta_1 - self.beta_0) * math.log1p(math.exp(-2.0 * lamb))
        delta = self.beta_0**2 + tmp
        return float(tmp / (math.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0))


def model_wrapper(
    model: Callable,
    noise_schedule: NoiseScheduleVP,
    model_type: str = "noise",
    guidance_type: str = "uncond",
    guidance_scale: float = 1.0,
    classifier_fn: Optional[Callable] = None,
    condition=None,
    unconditional_condition=None,
):
    """Continuous-time noise-prediction wrapper.

    ``model(x, t_discrete, cond)``; the returned fn maps (x, t_continuous)
    -> eps prediction with guidance applied, ``t_continuous`` a host scalar.
    Classifier guidance: eps(x, t, None) - guidance_scale * sigma_t * the
    gradient of ``classifier_fn(x, t_discrete, condition).sum()`` at x (a
    leaf copy of x; where the classifier runs the port's layers on the
    card, the gradient goes through the kernels' plain VJP rules)."""
    ns = noise_schedule

    def get_model_input_time(t_continuous):
        t = _F(t_continuous)
        if ns.schedule == "discrete":
            return (t - _F(1.0 / ns.total_N)) * _F(1000.0)
        return t * _F(1000.0)

    def noise_pred(x, t_continuous, cond):
        out = model(x, get_model_input_time(t_continuous), cond)
        if model_type == "noise":
            return out
        alpha_t = float(ns.marginal_alpha(t_continuous))
        sigma_t = float(ns.marginal_std(t_continuous))
        if model_type == "x_start":
            return (x - alpha_t * out) / sigma_t
        if model_type == "v":
            return alpha_t * out + sigma_t * x
        if model_type == "score":
            return -sigma_t * out
        raise ValueError(model_type)

    def wrapped(x, t_continuous):
        if guidance_type == "uncond":
            return noise_pred(x, t_continuous, condition)
        if guidance_type == "classifier":
            if classifier_fn is None:
                raise ValueError("classifier guidance requires classifier_fn")
            t_input = get_model_input_time(t_continuous)
            # a leaf copy of x, outside inference mode (the render loops run
            # in it), so the classifier's graph is recorded; an inference
            # tensor condition is copied out of it too (autograd may save it)
            with torch.inference_mode(False), torch.enable_grad():
                xx = x.detach().clone().requires_grad_(True)
                cond = condition
                if isinstance(cond, torch.Tensor) and cond.is_inference():
                    cond = cond.clone()
                (grad,) = torch.autograd.grad(classifier_fn(xx, t_input, cond).sum(), xx)
            eps = noise_pred(x, t_continuous, None)
            sigma_t = float(ns.marginal_std(t_continuous))
            return eps - guidance_scale * sigma_t * grad
        if guidance_type == "classifier-free":
            if guidance_scale == 1.0 or unconditional_condition is None:
                return noise_pred(x, t_continuous, condition)
            x_in = torch.cat([x, x])
            c_in = torch.cat([unconditional_condition, condition])
            eps_uncond, eps_cond = noise_pred(x_in, t_continuous, c_in).chunk(2)
            return eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        raise ValueError(guidance_type)

    return wrapped


def _time_steps(
    ns: NoiseScheduleVP, skip_type: str, t_T: float, t_0: float, n: int
) -> np.ndarray:
    """The intermediate time grid, float64."""
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, n + 1)
    if skip_type == "logSNR":
        lambdas = np.linspace(ns.lambda_np(t_T), ns.lambda_np(t_0), n + 1)
        return np.asarray([ns.inverse_lambda_np(float(l)) for l in lambdas])
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** (1.0 / 2), t_0 ** (1.0 / 2), n + 1) ** 2
    raise ValueError(skip_type)


def sample_dpm_solver(
    model_fn: Callable,
    x: torch.Tensor,
    noise_schedule: NoiseScheduleVP,
    steps: int = 20,
    order: int = 2,
    skip_type: str = "time_uniform",
    method: str = "multistep",
    algorithm_type: str = "dpmsolver++",
    lower_order_final: bool = True,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
):
    """Sample with DPM-Solver / DPM-Solver++; model_fn(x, t_continuous) ->
    eps (from :func:`model_wrapper`). Multistep makes ``steps`` model calls;
    singlestep groups the steps into jumps of ``order`` calls (the last
    jump takes the remainder); ``method="adaptive"`` runs
    :func:`sample_dpm_solver_adaptive`. Returns x."""
    ns = noise_schedule
    t_T = t_start if t_start is not None else ns.T
    t_0 = t_end if t_end is not None else 1.0 / ns.total_N
    predict_x0 = algorithm_type == "dpmsolver++"

    # the time grid is fixed: every coefficient is a float64 host scalar
    def lam(t):
        return ns.lambda_np(float(t))

    def alpha(t):
        return ns.alpha_np(float(t))

    def sigma(t):
        return ns.std_np(float(t))

    phi = math.expm1

    def first_update(x, s, t, model_s):
        # model_s is an x0 prediction in ++ mode (eval_model)
        h = lam(t) - lam(s)
        if predict_x0:
            return (sigma(t) / sigma(s)) * x - alpha(t) * phi(-h) * model_s
        return (alpha(t) / alpha(s)) * x - sigma(t) * phi(h) * model_s

    def multistep_second(x, m_prev, m_prev2, t_prev, t_prev2, t):
        h = lam(t) - lam(t_prev)
        h_0 = lam(t_prev) - lam(t_prev2)
        r0 = h_0 / h
        D1_0 = (1.0 / r0) * (m_prev - m_prev2)
        if predict_x0:
            return (
                (sigma(t) / sigma(t_prev)) * x
                - alpha(t) * phi(-h) * m_prev
                - 0.5 * alpha(t) * phi(-h) * D1_0
            )
        return (
            (alpha(t) / alpha(t_prev)) * x
            - sigma(t) * phi(h) * m_prev
            - 0.5 * sigma(t) * phi(h) * D1_0
        )

    def multistep_third(x, m1, m2, m3, t1, t2, t3, t):
        """m1 is the newest, at t1."""
        h = lam(t) - lam(t1)
        h_0 = lam(t1) - lam(t2)
        h_1 = lam(t2) - lam(t3)
        r0, r1 = h_0 / h, h_1 / h
        D1_0 = (1.0 / r0) * (m1 - m2)
        D1_1 = (1.0 / r1) * (m2 - m3)
        D1 = D1_0 + (r0 / (r0 + r1)) * (D1_0 - D1_1)
        D2 = (1.0 / (r0 + r1)) * (D1_0 - D1_1)
        if predict_x0:
            return (
                (sigma(t) / sigma(t1)) * x
                - alpha(t) * phi(-h) * m1
                + alpha(t) * (phi(-h) / h + 1.0) * D1
                - alpha(t) * ((phi(-h) + h) / h**2 - 0.5) * D2
            )
        return (
            (alpha(t) / alpha(t1)) * x
            - sigma(t) * phi(h) * m1
            - sigma(t) * (phi(h) / h - 1.0) * D1
            - sigma(t) * ((phi(h) - h) / h**2 - 0.5) * D2
        )

    def eval_model(x, t):
        eps = model_fn(x, _F(t))
        if predict_x0:
            return (x - sigma(t) * eps) / alpha(t)
        return eps

    if method == "adaptive":
        return sample_dpm_solver_adaptive(
            model_fn, x, ns, order=order, algorithm_type=algorithm_type,
            t_start=t_start, t_end=t_end,
        )

    ts = _time_steps(ns, skip_type, t_T, t_0, steps)

    if method == "singlestep" and order == 1:
        method = "multistep"

    if method == "multistep":
        # warm up at lower orders; the last steps drop to lower order when
        # lower_order_final and steps < 10
        model_cache, t_cache = [], []
        for i in range(steps):
            s, t = float(ts[i]), float(ts[i + 1])
            m = eval_model(x, s)
            if i == 0:
                model_cache, t_cache = [m], [s]
                x = first_update(x, s, t, m)
                continue
            cur_order = min(order, i + 1)
            if lower_order_final and steps < 10:
                cur_order = min(cur_order, steps - i)
            model_cache = (model_cache + [m])[-3:]
            t_cache = (t_cache + [s])[-3:]
            if cur_order >= 3 and len(model_cache) >= 3:
                x = multistep_third(x, model_cache[-1], model_cache[-2], model_cache[-3],
                                    t_cache[-1], t_cache[-2], t_cache[-3], t)
            elif cur_order >= 2 and len(model_cache) >= 2:
                x = multistep_second(x, model_cache[-1], model_cache[-2],
                                     t_cache[-1], t_cache[-2], t)
            else:
                x = first_update(x, s, t, model_cache[-1])
        return x

    if method == "singlestep":
        orders = [order] * (steps // order)
        if steps % order:
            orders.append(steps % order)
        i = 0
        for o in orders:
            s, t = float(ts[i]), float(ts[i + o])
            if o == 1:
                x = first_update(x, s, t, eval_model(x, s))
            elif o == 2:
                lam_s, lam_t = lam(s), lam(t)
                h = lam_t - lam_s
                s1 = ns.inverse_lambda_np(lam_s + 0.5 * h)
                m_s = eval_model(x, s)
                m_s1 = eval_model(first_update(x, s, s1, m_s), s1)
                if predict_x0:
                    x = (
                        (sigma(t) / sigma(s)) * x
                        - alpha(t) * phi(-h) * m_s
                        - alpha(t) * phi(-h) * (m_s1 - m_s)
                    )
                else:
                    x = (
                        (alpha(t) / alpha(s)) * x
                        - sigma(t) * phi(h) * m_s
                        - sigma(t) * phi(h) * (m_s1 - m_s)
                    )
            else:  # order 3: r1 = 1/3, r2 = 2/3
                lam_s, lam_t = lam(s), lam(t)
                h = lam_t - lam_s
                s1 = ns.inverse_lambda_np(lam_s + h / 3.0)
                s2 = ns.inverse_lambda_np(lam_s + 2.0 * h / 3.0)
                m_s = eval_model(x, s)
                m_s1 = eval_model(first_update(x, s, s1, m_s), s1)
                if predict_x0:
                    r1, r2 = 1.0 / 3.0, 2.0 / 3.0
                    phi_22 = phi(-r2 * h) / (r2 * h) + 1.0
                    phi_2 = phi(-h) / h + 1.0
                    x_s2 = (
                        (sigma(s2) / sigma(s)) * x
                        - alpha(s2) * phi(-r2 * h) * m_s
                        + (r2 / r1) * alpha(s2) * phi_22 * (m_s1 - m_s)
                    )
                    m_s2 = eval_model(x_s2, s2)
                    x = (
                        (sigma(t) / sigma(s)) * x
                        - alpha(t) * phi(-h) * m_s
                        + (1.0 / r2) * alpha(t) * phi_2 * (m_s2 - m_s)
                    )
                else:
                    r1 = 1.0 / 3.0
                    x_s2 = (
                        (alpha(s2) / alpha(s)) * x
                        - sigma(s2) * phi((2.0 / 3.0) * h) * m_s
                        - (2.0 / (3.0 * r1)) * sigma(s2) * (
                            phi((2.0 / 3.0) * h) / ((2.0 / 3.0) * h) - 1.0
                        ) * (m_s1 - m_s)
                    )
                    m_s2 = eval_model(x_s2, s2)
                    x = (
                        (alpha(t) / alpha(s)) * x
                        - sigma(t) * phi(h) * m_s
                        - (3.0 / 2.0) * sigma(t) * (phi(h) / h - 1.0) * (m_s2 - m_s)
                    )
            i += o
        return x

    raise ValueError(method)


def sample_dpm_solver_adaptive(
    model_fn: Callable,
    x: torch.Tensor,
    noise_schedule: NoiseScheduleVP,
    order: int = 2,
    algorithm_type: str = "dpmsolver++",
    h_init: float = 0.05,
    atol: float = 0.0078,
    rtol: float = 0.05,
    theta: float = 0.9,
    t_err: float = 1e-5,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    max_iters: int = 200,
    info: Optional[dict] = None,
):
    """Adaptive step-size DPM-Solver ("DPM-Solver-12/23"): an embedded
    lower/higher singlestep pair (orders 1/2 or 2/3) and the
    Jolicoeur-Martineau step controller (arXiv:2105.14080).

    The time grid depends on the data, so the schedule is evaluated on the
    host in f32 as the JAX package evaluates it on the device. Each
    iteration makes ``order`` model calls and reads ONE scalar to the host,
    the error norm (the per-sample RMS of the scaled difference, its max
    over the batch), which decides accept or reject and the next step size.
    The loop ends within ``t_err`` of ``t_end`` or after ``max_iters``
    iterations, the JAX package's bound. ``info``, when given, receives
    ``iters`` and ``accepted``. Returns x."""
    if order not in (2, 3):
        raise ValueError(f"adaptive solver requires order 2 or 3, got {order}")
    ns = noise_schedule
    predict_x0 = algorithm_type == "dpmsolver++"
    t_T = ns.T if t_start is None else t_start
    t_0 = _F(1.0 / ns.total_N if t_end is None else t_end)
    one = _F(1)

    la, alpha, std, lam = (ns.marginal_log_mean_coeff, ns.marginal_alpha,
                           ns.marginal_std, ns.marginal_lambda)

    def eval_m(x_in, t):
        eps = model_fn(x_in, t)
        if predict_x0:
            return (x_in - float(std(t)) * eps) / float(alpha(t))
        return eps

    def first_update(x_in, s, t, m_s):
        h = lam(t) - lam(s)
        if predict_x0:
            return float(std(t) / std(s)) * x_in - float(alpha(t) * np.expm1(-h)) * m_s
        return float(np.exp(la(t) - la(s))) * x_in - float(std(t) * np.expm1(h)) * m_s

    def second_update(x_in, s, t, r1, m_s):
        """The singlestep second-order update; returns (x_t, model_s1)."""
        lam_s = lam(s)
        h = lam(t) - lam_s
        c = _F(0.5 / r1)
        r1 = _F(r1)
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        if predict_x0:
            phi_11, phi_1 = np.expm1(-r1 * h), np.expm1(-h)
            x_s1 = float(std(s1) / std(s)) * x_in - float(alpha(s1) * phi_11) * m_s
            m_s1 = eval_m(x_s1, s1)
            x_t = (float(std(t) / std(s)) * x_in - float(alpha(t) * phi_1) * m_s
                   - float(c * alpha(t) * phi_1) * (m_s1 - m_s))
        else:
            phi_11, phi_1 = np.expm1(r1 * h), np.expm1(h)
            x_s1 = float(np.exp(la(s1) - la(s))) * x_in - float(std(s1) * phi_11) * m_s
            m_s1 = eval_m(x_s1, s1)
            x_t = (float(np.exp(la(t) - la(s))) * x_in - float(std(t) * phi_1) * m_s
                   - float(c * std(t) * phi_1) * (m_s1 - m_s))
        return x_t, m_s1

    def third_update(x_in, s, t, r1, r2, m_s, m_s1):
        """The singlestep third-order update, model_s and model_s1 reused."""
        lam_s = lam(s)
        h = lam(t) - lam_s
        c21, c2 = _F(r2 / r1), _F(1.0 / r2)
        r2 = _F(r2)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        if predict_x0:
            phi_12, phi_1 = np.expm1(-r2 * h), np.expm1(-h)
            phi_22 = np.expm1(-r2 * h) / (r2 * h) + one
            phi_2 = phi_1 / h + one
            x_s2 = (float(std(s2) / std(s)) * x_in - float(alpha(s2) * phi_12) * m_s
                    + float(c21 * alpha(s2) * phi_22) * (m_s1 - m_s))
            m_s2 = eval_m(x_s2, s2)
            return (float(std(t) / std(s)) * x_in - float(alpha(t) * phi_1) * m_s
                    + float(c2 * alpha(t) * phi_2) * (m_s2 - m_s))
        phi_12, phi_1 = np.expm1(r2 * h), np.expm1(h)
        phi_22 = np.expm1(r2 * h) / (r2 * h) - one
        phi_2 = phi_1 / h - one
        x_s2 = (float(np.exp(la(s2) - la(s))) * x_in - float(std(s2) * phi_12) * m_s
                - float(c21 * std(s2) * phi_22) * (m_s1 - m_s))
        m_s2 = eval_m(x_s2, s2)
        return (float(np.exp(la(t) - la(s))) * x_in - float(std(t) * phi_1) * m_s
                - float(c2 * std(t) * phi_2) * (m_s2 - m_s))

    lambda_0 = lam(t_0)
    x_prev = x
    s, h = _F(t_T), _F(h_init)
    iters = accepted = 0
    while abs(s - t_0) > _F(t_err) and iters < max_iters:
        t = ns.inverse_lambda(lam(s) + h)
        m_s = eval_m(x, s)
        if order == 2:
            x_lower = first_update(x, s, t, m_s)
            x_higher, _ = second_update(x, s, t, 0.5, m_s)
        else:
            x_lower, m_s1 = second_update(x, s, t, 1.0 / 3.0, m_s)
            x_higher = third_update(x, s, t, 1.0 / 3.0, 2.0 / 3.0, m_s, m_s1)
        delta = torch.clamp(rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol)
        err = ((x_higher - x_lower) / delta).reshape(x.shape[0], -1)
        # the loop's one host read: accept or reject
        E = _F(err.square().mean(dim=-1).sqrt().max().item())
        if E <= one:
            x, x_prev, s = x_higher, x_lower, t
            accepted += 1
        h = np.minimum(_F(theta) * h * E ** _F(-1.0 / order), lambda_0 - lam(s))
        iters += 1
    if info is not None:
        info.update(iters=iters, accepted=accepted)
    return x
