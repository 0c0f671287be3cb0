"""Port parity: PLMS and DDIM inversion, DPM-Solver (multistep,
singlestep, adaptive), UniPC, DPM Adaptive, iPNDM, blur diffusion, the step
callbacks and the sampler registry, each against the JAX function.

Every sampler runs on a closed-form model: the exact eps (or denoiser) of
a Gaussian data distribution N(mu, S^2), elementwise, with a small term in
the guidance scale so that the scale reaches the model. Inputs and injected
noises come from numpy with fixed seeds; everything is f32 on the CPU. The
adaptive integrators record the times at which they call the model, so the
accept/reject sequence is compared before the values are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.samplers import blur as JB
from complex_prompt_diffusion_tpu.samplers import callbacks as JC
from complex_prompt_diffusion_tpu.samplers import ddim as JD
from complex_prompt_diffusion_tpu.samplers import dpm_adaptive as JA
from complex_prompt_diffusion_tpu.samplers import ipndm as JI
from complex_prompt_diffusion_tpu.samplers import registry as JR
from complex_prompt_diffusion_tpu.samplers import solver as JSol
from complex_prompt_diffusion_tpu.samplers import unipc as JU
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.samplers import blur as B
from complex_prompt_diffusion_tpu_torch.samplers import callbacks as C
from complex_prompt_diffusion_tpu_torch.samplers import ddim as D
from complex_prompt_diffusion_tpu_torch.samplers import dpm_adaptive as A
from complex_prompt_diffusion_tpu_torch.samplers import ipndm as I
from complex_prompt_diffusion_tpu_torch.samplers import registry as R
from complex_prompt_diffusion_tpu_torch.samplers import solver as Sol
from complex_prompt_diffusion_tpu_torch.samplers import unipc as U
from complex_prompt_diffusion_tpu_torch.schedules import sigma as Sig

# f32 step math on both sides; numpy and XLA round log/exp/pow differently
# in the last place, and a trajectory carries that through its steps
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5
# host float64 schedules on both sides
SCHED_TOL = 1e-12
# the f32 schedule of the adaptive solver: numpy's interpolation rounds
# once from float64 where XLA's rounds each f32 operation
F32_SCHED_RTOL = 1e-6
# sigma_t and lambda_t in f32 near t = 1/N: 1 - exp(2 log alpha) cancels to
# 8.5e-4, so one f32 ulp of the exp is 7e-5 of it
F32_CANCEL_ATOL = 1e-4
# the adaptive integrators' step times: the controller carries the f32
# rounding of each step's error norm into the next step size
START_RTOL = 1e-5
# the adaptive tests' model: nonlinear enough that the embedded pair's
# difference (the error norm) is the method's error, not f32 rounding; and
# a first step long enough to be rejected
NONLIN, H_INIT = 0.05, 2.0
# XLA on the CPU flushes f32 subnormals to zero where numpy keeps them: the
# blur tables' cumulative products underflow there
SUBNORMAL_ATOL = 1e-19

SHAPE = (2, 4, 4, 4)
DATA_STD = 0.5
MU = np.random.default_rng(11).standard_normal(SHAPE[1:]).astype(np.float32) * 0.3
TABLES = S.make_diffusion_tables()
AC = TABLES.alphas_cumprod


def _close(got, want, atol_scale=None):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=TRAJ_RTOL,
                               atol=TRAJ_ATOL * max(scale, 1.0))


def _x(seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(SHAPE) * scale).astype(np.float32)


def _vp_eps(xp, x, a, s, uc):
    """The exact eps of N(MU, DATA_STD^2) under x = a x0 + s n, plus a
    small term in the guidance scale."""
    mu = xp.asarray(MU) if xp is jnp else torch.from_numpy(MU)
    tanh = jnp.tanh if xp is jnp else torch.tanh
    return s * (x - a * mu) / (a * a * DATA_STD**2 + s * s) + 0.001 * uc * tanh(x)


def _t_space_eps(xp):
    """eps_fn(x, t, uc) on the discrete trained timestep grid (t may be
    fractional: linear interpolation of alphas_cumprod)."""
    if xp is jnp:
        ac = jnp.asarray(AC, jnp.float32)

        def eps(x, t, uc, blur=None):
            t = jnp.asarray(t, jnp.float32).reshape(-1)[0]
            a2 = jnp.interp(t, jnp.arange(1000, dtype=jnp.float32), ac)
            return _vp_eps(jnp, x, jnp.sqrt(a2), jnp.sqrt(1 - a2), uc)
    else:
        def eps(x, t, uc, blur=None):
            t = float(torch.as_tensor(t).reshape(-1)[0])
            a2 = np.float32(np.interp(t, np.arange(1000), AC.astype(np.float32)))
            return _vp_eps(torch, x, float(np.sqrt(a2)), float(np.sqrt(1 - a2)), float(uc))
    return eps


def _den(xp, record=None, nonlin=0.0):
    """The exact denoiser of N(MU, DATA_STD^2) under x = x0 + sigma n,
    plus a small term in the guidance scale and a ``nonlin`` one;
    ``record`` collects sigma."""
    s2 = DATA_STD**2
    if xp is jnp:
        mu = jnp.asarray(MU)

        def den(x, sigma, uc):
            if record is not None:
                jax.debug.callback(lambda v: record.append(float(v)), sigma, ordered=True)
            return ((s2 * x + sigma**2 * mu) / (s2 + sigma**2) + 0.001 * uc * jnp.tanh(x)
                    + nonlin * uc * jnp.tanh(2 * x) * sigma / (1 + sigma))
    else:
        mu = torch.from_numpy(MU)

        def den(x, sigma, uc):
            if record is not None:
                record.append(float(sigma))
            sg, uc = float(sigma), float(uc)
            return ((s2 * x + sg**2 * mu) / (s2 + sg**2) + 0.001 * uc * torch.tanh(x)
                    + nonlin * uc * torch.tanh(2 * x) * sg / (1 + sg))
    return den


def _model_fn(xp, ns, record=None, nonlin=0.0):
    """model_fn(x, t_cont) -> the exact eps on the VP schedule ``ns``, plus
    a ``nonlin`` term."""
    if xp is jnp:
        def model(x, t):
            if record is not None:
                jax.debug.callback(lambda v: record.append(float(v)), t, ordered=True)
            return (_vp_eps(jnp, x, ns.marginal_alpha(t), ns.marginal_std(t), 7.5)
                    + nonlin * 7.5 * jnp.tanh(2 * x))
    else:
        def model(x, t):
            if record is not None:
                record.append(float(t))
            return (_vp_eps(torch, x, float(ns.marginal_alpha(t)), float(ns.marginal_std(t)), 7.5)
                    + nonlin * 7.5 * torch.tanh(2 * x))
    return model


@pytest.fixture(scope="module")
def schedules():
    return (JSol.NoiseScheduleVP("discrete", alphas_cumprod=AC),
            Sol.NoiseScheduleVP("discrete", alphas_cumprod=AC))


# --- PLMS and DDIM inversion -------------------------------------------------

@pytest.mark.parametrize("steps,eta,noised", [(6, 0.0, False), (10, 0.0, False),
                                              (8, 0.5, True)])
def test_plms_matches_jax(steps, eta, noised):
    """PLMS over the whole table: the pseudo improved Euler first step (its
    second eval at t_next) and the Adams-Bashforth orders 2-4, with eta-noise
    injected when the tables have it."""
    jit = JS.make_inference_tables(JS.make_diffusion_tables(), steps, eta=eta)
    pit = S.make_inference_tables(TABLES, steps, eta=eta)
    s = pit.num_steps
    x = _x(1)
    noises = np.random.default_rng(2).standard_normal((s,) + SHAPE).astype(np.float32)
    ucs = np.linspace(7.5, 4.0, s)
    calls = []

    def counted(x_, t, uc, blur=None):
        calls.append(int(t))
        return _t_space_eps(torch)(x_, t, uc)

    kw = dict(noises=noises) if noised else {}
    w_x, w_traj = JD.sample_plms(_t_space_eps(jnp), jnp.asarray(x), jit, ucs,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    g_x, g_traj = D.sample_plms(counted, torch.from_numpy(x), pit, ucs, **kw)
    assert len(calls) == s + 1  # the first step evaluates twice
    assert calls[:3] == [int(pit.timesteps[-1]), int(pit.timesteps[-2]), int(pit.timesteps[-2])]
    _close(g_x, w_x)
    assert tuple(g_traj.shape) == (s,) + SHAPE
    _close(g_traj, w_traj)


@pytest.mark.parametrize("t_enc", [5, 20])
def test_ddim_encode_matches_jax_and_round_trips(t_enc):
    jit = JS.make_inference_tables(JS.make_diffusion_tables(), 20, eta=0.0)
    pit = S.make_inference_tables(TABLES, 20, eta=0.0)
    x0 = _x(3, 0.5)
    ucs = np.linspace(1.0, 3.0, 20)
    want = JD.ddim_encode(_t_space_eps(jnp), jnp.asarray(x0), jit, t_enc, ucs)
    got = D.ddim_encode(_t_space_eps(torch), torch.from_numpy(x0), pit, t_enc, ucs)
    _close(got, want)
    if t_enc == 20:
        # DDIM back from the encoded noise lands near x0 (0.134 relative at
        # 20 steps: the inversion's discretization error); noise drawn
        # afresh does not
        back, _ = D.sample_ddim(_t_space_eps(torch), got, pit, ucs[::-1].copy())
        fresh, _ = D.sample_ddim(_t_space_eps(torch), torch.from_numpy(_x(4)), pit,
                                 ucs[::-1].copy())
        rel = [float((b - torch.from_numpy(x0)).norm() / np.linalg.norm(x0))
               for b in (back, fresh)]
        assert rel[0] < 0.2 < rel[1]


# --- DPM-Solver ----------------------------------------------------------------

def test_noise_schedule_vp_matches_jax(schedules):
    jns, pns = schedules
    for t in (0.001, 0.05, 0.3333, 0.7, 1.0):
        assert abs(pns.lambda_np(t) - jns.lambda_np(t)) <= SCHED_TOL
        assert abs(pns.alpha_np(t) - jns.alpha_np(t)) <= SCHED_TOL
        assert abs(pns.std_np(t) - jns.std_np(t)) <= SCHED_TOL
        lam = pns.lambda_np(t)
        assert abs(pns.inverse_lambda_np(lam) - jns.inverse_lambda_np(lam)) <= SCHED_TOL
        for name in ("marginal_log_mean_coeff", "marginal_alpha"):
            got = getattr(pns, name)(t)
            assert isinstance(got, np.float32)
            np.testing.assert_allclose(got, float(getattr(jns, name)(t)),
                                       rtol=F32_SCHED_RTOL, atol=1e-7)
        for name in ("marginal_std", "marginal_lambda"):
            got = getattr(pns, name)(t)
            assert isinstance(got, np.float32)
            np.testing.assert_allclose(got, float(getattr(jns, name)(t)),
                                       rtol=F32_SCHED_RTOL, atol=F32_CANCEL_ATOL)
        np.testing.assert_allclose(pns.inverse_lambda(np.float32(lam)),
                                   float(jns.inverse_lambda(np.float32(lam))),
                                   rtol=F32_SCHED_RTOL, atol=1e-7)
    for skip in ("time_uniform", "logSNR", "time_quadratic"):
        np.testing.assert_allclose(Sol._time_steps(pns, skip, 1.0, 0.001, 12),
                                   JSol._time_steps(jns, skip, 1.0, 0.001, 12),
                                   rtol=0, atol=SCHED_TOL)
    lin_j, lin_p = JSol.NoiseScheduleVP("linear"), Sol.NoiseScheduleVP("linear")
    for t in (0.01, 0.5, 1.0):
        assert abs(lin_p.lambda_np(t) - lin_j.lambda_np(t)) <= SCHED_TOL
        lam = lin_p.lambda_np(t)
        assert abs(lin_p.inverse_lambda_np(lam) - lin_j.inverse_lambda_np(lam)) <= SCHED_TOL
        np.testing.assert_allclose(lin_p.marginal_std(t), float(lin_j.marginal_std(t)),
                                   rtol=F32_SCHED_RTOL)
    with pytest.raises(ValueError):
        Sol.NoiseScheduleVP("cosine")
    with pytest.raises(ValueError):
        Sol.NoiseScheduleVP("discrete")


DPM_CASES = [(m, o, a, sk) for m in ("multistep", "singlestep") for o in (1, 2, 3)
             for a, sk in (("dpmsolver++", "time_uniform"), ("dpmsolver", "logSNR"))]


@pytest.mark.parametrize("method,order,algorithm,skip", DPM_CASES,
                         ids=[f"{m}-o{o}-{a}-{s}" for m, o, a, s in DPM_CASES])
def test_dpm_solver_matches_jax(schedules, method, order, algorithm, skip):
    jns, pns = schedules
    steps = 7
    x = _x(4)
    calls = []
    want = JSol.sample_dpm_solver(_model_fn(jnp, jns), jnp.asarray(x), jns, steps=steps,
                                  order=order, method=method, algorithm_type=algorithm,
                                  skip_type=skip)
    got = Sol.sample_dpm_solver(_model_fn(torch, pns, calls), torch.from_numpy(x), pns,
                                steps=steps, order=order, method=method,
                                algorithm_type=algorithm, skip_type=skip)
    assert len(calls) == steps  # one model call a step, either method
    _close(got, want)


def _iteration_starts(times, per_iter):
    assert len(times) % per_iter == 0
    return np.asarray(times[::per_iter], np.float64)


def _accepted(starts, reached_end):
    """Accepted iterations from the iteration start times: each accept moves
    the start; the last iteration is accepted when the loop reached its end."""
    return int(np.count_nonzero(np.diff(starts))) + int(reached_end)


@pytest.mark.parametrize("order,algorithm", [(2, "dpmsolver++"), (3, "dpmsolver++"),
                                             (2, "dpmsolver"), (3, "dpmsolver")])
def test_dpm_solver_adaptive_matches_jax(schedules, order, algorithm):
    """DPM-Solver-12/23: the same model times in the same order (so every
    accept/reject agrees), the same accepted count, then the same x."""
    jns, pns = schedules
    x = _x(5)
    w_times, g_times, info = [], [], {}
    want = JSol.sample_dpm_solver_adaptive(_model_fn(jnp, jns, w_times, NONLIN), jnp.asarray(x),
                                           jns, order=order, algorithm_type=algorithm,
                                           h_init=H_INIT)
    want = np.asarray(want)
    jax.effects_barrier()
    got = Sol.sample_dpm_solver_adaptive(_model_fn(torch, pns, g_times, NONLIN),
                                         torch.from_numpy(x), pns, order=order,
                                         algorithm_type=algorithm, h_init=H_INIT, info=info)
    assert len(g_times) == len(w_times) == order * info["iters"]
    assert info["iters"] < 200  # ended within t_err of t_0, not at the bound
    w_starts = _iteration_starts(w_times, order)
    assert info["accepted"] == _accepted(w_starts, True)
    assert 0 < info["accepted"] < info["iters"]  # a step was rejected
    np.testing.assert_allclose(_iteration_starts(g_times, order), w_starts, rtol=START_RTOL,
                               atol=1e-7)
    _close(got, want)
    # method="adaptive" routes there (at the default first step)
    model = _model_fn(torch, pns, nonlin=NONLIN)
    direct = Sol.sample_dpm_solver_adaptive(model, torch.from_numpy(x), pns, order=order,
                                            algorithm_type=algorithm)
    routed = Sol.sample_dpm_solver(model, torch.from_numpy(x), pns, order=order,
                                   method="adaptive", algorithm_type=algorithm)
    torch.testing.assert_close(routed, direct, rtol=0, atol=0)
    with pytest.raises(ValueError):
        Sol.sample_dpm_solver_adaptive(_model_fn(torch, pns), torch.from_numpy(x), pns, order=1)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
def test_model_wrapper_matches_jax(schedules, model_type):
    jns, pns = schedules
    x = _x(6)
    cond = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    uncond = np.random.default_rng(8).standard_normal(SHAPE).astype(np.float32)

    def model(xp):
        # classifier guidance calls the model with no condition, as JAX's does
        tanh = jnp.tanh if xp is jnp else torch.tanh
        return lambda x_, t, c: tanh(x_ * 0.3 + (0.0 if c is None else c)) * (1.0 + t / 1000.0)

    def classifier(xp):
        # a toy log-probability: its gradient in x is cos(x c) c (1 + t / 1000)
        sin = jnp.sin if xp is jnp else torch.sin
        return lambda x_, t, c: sin(x_ * c) * (1.0 + t / 1000.0)

    for guidance, scale in (("uncond", 1.0), ("classifier-free", 3.0), ("classifier", 2.0)):
        kw = dict(model_type=model_type, guidance_type=guidance, guidance_scale=scale)
        jf = JSol.model_wrapper(model(jnp), jns, condition=jnp.asarray(cond),
                                unconditional_condition=jnp.asarray(uncond),
                                classifier_fn=classifier(jnp), **kw)
        pf = Sol.model_wrapper(model(torch), pns, condition=torch.from_numpy(cond),
                               unconditional_condition=torch.from_numpy(uncond),
                               classifier_fn=classifier(torch), **kw)
        for t in (0.02, 0.5, 0.97):
            _close(pf(torch.from_numpy(x), t), jf(jnp.asarray(x), jnp.float32(t)))
    # without a classifier both packages raise the same ValueError
    for wrapper, xs in ((Sol.model_wrapper(model(torch), pns, guidance_type="classifier"),
                         torch.from_numpy(x)),
                        (JSol.model_wrapper(model(jnp), jns, guidance_type="classifier"),
                         jnp.asarray(x))):
        with pytest.raises(ValueError, match="requires classifier_fn"):
            wrapper(xs, 0.5)


# --- UniPC ---------------------------------------------------------------------

UNIPC_CASES = [(v, o) for v in ("bh1", "bh2", "vary_coeff") for o in (1, 2, 3)]


@pytest.mark.parametrize("variant,order", UNIPC_CASES,
                         ids=[f"{v}-o{o}" for v, o in UNIPC_CASES])
def test_unipc_matches_jax(schedules, variant, order):
    jns, pns = schedules
    steps = 8
    x = _x(9)
    calls = []
    want = JU.sample_unipc(_model_fn(jnp, jns), jnp.asarray(x), jns, steps=steps,
                           order=order, variant=variant, skip_type="logSNR")
    got = U.sample_unipc(_model_fn(torch, pns, calls), torch.from_numpy(x), pns, steps=steps,
                         order=order, variant=variant, skip_type="logSNR")
    assert len(calls) == steps  # one at the start, one a step but the last
    _close(got, want)


def test_unipc_coefficients_match_jax():
    for rks, hh in (([-0.7], -0.4), ([-0.5, -1.3], -0.8), ([], -0.3)):
        for variant in ("bh1", "bh2"):
            for corr in (False, True):
                if not rks and not corr:
                    continue
                got, gb = U._uni_coeffs(rks, hh, variant, corr)
                want, wb = JU._uni_coeffs(rks, hh, variant, corr)
                np.testing.assert_array_equal(got, want)
                assert gb == wb
        for a, b in zip(U._vary_coeffs(rks + [1.0], hh), JU._vary_coeffs(rks + [1.0], hh)):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- DPM Adaptive ----------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 3])
def test_dpm_adaptive_matches_jax(order):
    """eta = 0: the same sigmas in the same order (the JAX loop evaluates
    the order-3 pair's shared first stage twice; the port once), the same
    iteration and accepted counts, then the same x."""
    sigmas = Sig.make_sigma_schedule("karras", 10, sigma_min=0.03, sigma_max=14.6)
    x = _x(10, float(sigmas[0]))
    w_sig, g_sig = [], []
    w_x, w_info = JA.sample_dpm_adaptive(_den(jnp, w_sig, NONLIN), jnp.asarray(x), sigmas, 7.5,
                                         order=order, h_init=H_INIT)
    w_x = np.asarray(w_x)
    jax.effects_barrier()
    g_x, g_info = A.sample_dpm_adaptive(_den(torch, g_sig, NONLIN), torch.from_numpy(x), sigmas,
                                        7.5, order=order, h_init=H_INIT)
    iters = int(w_info["steps"])
    assert g_info["steps"] == iters and g_info["nfe"] == int(w_info["nfe"]) == order * iters
    assert len(g_sig) == order * iters  # what the JAX loop counts as its NFE
    w_starts = np.asarray(w_sig[:: 4 if order == 3 else 2])
    assert g_info["accepted"] == _accepted(-np.log(w_starts), True)
    assert g_info["accepted"] < iters  # a step was rejected
    np.testing.assert_allclose(np.asarray(g_sig[::order]), w_starts, rtol=START_RTOL)
    _close(g_x, w_x)


def _dpm_adaptive_ancestral_ref(den, x, sigmas, uc, noises, order=3, rtol=0.05, atol=0.0078,
                                h_init=0.05, accept_safety=0.81, eta=1.0, max_iters=200):
    """k-diffusion's ancestral DPM adaptive (the JAX function has no eta),
    in float64 numpy: the integral control at the default coefficients."""
    t_start, t_end = -np.log(sigmas[0]), -np.log(sigmas[-2])
    sig, t_of = (lambda t: np.exp(-t)), (lambda s: -np.log(s))

    def eps_of(x, t):
        return (x - den(x, sig(t), uc)) / sig(t)

    def solver_2(x, t, tn, eps, r1):
        h = tn - t
        s1 = t + r1 * h
        eps_r1 = eps_of(x - sig(s1) * np.expm1(r1 * h) * eps, s1)
        return x - sig(tn) * np.expm1(h) * eps - sig(tn) / (2 * r1) * np.expm1(h) * (
            eps_r1 - eps), eps_r1

    def solver_3(x, t, tn, eps, eps_r1):
        h = tn - t
        r1, r2 = 1 / 3, 2 / 3
        s2 = t + r2 * h
        u2 = (x - sig(s2) * np.expm1(r2 * h) * eps
              - sig(s2) * (r2 / r1) * (np.expm1(r2 * h) / (r2 * h) - 1) * (eps_r1 - eps))
        eps_r2 = eps_of(u2, s2)
        return (x - sig(tn) * np.expm1(h) * eps
                - sig(tn) / r2 * (np.expm1(h) / h - 1) * (eps_r2 - eps))

    x_prev, s, h, e2, steps, accepted = x, t_start, h_init, None, 0, 0
    while s < t_end - 1e-5 and steps < max_iters:
        t = min(t_end, s + h)
        su = min(sig(t), eta * (sig(t) ** 2 * (sig(s) ** 2 - sig(t) ** 2) / sig(s) ** 2) ** 0.5)
        t_ = min(t_end, t_of((sig(t) ** 2 - su**2) ** 0.5))
        su = (sig(t) ** 2 - sig(t_) ** 2) ** 0.5
        eps = eps_of(x, s)
        x_low, eps_r1 = solver_2(x, s, t_, eps, 1 / 3)
        x_high = solver_3(x, s, t_, eps, eps_r1)
        delta = np.maximum(atol, rtol * np.maximum(np.abs(x_low), np.abs(x_prev)))
        err = np.linalg.norm((x_low - x_high) / delta) / x.size**0.5
        factor = 1 + np.arctan((1 / (err + 1e-8)) ** (1 / order) - 1)
        if factor >= accept_safety:
            x_prev, x = x_low, x_high + su * noises[accepted]
            s = t
            accepted += 1
        h = h * factor
        steps += 1
    return x, steps, accepted


def test_dpm_adaptive_ancestral_with_injected_noise():
    """eta > 0 (k-diffusion's ancestral form, which the JAX function lacks):
    against the float64 loop above with the same injected noises; the same
    iteration and accepted counts first."""
    sigmas = Sig.make_sigma_schedule("karras", 10, sigma_min=0.03, sigma_max=14.6)
    x = _x(12, float(sigmas[0]))
    noises = np.random.default_rng(13).standard_normal((200,) + SHAPE).astype(np.float32)
    mu, s2 = MU.astype(np.float64), DATA_STD**2

    def den64(x_, sigma, uc):
        return ((s2 * x_ + sigma**2 * mu) / (s2 + sigma**2) + 0.001 * uc * np.tanh(x_)
                + NONLIN * uc * np.tanh(2 * x_) * sigma / (1 + sigma))

    w_x, w_steps, w_acc = _dpm_adaptive_ancestral_ref(den64, x.astype(np.float64), sigmas,
                                                      7.5, noises.astype(np.float64),
                                                      h_init=H_INIT)
    g_x, info = A.sample_dpm_adaptive(_den(torch, nonlin=NONLIN), torch.from_numpy(x), sigmas,
                                      7.5, noises=noises, eta=1.0, h_init=H_INIT)
    assert (info["steps"], info["accepted"]) == (w_steps, w_acc)
    assert w_acc < w_steps  # a step was rejected
    _close(g_x, w_x)
    # eta = 0 ignores the noises; a generator draws them when none are given
    plain, _ = A.sample_dpm_adaptive(_den(torch), torch.from_numpy(x), sigmas, 7.5)
    quiet, _ = A.sample_dpm_adaptive(_den(torch), torch.from_numpy(x), sigmas, 7.5,
                                     noises=noises)
    torch.testing.assert_close(quiet, plain, rtol=0, atol=0)
    runs = [A.sample_dpm_adaptive(_den(torch), torch.from_numpy(x), sigmas, 7.5, eta=1.0,
                                  generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


# --- iPNDM -----------------------------------------------------------------------

@pytest.mark.parametrize("steps", [3, 7, 12])
def test_ipndm_matches_jax(steps):
    np.testing.assert_array_equal(np.stack(I.ipndm_schedule(steps)),
                                  np.stack(JI.ipndm_schedule(steps)))
    x = _x(14)
    ucs = np.linspace(7.5, 5.0, steps).astype(np.float32)
    calls = []

    def counted(x_, t, uc):
        assert t.dtype == torch.float32 and tuple(t.shape) == (SHAPE[0],)
        calls.append(float(t[0]))
        return _t_space_eps(torch)(x_, t, uc)

    w_x, _ = JI.sample_ipndm(_t_space_eps(jnp), jnp.asarray(x), steps, ucs)
    g_x, none = I.sample_ipndm(counted, torch.from_numpy(x), steps, ucs)
    assert none is None and len(calls) == steps
    _close(g_x, w_x)


# --- blur diffusion -------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(noise_schedule="cosine", f_type="quadratic"),
                                dict(noise_schedule="exp", f_type="log")])
def test_blur_process_tables_and_operators_match_jax(kw):
    n, d = 12, 8
    jp, pp = JB.BlurDiffusion(n=n, resolution=d, **kw), B.BlurDiffusion(n=n, resolution=d, **kw)
    for name in ("betas", "alphas", "Bs", "Bs_bar", "Bs_bar_sqrt", "one_minus_Bs_bar",
                 "one_minus_Bs_bar_sqrt"):
        np.testing.assert_allclose(getattr(pp, name), np.asarray(getattr(jp, name)), rtol=0,
                                   atol=SUBNORMAL_ATOL)
    np.testing.assert_array_equal(pp.blur._V, np.asarray(jp.blur._V))
    rng = np.random.default_rng(15)
    x0 = rng.standard_normal((2, d, d, 3)).astype(np.float32)
    noise = rng.standard_normal((2, d, d, 3)).astype(np.float32)
    jx0, px0, jn, pn = jnp.asarray(x0), torch.from_numpy(x0), jnp.asarray(noise), \
        torch.from_numpy(noise)
    _close(pp.blur.U(pp.blur.Ut(px0)), x0)
    for i in (1, 5, n):
        _close(pp.get_mean(px0, i), jp.get_mean(jx0, i))
        _close(pp.get_std(i, pn), jp.get_std(i, jn))
        xi, eps = pp.get_x_i(px0, i, noise=pn, return_eps=True)
        assert eps is pn
        _close(xi, jp.get_mean(jx0, i) + jp.get_std(i, jn))
        _close(pp.get_score_from_eps(pn, i), jp.get_score_from_eps(jn, i))
    # the inversion only at the first step: later, dimensions whose cumulative
    # product underflowed take a 1e6 gain, which turns the f32 rounding of
    # x_i - std(eps) into O(1) (the loop test below drives it consistently)
    xi = pp.get_x_i(px0, 1, noise=pn)
    got = pp.get_x0_from_eps(xi, pn, 1)
    _close(got, jp.get_x0_from_eps(jnp.asarray(xi.numpy()), jn, 1))
    np.testing.assert_allclose(got.numpy(), x0, atol=1e-2)


def test_blur_h_functions_match_jax():
    d, c = 8, 3
    kernel = JB.gaussian_kernel_1d(5, 1.5)
    np.testing.assert_array_equal(B.gaussian_kernel_1d(5, 1.5), kernel)
    vec = np.random.default_rng(16).standard_normal((2, c * d * d)).astype(np.float32)
    for jop, pop in ((JB.SVDDeblurring(kernel, c, d), B.SVDDeblurring(kernel, c, d)),
                     (JB.Denoising(c, d), B.Denoising(c, d))):
        np.testing.assert_array_equal(pop.singulars(), np.asarray(jop.singulars()))
        for name in ("V", "Vt", "U", "Ut", "H", "Ht", "H_pinv"):
            _close(getattr(pop, name)(torch.from_numpy(vec)),
                   getattr(jop, name)(jnp.asarray(vec)))


@pytest.mark.parametrize("n", [4, 6])
def test_blur_loop_matches_a_loop_of_jax_steps(n):
    """``sample_blur`` from an injected start with injected noises, against
    the loop assembled from the JAX process's own step functions (its
    ``sample_blur`` draws both from its key). A mild blur (3 taps, sigma
    0.5, sig_max 1.5) keeps every cumulative product above 1e-5: at the
    defaults some underflow, and x0's 1e6 gain there makes any two f32
    evaluations of the loop disagree at O(1)."""
    d = 8
    kw = dict(sig_max=1.5, kernel_size=3, kernel_sigma=0.5)
    jp, pp = JB.BlurDiffusion(n=n, resolution=d, **kw), B.BlurDiffusion(n=n, resolution=d, **kw)
    assert pp.Bs_bar_sqrt[1:].min() > 1e-5
    rng = np.random.default_rng(17)
    x_T = rng.standard_normal((2, d, d, 4)).astype(np.float32)
    noises = rng.standard_normal((n, 2, d, d, 4)).astype(np.float32)

    # a linear spectral eps with weights (1 - mean_i) / std_i: then x0 is
    # about x (mean_i / max(mean_i, 1e-6) of each coefficient), where an
    # arbitrary eps would meet the 1e6 gain of the underflowed dimensions
    weights = (1 - pp.Bs_bar_sqrt) / np.maximum(pp.one_minus_Bs_bar_sqrt, 1e-6)

    def eps_model(xp):
        proc = jp if xp is jnp else pp

        def f(x, i):
            w = weights[i].reshape(1, d, d, 1)
            return proc.blur.U(proc.blur.Ut(x) * (jnp.asarray(w) if xp is jnp
                                                  else torch.from_numpy(w)))
        return f

    x = jnp.asarray(x_T)
    for step in range(n):
        i = n - step
        x0 = jp.get_x0_from_eps(x, eps_model(jnp)(x, i), i)
        x = x0 if i == 1 else jp.get_mean(x0, i - 1) + jp.get_std(i - 1, jnp.asarray(noises[step]))
    seen = []

    def counted(x_, i):
        seen.append(i)
        return eps_model(torch)(x_, i)

    got = B.sample_blur(counted, pp, x_T.shape, x_T=torch.from_numpy(x_T), noises=noises)
    assert seen == list(range(n, 0, -1))
    _close(got, x)
    # a generator draws the start and the noises; one seed gives one result
    runs = [B.sample_blur(eps_model(torch), pp, x_T.shape,
                          generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


# --- callbacks -------------------------------------------------------------------

def test_latent_preview_and_render_callback_match_jax():
    rng = np.random.default_rng(18)
    for shape in ((2, 6, 5, 4), (6, 5, 4), (1, 6, 5, 1)):
        x0 = rng.standard_normal(shape).astype(np.float32) * 3
        np.testing.assert_array_equal(C.latent_preview(x0), JC.latent_preview(x0))
    frames = [rng.standard_normal((1, 6, 6, 4)).astype(np.float32) for _ in range(7)]
    for every in (1, 3):
        pc, jc = C.make_render_callback(every=every), JC.make_render_callback(every=every)
        for k, f in enumerate(frames):
            pc(np.float32(k), f)
            jc(np.float32(k), f)
        assert pc.count == jc.count == 7 and len(pc.frames) == len(jc.frames)
        for a, b in zip(pc.frames, jc.frames):
            np.testing.assert_array_equal(a, b)
    shown = []

    def display(t, img):
        shown.append((float(t), img.shape))
        if len(shown) == 2:
            raise RuntimeError("display failed")

    cb = C.make_render_callback(display, every=2)
    for k, f in enumerate(frames):
        cb(np.float32(k), f)
    assert [t for t, _ in shown] == [0.0, 2.0, 4.0, 6.0] and cb.frames == []
    assert len(cb.errors) == 1 and isinstance(cb.errors[0], RuntimeError)


# --- registry --------------------------------------------------------------------

def test_every_jax_name_resolves_with_its_family_and_only_log_raises():
    """Every JAX name resolves to a ported function of its family; "Log",
    the last to raise, is ported now (the log-likelihood estimator)."""
    assert sorted(R.SAMPLERS) == sorted(JR.SAMPLERS)
    for name, (family, _) in JR.SAMPLERS.items():
        p_family, fn = R.get_sampler(name)
        assert p_family == family
        assert not getattr(fn, "not_ported", False), name
    from complex_prompt_diffusion_tpu_torch.samplers import loglik

    assert R.get_sampler("Log")[1] is loglik.sample_log_likelihood
    assert R.get_sampler("PLMS")[1] is D.sample_plms
    assert R.get_sampler("dpm_solver")[1] is R.get_sampler("DPM Solver")[1] \
        is Sol.sample_dpm_solver
    assert R.get_sampler("UniPC")[1] is U.sample_unipc
    assert R.get_sampler("DPM Adaptive")[1] is A.sample_dpm_adaptive
    assert R.get_sampler("iPNDM")[1] is I.sample_ipndm
    assert R.get_sampler("Blur")[1] is B.sample_blur
