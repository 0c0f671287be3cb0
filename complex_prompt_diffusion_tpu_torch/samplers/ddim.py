"""DDIM, PLMS and DDIM inversion as Python loops over the timestep grid.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/ddim.py``
(``ddim_step``, ``sample_ddim``, ``sample_plms``, ``ddim_encode``,
``_noise_source``), which runs the same loops as ``lax.scan``s. Step math:
pred_x0, dir_xt and the eta-noise of DDIM eq. 12; the loop walks index =
S-1-i like the reference sampler. PLMS takes the same step with an
Adams-Bashforth blend of the eps history; its first step is a pseudo
improved Euler step with a second eps evaluation at t_next.

RNG contract: per-step noise is either injected (``noises`` [S, ...], the
mode tests use to hold two frameworks to one trajectory) or drawn from a
``torch.Generator``; with neither, the noise term is zero.

``clip_sample`` thresholds pred_x0 with a thresholder of
``guidance/threshold.py`` and re-derives eps from the clipped x0, as the
JAX step does. The eps model takes the step's blur flag as its fourth
argument, eps_fn(x, t, uc_scale, blur_on): ``uc_blur_flags`` (host bools,
one a step), all False where none are given. With ``eps_state`` (the
DeepCache feature cache) the protocol is the JAX package's stateful one:
eps_fn(x, t, uc_scale, blur_on, i, state) -> (eps, state), ``i`` the 0-based
loop iteration, the state carried from evaluation to evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.guidance.threshold import get_thresholder
from complex_prompt_diffusion_tpu_torch.samplers.kdiff import Stateful
from complex_prompt_diffusion_tpu_torch.schedules import InferenceTables

__all__ = ["DeviceTables", "ddim_step", "sample_ddim", "sample_plms", "ddim_encode"]


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """The f32 inference tables the step math reads, on one device."""

    timesteps: torch.Tensor
    alphas_cumprod_t: torch.Tensor
    alphas_cumprod_prev_t: torch.Tensor
    sqrt_one_minus_alphas_cumprod_t: torch.Tensor
    sigmas_t: torch.Tensor

    @staticmethod
    def from_tables(it: InferenceTables, device) -> "DeviceTables":
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return DeviceTables(
            timesteps=torch.as_tensor(it.timesteps, dtype=torch.int64, device=device),
            alphas_cumprod_t=f32(it.alphas_cumprod_t),
            alphas_cumprod_prev_t=f32(it.alphas_cumprod_prev_t),
            sqrt_one_minus_alphas_cumprod_t=f32(it.sqrt_one_minus_alphas_cumprod_t),
            sigmas_t=f32(it.sigmas_t),
        )

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def _noise_source(generator: Optional[torch.Generator], noises, shape, device):
    """Return noise_at(i): injected array lookup, a generator draw, or zeros."""
    if noises is not None:
        noises = torch.as_tensor(noises, dtype=torch.float32, device=device)
        return lambda i: noises[i]
    if generator is not None:
        return lambda i: torch.randn(shape, generator=generator, device=device)
    return lambda i: torch.zeros(shape, device=device)


def ddim_step(
    x: torch.Tensor,
    e_t: torch.Tensor,
    idx: int,
    it: DeviceTables,
    noise: torch.Tensor,
    *,
    temperature: float = 1.0,
    clip_sample: Optional[str] = None,
    clip_sample_thresh: float = 90.0,
):
    """One reverse step x_t -> x_{t-1} (DDIM eq. 12). ``idx`` indexes the
    inference tables (S-1 = most noisy). Returns (x_prev, pred_x0); with
    eta=0 tables the noise term vanishes. ``clip_sample``: threshold pred_x0
    by that thresholder at ``clip_sample_thresh`` and re-derive eps from it
    (Glide-style)."""
    a_t = it.alphas_cumprod_t[idx]
    a_prev = it.alphas_cumprod_prev_t[idx]
    sqrt_1m_at = it.sqrt_one_minus_alphas_cumprod_t[idx]
    sigma_t = it.sigmas_t[idx]
    pred_x0 = (x - sqrt_1m_at * e_t) / torch.sqrt(a_t)
    if clip_sample:
        pred_x0 = get_thresholder(clip_sample)(pred_x0, clip_sample_thresh)
        e_t = (x - torch.sqrt(a_t) * pred_x0) / sqrt_1m_at
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t**2) * e_t
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise * temperature
    return x_prev, pred_x0


def sample_ddim(
    eps_fn: Callable,
    x_T: torch.Tensor,
    itables: InferenceTables,
    uc_scales,
    *,
    generator: Optional[torch.Generator] = None,
    noises=None,
    uc_blur_flags=None,
    temperature: float = 1.0,
    clip_sample: Optional[str] = None,
    clip_sample_thresh: float = 90.0,
    t_start: Optional[int] = None,
    eps_state=None,
):
    """Full reverse chain. eps_fn(x, t, uc_scale, blur_on) -> eps, blur_on
    from ``uc_blur_flags`` (host bools, one a step; all False by default).

    ``t_start``: run only the first ``t_start`` timesteps of the table, from
    table index ``t_start - 1`` down to 0 (the img2img decode path).
    ``eps_state``: the stateful protocol of the module docstring, starting
    from this state.

    Returns (x_0, pred_x0 trajectory [S_run, ...])."""
    device = x_T.device
    it = DeviceTables.from_tables(itables, device)
    s_run = it.num_steps if t_start is None else int(t_start)
    if not 1 <= s_run <= it.num_steps:
        raise ValueError(f"t_start must be in [1, {it.num_steps}], got {t_start}")
    uc_scales = torch.as_tensor(uc_scales, dtype=torch.float32, device=device)
    noise_at = _noise_source(generator, noises, x_T.shape, device)
    flags = _blur_flags(uc_blur_flags, s_run)
    eps = Stateful(eps_fn, eps_state)
    x = x_T
    traj = []
    for i in range(s_run):
        idx = s_run - 1 - i
        e_t = eps(x, it.timesteps[idx], uc_scales[i], flags[i], i)
        x, pred_x0 = ddim_step(
            x, e_t, idx, it, noise_at(i), temperature=temperature,
            clip_sample=clip_sample, clip_sample_thresh=clip_sample_thresh,
        )
        traj.append(pred_x0)
    return x, torch.stack(traj)


def _blur_flags(uc_blur_flags, n: int) -> list:
    """The steps' blur flags as host bools; ``n`` False where none are
    given."""
    if uc_blur_flags is None:
        return [False] * n
    return [bool(f) for f in np.asarray(uc_blur_flags)]


def _plms_combine(e_t, old_eps):
    """Adams-Bashforth blend of orders 2-4; ``old_eps[0]`` is the most
    recent of up to three earlier evaluations."""
    if len(old_eps) == 1:
        return (3 * e_t - old_eps[0]) / 2
    if len(old_eps) == 2:
        return (23 * e_t - 16 * old_eps[0] + 5 * old_eps[1]) / 12
    return (55 * e_t - 59 * old_eps[0] + 37 * old_eps[1] - 9 * old_eps[2]) / 24


def sample_plms(
    eps_fn: Callable,
    x_T: torch.Tensor,
    itables: InferenceTables,
    uc_scales,
    *,
    generator: Optional[torch.Generator] = None,
    noises=None,
    uc_blur_flags=None,
    temperature: float = 1.0,
    clip_sample: Optional[str] = None,
    clip_sample_thresh: float = 90.0,
    eps_state=None,
):
    """PLMS (PNDM) over the whole table. eps_fn(x, t, uc_scale, blur_on) ->
    eps, blur_on from ``uc_blur_flags`` (host bools, one a step, all False
    by default; the first step's second evaluation takes step 0's flag).
    ``eps_state``: the stateful protocol of the module docstring; the first
    step's second evaluation threads the state too, with the same ``i``.

    The first step is a pseudo improved Euler step: a DDIM step with e_t,
    a second eps evaluation at t_next, and the step again with their mean
    (so a run makes steps + 1 eps evaluations). Later steps blend e_t with
    the earlier evaluations (a list of the newest three) by Adams-Bashforth.
    Like the JAX function it takes no ``t_start``: an img2img start runs
    the whole schedule.

    Returns (x_0, pred_x0 trajectory [S, ...])."""
    device = x_T.device
    it = DeviceTables.from_tables(itables, device)
    s = it.num_steps
    uc_scales = torch.as_tensor(uc_scales, dtype=torch.float32, device=device)
    noise_at = _noise_source(generator, noises, x_T.shape, device)
    flags = _blur_flags(uc_blur_flags, s)

    def step(x, e, idx, noise):
        return ddim_step(x, e, idx, it, noise, temperature=temperature,
                         clip_sample=clip_sample, clip_sample_thresh=clip_sample_thresh)

    eps = Stateful(eps_fn, eps_state)
    x = x_T
    old_eps = []  # newest first
    traj = []
    for i in range(s):
        idx = s - 1 - i
        noise = noise_at(i)
        e_t = eps(x, it.timesteps[idx], uc_scales[i], flags[i], i)
        if not old_eps:
            x_prev_1, _ = step(x, e_t, idx, noise)
            t_next = it.timesteps[max(idx - 1, 0)]
            e_t_prime = (e_t + eps(x_prev_1, t_next, uc_scales[i], flags[i], i)) / 2
        else:
            e_t_prime = _plms_combine(e_t, old_eps)
        x, pred_x0 = step(x, e_t_prime, idx, noise)
        old_eps = [e_t] + old_eps[:2]
        traj.append(pred_x0)
    return x, torch.stack(traj)


def ddim_encode(
    eps_fn: Callable,
    x0: torch.Tensor,
    itables: InferenceTables,
    t_enc: int,
    uc_scales,
):
    """Deterministic DDIM inversion, image -> noise: ``t_enc`` forward
    steps up the table. eps_fn(x, t, uc_scale, blur_on) -> eps, never
    blurred, as in the JAX package. The step weights are host f32 scalars,
    rounded where the JAX package's f32 arrays round."""
    ac_next_t = np.asarray(itables.alphas_cumprod_t, np.float32)
    ac_t = np.asarray(itables.alphas_cumprod_prev_t, np.float32)
    ucs = np.asarray(uc_scales, np.float32)
    if not ucs.ndim:
        ucs = np.full(int(t_enc), ucs)
    timesteps = torch.as_tensor(itables.timesteps, dtype=torch.int64, device=x0.device)
    one = np.float32(1)
    x_next = x0
    for i in range(int(t_enc)):
        e_t = eps_fn(x_next, timesteps[i], float(ucs[i]), False)
        ac_next, ac = ac_next_t[i], ac_t[i]
        w_x = np.sqrt(ac_next / ac)
        w_eps = np.sqrt(ac_next) * (np.sqrt(one / ac_next - one) - np.sqrt(one / ac - one))
        x_next = float(w_x) * x_next + float(w_eps) * e_t
    return x_next
