"""Port parity of the "Log" sampler (``samplers/loglik.py``): the fixed-grid
RK4 and the adaptive dopri5 log-likelihood estimators with JAX's Rademacher
probe passed in, the registry's adapter, and ``pipeline.sample_latents``
with ``sampler="Log"`` on the tiny bundle, against the JAX package's.

The estimators take a denoiser with a nonlinear part (so the Hutchinson
VJP is not the identity's), on the JAX side in ``jax.numpy``, on the port's
in torch; inputs come from JAX keys converted to numpy. f32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.samplers import loglik as JL
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.samplers import loglik as L
from complex_prompt_diffusion_tpu_torch.samplers import registry as R

# log-likelihoods in nats of O(1e2): sums over every element of f32 terms
# and the integrators' f32 steps, max |a - b| / max |b|
LL_TOL = 1e-5
# the tiny UNet's whole adaptive integration (dozens of CFG UNet VJPs in
# f32): against a float64 run of the port (the bundle, the spec and the
# integrator in float64, the same x_T and probe: -269.65408) JAX's f32
# estimate lies 8.7e-5 off and the port's 5.6e-5 to 1.3e-4 (by thread
# count), on either side, so two f32 estimates may differ by their sum,
# 2.2e-4 (one run measured 1.43e-4 between them)
PIPE_TOL = 3e-4


def _jden(x, s, uc):
    return x / (1.0 + s**2) + 0.05 * uc * jnp.tanh(x) * s / (1.0 + s**2)


def _pden(x, s, uc):
    s = float(s)
    return x / (1.0 + s**2) + 0.05 * uc * torch.tanh(x) * s / (1.0 + s**2)


def _x_and_probe(seed, shape):
    kx, kv = jax.random.split(jax.random.PRNGKey(seed))
    x = np.asarray(jax.random.normal(kx, shape, jnp.float32))
    return x, kv, np.asarray(jax.random.rademacher(kv, shape, jnp.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("steps,uc", [(12, 1.0), (30, 3.0)])
def test_rk4_with_jax_probe(steps, uc):
    x, key, probe = _x_and_probe(0, (2, 8, 8, 2))
    want = JL.log_likelihood(_jden, jnp.asarray(x), 0.02, 10.0, key=key, steps=steps,
                             uc_scale=uc)
    got = L.log_likelihood(_pden, torch.from_numpy(x), 0.02, 10.0, probe=probe, steps=steps,
                           uc_scale=uc)
    assert tuple(got.shape) == (2,) and not got.requires_grad
    assert _rel(got, want) <= LL_TOL


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
def test_dopri5_with_jax_probe(tol):
    """The same accepted and rejected steps (the loop's iteration count) and
    log-likelihoods within LL_TOL."""
    x, key, probe = _x_and_probe(1, (2, 8, 8, 2))
    want, n_want = JL.log_likelihood_adaptive(_jden, jnp.asarray(x), 0.02, 10.0, key=key,
                                              atol=tol, rtol=tol)
    got, n_got = L.log_likelihood_adaptive(_pden, torch.from_numpy(x), 0.02, 10.0,
                                           probe=probe, atol=tol, rtol=tol)
    assert n_got == int(n_want) and 3 < n_got < 512
    assert _rel(got, want) <= LL_TOL


def test_registry_adapter_routes_by_steps():
    """``sample_log_likelihood``: dopri5 by default, RK4 with ``steps``; the
    probe is ``noises``; the range is the positive sigmas of the schedule."""
    assert R.get_sampler("Log") == ("sigma", L.sample_log_likelihood)
    sig = JS.make_sigma_schedule("karras", 20, sigma_min=0.05, sigma_max=8.0)
    x, key, probe = _x_and_probe(2, (1, 4, 4, 2))
    for steps in (None, 10):
        want, aux = JL.sample_log_likelihood(_jden, jnp.asarray(x), sig, key=key, steps=steps)
        got, paux = L.sample_log_likelihood(_pden, torch.from_numpy(x), sig, noises=probe,
                                            steps=steps)
        assert aux is None and paux is None
        assert _rel(got, want) <= LL_TOL


def test_probe_from_a_generator():
    a = L.rademacher((3, 5), torch.Generator().manual_seed(4))
    b = L.rademacher((3, 5), torch.Generator().manual_seed(4))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert set(a.unique().tolist()) <= {-1.0, 1.0}
    x = torch.randn((1, 4, 4, 2), generator=torch.Generator().manual_seed(5))
    one = L.log_likelihood(_pden, x, 0.02, 10.0, steps=6,
                           generator=torch.Generator().manual_seed(6))
    two = L.log_likelihood(_pden, x, 0.02, 10.0, steps=6,
                           generator=torch.Generator().manual_seed(6))
    assert torch.equal(one, two)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def test_sample_latents_log_matches_jax(bundles):
    """The JAX package's ``sample_latents`` with "Log" (dopri5, CFG 7.5) on
    its drawn x_T, and the port's given that x_T and the JAX probe (the
    step key's draw) as ``noises``: log-likelihoods [B]. The port's inputs
    are the pipeline's own inference tensors."""
    jb, pb = bundles
    kw = dict(sampler="Log", width=32, height=32, steps=10, guidance_scale=7.5)
    jcfg, pcfg = JP.RenderConfig(**kw), P.RenderConfig(**kw)
    key = jax.random.PRNGKey(3)
    key_init, key_steps = jax.random.split(key)
    shape = (1, 4, 4, 4)
    sigmas = JP._sigma_schedule(jb, jcfg)
    x_T = np.asarray(jax.random.normal(key_init, shape, jnp.float32)) * np.float32(sigmas[0])
    probe = np.asarray(jax.random.rademacher(key_steps, shape, jnp.float32))
    want = JP.sample_latents(jb, JP.make_guidance_spec(jb, "a cat", "", 7.5), jcfg, key=key)
    spec = P.make_guidance_spec(pb, "a cat", "", 7.5)
    got = P.sample_latents(pb, spec, pcfg, x_init=torch.from_numpy(x_T), noises=probe)
    assert tuple(got.shape) == (1,) and not got.requires_grad
    assert _rel(got, want) <= PIPE_TOL
    # RK4 through the port's pipeline: finite, near the adaptive estimate
    rk4 = P.sample_latents(pb, spec, pcfg, x_init=torch.from_numpy(x_T), noises=probe,
                           loglik_steps=8)
    assert bool(torch.isfinite(rk4).all()) and abs(float(rk4[0] - got[0])) < 0.05 * abs(
        float(got[0]))


def test_loglik_steps_belongs_to_log(bundles):
    """``loglik_steps`` is refused for another sampler; with "Log" it runs
    the RK4 (4 denoiser evaluations a step, each shown to a step
    callback)."""
    _, pb = bundles
    spec = P.make_guidance_spec(pb, "a cat")
    with pytest.raises(ValueError, match="Log"):
        P.sample_latents(pb, spec, P.RenderConfig(width=32, height=32, steps=2),
                         loglik_steps=4)
    cfg = dataclasses.replace(P.RenderConfig(width=32, height=32, steps=4), sampler="Log")
    seen = []
    ll = P.sample_latents(pb, spec, cfg, loglik_steps=2,
                          step_callback=lambda sigma, x0: seen.append(x0.shape))
    assert tuple(ll.shape) == (1,) and bool(torch.isfinite(ll).all())
    # the step callback sees every denoiser evaluation, as in the sigma family
    assert seen == [(1, 4, 4, 4)] * 8
