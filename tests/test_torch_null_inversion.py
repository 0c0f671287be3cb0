"""Port parity of null-text inversion (``prompts/null_inversion.py``): the
DDIM inversion loop and the per-step optimization of the unconditional
embedding, against the JAX package's, on the tiny bundle (the JAX bundle's
weights through ``ModelBundle.from_jax_bundle``), 3 DDIM steps x 2 inner
iterations as the JAX package's own test runs it (``make_inference_tables``
for 3 steps gives the table's own count). f32 on the CPU; the
conditioning and the image latent come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)
from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.prompts import null_inversion as JN
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.prompts import null_inversion as N

# f32 on both sides: the latents after a UNet call a step, max |a - b| /
# max |b|, as a render's (SLICE_RTOL of tests/test_torch_kdiff.py); the
# table, max |a - b| in units of Adam's learning rate (1e-2): each step is
# lr * m / sqrt(v) per element, a ratio of the two sides' gradients (which
# agree to ~1e-5) that grows their difference where successive gradients
# cancel (measured: 1.8e-3 lr)
LATENT_TOL, TABLE_TOL_LR, LR = 1e-4, 5e-3, 1e-2
STEPS, INNER = 3, 2


@pytest.fixture(scope="module")
def setup():
    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    rng = np.random.default_rng(0)
    cond = rng.normal(size=(1, 77, 64)).astype(np.float32)
    z0 = (0.2 * np.random.default_rng(1).normal(size=(1, 4, 4, 4))).astype(np.float32)
    return jb, pb, cond, z0


def _jax_fns(jb, cond):
    cond = jnp.asarray(cond)

    def unet(x, t, ctx):
        return JM.unet_apply(jb.unet_cfg, jb.unet_params, x,
                             jnp.broadcast_to(t, (x.shape[0],)), ctx)

    return (lambda x, t: unet(x, t, cond)), (lambda x, t, u: (unet(x, t, u), unet(x, t, cond)))


def _port_fns(pb, cond):
    cond = torch.from_numpy(cond)

    def unet(x, t, ctx):
        return M.unet_apply(pb.unet_cfg, pb.unet_params, x, t.reshape(-1).expand(x.shape[0]),
                            ctx)

    return (lambda x, t: unet(x, t, cond)), (lambda x, t, u: (unet(x, t, u), unet(x, t, cond)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_ddim_invert_loop(setup):
    jb, pb, cond, z0 = setup
    want = JN.ddim_invert_loop(_jax_fns(jb, cond)[0], jnp.asarray(z0),
                               JS.make_inference_tables(jb.tables, STEPS))
    it = S.make_inference_tables(pb.tables, STEPS)
    got = N.ddim_invert_loop(_port_fns(pb, cond)[0], torch.from_numpy(z0), it)
    assert tuple(got.shape) == (it.num_steps + 1, 1, 4, 4, 4) and torch.equal(got[0],
                                                                       torch.from_numpy(z0))
    assert _rel(got, want) <= LATENT_TOL


def test_null_text_inversion(setup):
    """x_T and the uncond table (most noisy first) against JAX's, from a
    zero uncond (inference tensors, as the pipeline hands them out); the
    table moved off its start, and lowered the mean step loss."""
    jb, pb, cond, z0 = setup
    uncond = np.zeros((1, 77, 64), np.float32)
    j_cond, j_cfg = _jax_fns(jb, cond)
    p_cond, p_cfg = _port_fns(pb, cond)
    want_x, want_u = JN.null_text_inversion(j_cond, j_cfg, jnp.asarray(z0), jnp.asarray(uncond),
                                            JS.make_inference_tables(jb.tables, STEPS),
                                            num_inner_steps=INNER)
    it = S.make_inference_tables(pb.tables, STEPS)
    with torch.inference_mode():  # the pipeline's outputs are inference tensors: taken as such
        z0_t, u0 = torch.from_numpy(z0), torch.from_numpy(uncond)
    got_x, got_u = N.null_text_inversion(p_cond, p_cfg, z0_t, u0, it, num_inner_steps=INNER)
    assert tuple(got_u.shape) == (it.num_steps, 1, 77, 64) and not got_u.requires_grad
    assert _rel(got_x, want_x) <= LATENT_TOL
    assert float(np.abs(got_u.numpy() - np.asarray(want_u)).max()) <= TABLE_TOL_LR * LR
    assert float(got_u.abs().max()) > 0
    # the CFG DDIM step from latents[idx + 1] lands nearer latents[idx] with
    # the optimized uncond than with the start, on average over the steps
    latents = N.ddim_invert_loop(p_cond, z0_t, it)
    a_t = np.asarray(it.alphas_cumprod_t, np.float32)
    a_prev = np.asarray(it.alphas_cumprod_prev_t, np.float32)

    def loss(idx, u):
        x = latents[idx + 1]
        e_u, e_c = p_cfg(x, torch.tensor(int(it.timesteps[idx])), u)
        eps = e_u + 7.5 * (e_c - e_u)
        x0 = (x - float(np.sqrt(1 - a_t[idx])) * eps) / float(np.sqrt(a_t[idx]))
        x_prev = float(np.sqrt(a_prev[idx])) * x0 + float(np.sqrt(1 - a_prev[idx])) * eps
        return float(((x_prev - latents[idx]) ** 2).mean())

    n = it.num_steps
    start = np.mean([loss(idx, u0) for idx in range(n)])
    final = np.mean([loss(n - 1 - i, got_u[i]) for i in range(n)])
    assert final < start
