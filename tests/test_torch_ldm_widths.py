"""A UNet at CompVis LDM-VQ-4's widths (224 / 448 / 672 / 896), port vs JAX.

CompVis latent-diffusion's ``configs/latent-diffusion/celebahq-ldm-vq-4.yaml``
(and ``ffhq-ldm-vq-4.yaml``, ``lsun_bedrooms-ldm-vq-4.yaml``) set the UNet's
params below: 3 channels in and out on a 64x64 latent, no context. Its
level widths and up-path concats (672, 1120, 1568 and 224 itself) are 32
mod 64: K4's and K6's Hopper bodies take them with a partly zero last
k-step. Here, on the CPU: both packages map the params to the same config
and the same ``build_plan``, K4's route sends every conv its gate admits to
a Hopper body at the smoke's batches, and at a small size (32 channels,
``channel_mult`` (1, 2, 3): 96 == 32 mod 64; a 16x16 latent) the port's f32
``unet_apply`` and a 4-step ``sample_ddim`` with injected noises agree with
the JAX package's on the same weights, carried by ``convert.unet_params``.
Inputs come from numpy seeds.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import config as JC
from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.models.unet import build_plan as jax_build_plan
from complex_prompt_diffusion_tpu.pipeline import _unzero_kernels
from complex_prompt_diffusion_tpu.samplers import ddim as JD
from complex_prompt_diffusion_tpu_torch import config as PC
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.models.layers import conv3x3_wanted
from complex_prompt_diffusion_tpu_torch.models.unet import skip_cat_fused
from complex_prompt_diffusion_tpu_torch.ops.conv import k4_body
from complex_prompt_diffusion_tpu_torch.samplers import ddim as D
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import LDM_VQ4_UNET, unet_sites

# the small size: 32 channels, three levels (32 / 64 / 96), a 16x16 latent
SMALL = dict(LDM_VQ4_UNET, model_channels=32, channel_mult=[1, 2, 3])

# f32 on both sides, sums in another order: max |a - b| / max |b|
TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_both_packages_map_the_ldm_vq4_params_alike():
    jcfg = JC.unet_config_from_yaml(LDM_VQ4_UNET)
    pcfg = PC.unet_config_from_yaml(LDM_VQ4_UNET)
    assert convert.config_from(M.UNetConfig, jcfg) == pcfg
    assert pcfg.context_dim is None and pcfg.heads_for(672) == (21, 32)
    plan = M.build_plan(pcfg)
    assert plan == jax_build_plan(jcfg)
    res = [d for block in plan[0] + (plan[1],) + plan[2] for d in block if d[0] == "res"]
    assert {d[2] for d in res} == {224, 448, 672, 896}
    assert {d[1] for d in res} - {224, 448, 672, 896} == {1120, 1344, 1568, 1792}
    assert all(c % 64 == 32 for c in (224, 672, 1120, 1568))


@pytest.mark.parametrize("ub,dtype,gated", [(2, torch.bfloat16, 28), (4, torch.bfloat16, 28),
                                            (1, torch.float32, 22), (2, torch.float32, 22)])
def test_every_gated_conv_of_the_ldm_vq4_unet_takes_a_hopper_body(ub, dtype, gated):
    """At the smoke's UNet batches, every conv of a call that K4's gate
    admits (the 32^2 and 16^2 planes: Co = 448 and 672, the fused up path's
    halves 224 .. 896 wide) runs on a Hopper body, none on the generic one,
    where the rule before took 17 (bf16, fused) and 11 (f32) of them to it."""
    cfg = PC.unet_config_from_yaml(LDM_VQ4_UNET)
    sites = unet_sites(cfg, 64, fused=skip_cat_fused(ub, dtype))
    convs = [(s, c, co) for s, c, co in sites["conv"]
             if conv3x3_wanted(torch.empty((ub, s, s, c), device="meta"), (co, c, 3, 3))]
    want = "bf16_sm90" if dtype == torch.bfloat16 else "f32_sm90"
    assert len(convs) == gated and {k4_body(dtype, c, co) for _, c, co in convs} == {want}
    bk = 64 if dtype == torch.bfloat16 else 32  # the rule before: C % bk == Co % 64 == 0
    before = sum(1 for _, c, co in convs if c % bk or co % 64)
    assert before == (17 if dtype == torch.bfloat16 else 11)
    # the 32^2 plane's Co = 448 and its up conv's 672, the 16^2 plane's 672
    # and its up conv's 896
    assert collections.Counter(co for *_, co in convs) == (
        {448: 13, 672: 14, 896: 1} if dtype == torch.bfloat16 else {448: 10, 672: 11, 896: 1})


@pytest.fixture(scope="module")
def small():
    jcfg = dataclasses.replace(JC.unet_config_from_yaml(SMALL), dtype="float32")
    key = jax.random.PRNGKey(24)
    jp = _unzero_kernels(jax.random.fold_in(key, 1), JM.init_unet(key, jcfg, commit=False))
    pcfg = convert.config_from(M.UNetConfig, jcfg)
    assert pcfg == dataclasses.replace(PC.unet_config_from_yaml(SMALL), dtype="float32")
    return jcfg, jp, pcfg, convert.unet_params(jp)


def test_small_ldm_width_unet_matches_jax(small):
    jcfg, jp, pcfg, pp = small
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    want = jax.jit(lambda p, a, b: JM.unet_apply(jcfg, p, a, b, None))(jp, x, t)
    with torch.inference_mode():
        got = M.unet_apply(pcfg, pp, torch.from_numpy(x), torch.from_numpy(t), None)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert _rel(got.numpy(), want) <= TOL


def test_small_ldm_width_ddim_matches_jax(small):
    """Four DDIM steps (eta 0.5, the noises injected on both sides) with the
    UNet as eps, unconditional."""
    jcfg, jp, pcfg, pp = small
    rng = np.random.default_rng(11)
    x_T = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    noises = rng.standard_normal((4, 2, 16, 16, 3)).astype(np.float32)
    jtab = JS.make_inference_tables(JS.make_diffusion_tables(), 4, eta=0.5)
    ptab = S.make_inference_tables(S.make_diffusion_tables(), 4, eta=0.5)
    ucs = np.ones(4, np.float32)
    def jax_eps(a, t, s, blur):  # the table's timestep, one a sample
        return JM.unet_apply(jcfg, jp, a, jnp.broadcast_to(t, a.shape[:1]), None)

    def port_eps(a, t, s, blur=None):
        return M.unet_apply(pcfg, pp, a, torch.as_tensor(t).reshape(-1).expand(a.shape[0]), None)

    want, want_traj = JD.sample_ddim(jax_eps, jnp.asarray(x_T), jtab, ucs,
                                     noises=jnp.asarray(noises))
    with torch.inference_mode():
        got, got_traj = D.sample_ddim(port_eps, torch.from_numpy(x_T), ptab, ucs, noises=noises)
    assert got_traj.shape[0] == 4 and bool(torch.isfinite(got).all())
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got_traj.numpy(), want_traj) <= TOL
