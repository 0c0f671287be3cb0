"""The tiny SD-2.x-shaped bundles and tolerances that the SD-2 parity files
(``test_torch_sd2.py``, ``test_torch_sd2_sampling.py``) share: the JAX
package's random weights at tiny widths with SD 2.x's shapes, carried to
the port by ``ModelBundle.from_jax_bundle``. Module-scoped fixtures: each
file that imports them builds its own bundles once.
"""

import dataclasses

import jax
import numpy as np
import pytest

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu.prompts.tokenizer import get_tokenizer as j_tokenizer
from complex_prompt_diffusion_tpu_torch import pipeline as P

# the whole tiny slice through CLIP, UNet and VAE, f32 (as
# tests/test_torch_sampler_slice.py)
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
# the same, max |a - b| / max |b| (as PERF.md's errors): the eps renders'
# values reach ~50 (Euler starts at sigma_max), and a float64 run of the
# port puts both packages' f32 Euler samples within 4e-6 of the array's
# scale (JAX 2.9e-6, the port 4.0e-6), so two f32 results stay within
# their sum, 6.9e-6; elementwise, the port's f32 sample already misses
# rtol = atol = 1e-4 against the float64 one (by 2.4e-5 on an element
# near -13)
SLICE_SCALED_TOL = 1e-5
# f32 whole-model outputs of O(1), sums in another order (as
# tests/test_torch_models.py)
MODEL_RTOL, MODEL_ATOL = 2e-5, 2e-5
PROMPT, NEGATIVE = "a lighthouse on a cliff", "blurry"
SIDE = 12  # latent side: level-0 self-attention at S = 144, not a multiple of 128
LATENT = (2, SIDE, SIDE, 4)
PIXELS = 8 * SIDE


def _sd2_tiny_configs():
    """SD 2.x's shapes at tiny widths, in the JAX package's classes."""
    ucfg = dataclasses.replace(JU.UNetConfig.tiny(context_dim=64), model_channels=64,
                               num_heads=-1, num_head_channels=64,
                               use_linear_in_transformer=True, dtype="float32")
    ccfg = dataclasses.replace(JC.CLIPTextConfig.tiny(), activation="gelu")
    return ucfg, JV.VAEConfig.tiny(), ccfg


def _sd2_tiny_jax_bundle(parameterization: str):
    ucfg, vcfg, ccfg = _sd2_tiny_configs()
    key = jax.random.PRNGKey(3)
    unet = JP._unzero_kernels(jax.random.fold_in(key, 1), JM.init_unet(key, ucfg, commit=False))
    return JP.ModelBundle(
        version="sd2", unet_cfg=ucfg, unet_params=unet, vae_cfg=vcfg,
        vae_params=JM.init_vae(key, vcfg, commit=False), clip_cfg=ccfg,
        clip_params=JM.init_clip_text(key, ccfg, commit=False),
        tokenizer=j_tokenizer(vocab_size=ccfg.vocab_size, pad_with_eos=False),
        tables=JS.make_diffusion_tables(), parameterization=parameterization,
        clip_layer="penultimate")


@pytest.fixture(scope="module")
def v_bundles():
    jb = _sd2_tiny_jax_bundle("v")
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


@pytest.fixture(scope="module")
def eps_bundles():
    jb = _sd2_tiny_jax_bundle("eps")
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=SLICE_RTOL,
                               atol=SLICE_ATOL)


def _close_scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= SLICE_SCALED_TOL, f"max |got - want| / max |want| = {err:.3e}"
