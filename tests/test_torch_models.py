"""Port parity: layers, CLIP text tower, UNet and VAE decoder vs JAX.

The JAX package's tiny configs (``ModelBundle.random("tiny")``) supply the
weights, which go through ``convert.py`` into the port; inputs come from
one numpy seed. Everything is f32 on the CPU, so the port's kernel
wrappers run their plain twins.
"""

import jax
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu.models import layers as JL
from complex_prompt_diffusion_tpu.pipeline import ModelBundle as JaxBundle
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.models import layers as L

# f32 on both sides; sums run in another order (conv algorithms, matmul
# blocking), so whole-model outputs of O(1) agree to ~1e-5
MODEL_RTOL, MODEL_ATOL = 2e-5, 2e-5
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def jax_bundle():
    return JaxBundle.random("tiny", seed=0)


def _np(a):
    return np.asarray(a, np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize(
    "k,stride,padding", [(3, 1, None), (3, 2, None), (1, 1, None), (3, 2, 0)]
)
def test_conv2d(k, stride, padding):
    rng = _rng(k * 10 + stride)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    p = JL.init_conv(rng, 6, 5, k)
    p["bias"] = rng.standard_normal(5).astype(np.float32)
    want = JL.conv2d(p, x, stride=stride, padding=padding)
    got = L.conv2d(convert.to_port(p), torch.from_numpy(x), stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=LAYER_RTOL, atol=LAYER_ATOL)


def test_linear_layer_norm_and_activations():
    rng = _rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    p = JL.init_linear(rng, 16, 24)
    p["bias"] = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        L.linear(convert.to_port(p), torch.from_numpy(x)).numpy(), _np(JL.linear(p, x)),
        rtol=LAYER_RTOL, atol=LAYER_ATOL,
    )
    ln = {"scale": rng.standard_normal(16).astype(np.float32),
          "bias": rng.standard_normal(16).astype(np.float32)}
    np.testing.assert_allclose(
        L.layer_norm(convert.to_port(ln), torch.from_numpy(x + 3.0)).numpy(),
        _np(JL.layer_norm(ln, x + 3.0)), rtol=LAYER_RTOL, atol=LAYER_ATOL,
    )
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(L.silu(xt).numpy(), _np(JL.silu(x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(L.gelu(xt).numpy(), _np(JL.gelu(x)), rtol=1e-6, atol=1e-6)


def test_timestep_embedding_resampling():
    t = np.array([0, 1, 501, 999], np.int32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            L.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            _np(JL.timestep_embedding(t, dim)), rtol=1e-5, atol=1e-5,
        )
    x = _rng(2).standard_normal((2, 4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        L.upsample_nearest2x(torch.from_numpy(x)).numpy(), _np(JL.upsample_nearest2x(x))
    )
    np.testing.assert_allclose(
        L.avg_pool2x(torch.from_numpy(x)).numpy(), _np(JL.avg_pool2x(x)), rtol=1e-6, atol=1e-6
    )


def test_clip_text_apply(jax_bundle):
    cfg = jax_bundle.clip_cfg
    tokens = _rng(3).integers(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    want = JM.clip_text_apply(cfg, jax_bundle.clip_params, tokens)
    got = M.clip_text_apply(
        convert.config_from(M.CLIPTextConfig, cfg),
        convert.clip_params(jax_bundle.clip_params),
        torch.from_numpy(tokens),
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 77, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


def _unet_inputs(cfg, seed, n=2, hw=8):
    rng = _rng(seed)
    x = rng.standard_normal((n, hw, hw, cfg.in_channels)).astype(np.float32)
    t = np.array([981, 21][:n], np.int32)
    ctx = rng.standard_normal((n, 77, cfg.context_dim)).astype(np.float32)
    return x, t, ctx


@pytest.mark.parametrize("hoisted_kv", [False, True])
def test_unet_apply(jax_bundle, hoisted_kv):
    jcfg, jp = jax_bundle.unet_cfg, jax_bundle.unet_params
    x, t, ctx = _unet_inputs(jcfg, seed=4)
    jkv = JM.precompute_cross_kv(jcfg, jp, ctx) if hoisted_kv else None
    want = jax.jit(
        lambda p, a, b, c, kv: JM.unet_apply(jcfg, p, a, b, c, cross_kv=kv)
    )(jp, x, t, ctx, jkv)

    cfg = convert.config_from(M.UNetConfig, jcfg)
    params = convert.unet_params(jp)
    tx, tt, tctx = map(torch.from_numpy, (x, t, ctx))
    kv = M.precompute_cross_kv(cfg, params, tctx) if hoisted_kv else None
    got = M.unet_apply(cfg, params, tx, tt, tctx, cross_kv=kv)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_unet_sd2_style_config_branches():
    """Linear proj_in/out, head-channel heads, scale-shift norm and class
    conditioning: the config branches the tiny SD-1 config does not take."""
    import dataclasses

    from complex_prompt_diffusion_tpu.pipeline import _unzero_kernels

    jcfg = dataclasses.replace(
        JM.UNetConfig.tiny(context_dim=48), dtype="float32", num_heads=-1,
        num_head_channels=16, use_linear_in_transformer=True,
        use_scale_shift_norm=True, num_classes=10,
    )
    key = jax.random.PRNGKey(3)
    jp = _unzero_kernels(jax.random.fold_in(key, 1), JM.init_unet(key, jcfg, commit=False))
    x, t, ctx = _unet_inputs(jcfg, seed=7)
    y = np.array([3, 7], np.int32)
    want = jax.jit(lambda p, a, b, c, d: JM.unet_apply(jcfg, p, a, b, c, d))(jp, x, t, ctx, y)
    got = M.unet_apply(
        convert.config_from(M.UNetConfig, jcfg), convert.unet_params(jp),
        *map(torch.from_numpy, (x, t, ctx)), y=torch.from_numpy(y).long(),
    )
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_unet_unported_options_raise(jax_bundle):
    """The options this test once pinned as raising are ported and held to
    the JAX package: ``return_skips`` (one skip an output block, after the
    output); a hypernetwork at a cross-attention site (a k-slot module the
    JAX package's ``attach_hypernetwork`` shape, the output within the
    model tolerance of the JAX UNet's with the same module); a CLIP layer
    name other than the four known ones encodes as "last" in both
    packages."""
    cfg = convert.config_from(M.UNetConfig, jax_bundle.unet_cfg)
    jp = jax.tree_util.tree_map(np.asarray, jax_bundle.unet_params)
    params = convert.unet_params(jp)
    xn, tn, cn = _unet_inputs(jax_bundle.unet_cfg, seed=5, n=1)
    x, t, ctx = map(torch.from_numpy, (xn, tn, cn))
    out, skips = M.unet_apply(cfg, params, x, t, ctx, return_skips=True)
    assert len(skips) == len(M.build_plan(cfg)[2])
    torch.testing.assert_close(out, M.unet_apply(cfg, params, x, t, ctx), rtol=0, atol=0)
    rng = _rng(6)
    d = jax_bundle.unet_cfg.context_dim
    hyper = {"linear1": {"kernel": rng.standard_normal((d, 8)).astype(np.float32) * 0.3,
                         "bias": np.zeros(8, np.float32)},
             "linear2": {"kernel": rng.standard_normal((8, d)).astype(np.float32) * 0.3,
                         "bias": np.zeros(d, np.float32)},
             "multiplier": 1.0}
    jp["input_blocks"][1][1]["blocks"][0]["attn2"]["hyper_k"] = hyper
    want = jax.jit(lambda p, *a: JM.unet_apply(jax_bundle.unet_cfg, p, *a))(jp, xn, tn, cn)
    got = M.unet_apply(cfg, convert.unet_params(jp), x, t, ctx)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert float((got - out).abs().max()) > 1e-4
    ccfg = convert.config_from(M.CLIPTextConfig, jax_bundle.clip_cfg)
    tokens = _rng(7).integers(0, ccfg.vocab_size, (1, 77)).astype(np.int32)
    pclip = convert.clip_params(jax_bundle.clip_params)
    got = M.clip_text_apply(ccfg, pclip, torch.from_numpy(tokens), layer="hidden3")
    torch.testing.assert_close(got, M.clip_text_apply(ccfg, pclip, torch.from_numpy(tokens)),
                               rtol=0, atol=0)
    want = JM.clip_text_apply(jax_bundle.clip_cfg, jax_bundle.clip_params, tokens,
                              layer="hidden3")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_vae_decode(jax_bundle):
    jcfg, jp = jax_bundle.vae_cfg, jax_bundle.vae_params
    # 12x12 latent: the mid-block attention has S = 144 > 128, so the port
    # takes its K1 wrapper (plain twin on CPU) there
    z = _rng(6).standard_normal((1, 12, 12, jcfg.z_channels)).astype(np.float32)
    want = jax.jit(lambda p, a: JM.vae_decode(jcfg, p, a))(jp, z)
    got = M.vae_decode(
        convert.config_from(M.VAEConfig, jcfg), convert.vae_params(jp), torch.from_numpy(z)
    )
    assert tuple(got.shape) == (1, 24, 24, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_port_random_init_mirrors_jax_distributions():
    """ModelBundle.random builds the same tree (keys, shapes) as the JAX
    package's init, with the zero-init output convs filled with noise."""
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle

    port = ModelBundle.random("tiny", seed=0, device="cpu")
    jb = JaxBundle.random("tiny", seed=0)
    want = convert.unet_params(jb.unet_params)
    flat_p = jax.tree_util.tree_flatten_with_path(port.unet_params)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_p] == [k for k, _ in flat_w]
    for (path, a), (_, b) in zip(flat_p, flat_w):
        assert a.shape == b.shape, path
        if a.ndim >= 2:
            assert bool(a.any()), path
            assert abs(float(a.std()) - float(b.std())) < 0.5 * float(b.std()) + 1e-3, path
    vae_keys = jax.tree_util.tree_structure(convert.vae_params(jb.vae_params))
    assert jax.tree_util.tree_structure(port.vae_params) == vae_keys
