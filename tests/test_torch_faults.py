"""Five places where the port once departed from the JAX package without a
word, each held here on the CPU:

  * the kernels' CUDA outputs carry no ``grad_fn``: the seven dispatch
    entries differentiate through ``_build.kernel_with_plain_vjp`` (the
    kernel forward, the plain twin's VJP backward, as the JAX package's
    ``custom_vjp`` rules), and every body and probe refuses autograd when
    called directly, while the plain twins that CPU tensors take stay
    differentiable;
  * a bundle converted from the JAX package keeps its ``parameterization``
    and ``clip_layer``, so a v-model samples as one (an unknown
    parameterization is refused) instead of being sampled as eps;
  * a bundle converted from the JAX package keeps its diffusion tables
    (a YAML's ``linear_start`` / ``linear_end``), so it samples under the
    same betas;
  * ``convert.config_from`` raises on a field it would drop and maps
    ``use_pallas="cm"`` to ``attn_route="cm"``;
  * ``encode_image`` rescales on ``max > 2`` after the cast to f32, as the
    JAX package does, so a dark uint8 image encodes alike in both.
"""

import ast
import dataclasses
import importlib
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import config as JCONF
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu_torch import _build, convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.ops import conv as C
from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G
from complex_prompt_diffusion_tpu_torch.ops import mlp as F2
from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA
from complex_prompt_diffusion_tpu_torch.ops.probes import groupnorm as PG
from complex_prompt_diffusion_tpu_torch.ops.probes import stream as PS
from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as PW

# ops/__init__ re-exports the function ``attention``, so the module is imported by name
A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")

# f32 whole-model outputs of O(1), as in test_torch_vae_img2img.py: sums run
# in another order, ~1e-5
F32_RTOL, F32_ATOL = 5e-5, 5e-5


# ---- autograd ----

def test_refuse_grad_raises_under_grad_and_lets_the_rest_through():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward rule.*dispatch entry"):
        _build.refuse_grad("K0", y, x)
    _build.refuse_grad("K0", y, None, 3)  # nothing requires grad
    with torch.no_grad():
        _build.refuse_grad("K0", x)
    with torch.inference_mode():
        _build.refuse_grad("K0", x)


# every wrapper that launches a kernel for CUDA tensors, with the name of its
# library call; the seven dispatch entries, with their call of the helper that
# makes the kernel differentiable
_VJP = "_build.kernel_with_plain_vjp("
_LAUNCHERS = [
    (A._launch, "fn("),
    (A.attention_dmajor, _VJP),
    (A.attention_dmajor_prior, "_build.kernel_library()"),
    (F2.geglu_ff, _VJP),
    (F2.geglu_ff_f32_sm90, "_build.kernel_library()"),
    (G.group_norm_nhwc, _VJP),
    (G.group_norm_silu_cat, _VJP),
    (G.group_norm_prior, "_build.kernel_library()"),
    (A._attention_bf16_wide_sm90, "_build.kernel_library()"),
    (C.conv3x3_generic, "_build.kernel_library()"),
    (C.conv3x3_narrow, "_build.kernel_library()"),
    (C.conv3x3_sm90, "_build.kernel_library()"),
    (C.conv3x3_f32_sm90, "_build.kernel_library()"),
    (PW.wino3x3, _VJP),
    (PW.wino3x3_sm90, "_build.kernel_library()"),
    (PW.wino3x3_f32_sm90, "_build.kernel_library()"),
    (PW.wino3x3_prior, "_build.kernel_library()"),
    (PA.attention_probe, "_build.kernel_library()"),
    (PA.attention_probe_prior, "_build.kernel_library()"),
    (PA.attention_dmajor_scores, "_build.kernel_library()"),
    (PA.attention_dmajor_scores_prior, "_build.kernel_library()"),
    (PG.group_norm_probe, "_build.kernel_library()"),
    (PG.group_norm_probe_prior, "_build.kernel_library()"),
    (PS.stream_copy, "_build.kernel_library()"),
    (PS.stream_copy_prior, "_build.kernel_library()"),
    (A.flash_attention, _VJP),
    (C.conv3x3, _VJP),
    (A._attention_f32_sm90, "_build.kernel_library()"),
    (A._attention_dmajor_sm90, "_build.kernel_library()"),
    (F2.geglu_ff_bf16_sm90, "_build.kernel_library()"),
    (G._group_norm_sm90, "_build.kernel_library()"),
    (G._group_norm_cat_sm90, "_build.kernel_library()"),
    (PW._wino3x3_cuda, "_build.kernel_library()"),
]


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == name]


@pytest.mark.parametrize("fn,launch", _LAUNCHERS, ids=lambda v: getattr(v, "__name__", ""))
def test_every_kernel_wrapper_refuses_grad_before_it_launches(fn, launch):
    """No CPU run can reach the CUDA branch, so the wrapper's source is read.
    A body or probe calls ``_build.refuse_grad``, and before the kernel
    library. A dispatch entry (K1-K6) launches nothing itself: its CUDA
    branch returns ``_build.kernel_with_plain_vjp`` of a body (which
    refuses, as above: its own case) and the plain twin."""
    src = inspect.getsource(fn)
    tree = ast.parse(src.lstrip() if src.startswith(" ") else src)
    if launch == _VJP:
        (call,) = _calls(tree, "kernel_with_plain_vjp")
        assert "kernel_library" not in src
        ret = [n for n in ast.walk(tree) if isinstance(n, ast.Return) and n.value is call]
        assert ret, f"{fn.__name__} does not return the helper's result"
        return
    assert _calls(tree, "refuse_grad"), f"{fn.__name__} does not call _build.refuse_grad"
    assert src.index("refuse_grad") < src.index(launch)


@pytest.mark.parametrize("fn", [F2.geglu_ff, F2.geglu_ff_f32_sm90, C.conv3x3, C.conv3x3_f32_sm90],
                         ids=lambda f: f.__name__)
def test_f32_routes_reach_a_plain_twin_only_for_cpu_tensors(fn):
    """K2's and K4's f32 routes: every call of a plain twin in the wrapper
    lies in the body of an ``if not x.is_cuda:`` (a CUDA tensor launches the
    kernel or raises), read from the source as no CPU run reaches the CUDA
    branch."""
    src = inspect.getsource(fn)
    tree = ast.parse(src.lstrip() if src.startswith(" ") else src)
    guarded = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.If) and isinstance(node.test, ast.UnaryOp)
                and isinstance(node.test.op, ast.Not)
                and isinstance(node.test.operand, ast.Attribute)
                and node.test.operand.attr == "is_cuda"):
            guarded |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
    plain = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id.endswith("_plain")]
    assert plain and all(id(n) in guarded for n in plain)


def test_cpu_twins_stay_differentiable():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 16), generator=gen, requires_grad=True)
    w1 = torch.randn((16, 128), generator=gen) * 0.1
    w2 = torch.randn((64, 16), generator=gen) * 0.1
    out = F2.geglu_ff(x, w1, torch.zeros(128), w2, torch.zeros(16))
    out.square().sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    q = torch.randn((1, 200, 32), generator=gen, requires_grad=True)
    A.flash_attention(q, q, q, 2).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())


# ---- parameterization through the bundle conversion ----

@pytest.fixture(scope="module")
def jax_bundle():
    return JP.ModelBundle.random("tiny", seed=0)


def test_v_bundle_keeps_v_and_is_refused(jax_bundle):
    """A v-model stays "v" through the conversion and renders as the JAX
    package renders it (DDIM converts v to eps); an unknown
    parameterization is refused."""
    jb_v = dataclasses.replace(jax_bundle, parameterization="v")
    pb = P.ModelBundle.from_jax_bundle(jb_v, device="cpu")
    assert (pb.parameterization, pb.version, pb.clip_layer) == ("v", "sd1", "last")
    kw = dict(steps=2, width=32, height=32, batch_size=1)
    x_T = np.random.default_rng(3).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = JP.txt2img(jb_v, "a cat", cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T),
                      decode=False)[1]
    got = P.txt2img(pb, "a cat", cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T),
                    decode=False)[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)
    eps = P.txt2img(P.ModelBundle.from_jax_bundle(jax_bundle, device="cpu"), "a cat",
                    cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T), decode=False)[1]
    assert not torch.allclose(got, eps)
    jb = jax_bundle
    pb2 = P.ModelBundle.from_jax_params(
        jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params, jb.clip_cfg,
        jb.clip_params, device="cpu", parameterization="v", clip_layer="penultimate")
    assert (pb2.parameterization, pb2.clip_layer) == ("v", "penultimate")
    with pytest.raises(ValueError, match="parameterization"):
        P.ModelBundle.from_jax_params(
            jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params, jb.clip_cfg,
            jb.clip_params, device="cpu", parameterization="x0")


def test_from_jax_bundle_reads_any_object_with_the_fields(jax_bundle):
    jb = jax_bundle
    ns = types.SimpleNamespace(
        unet_cfg=jb.unet_cfg, unet_params=jb.unet_params, vae_cfg=jb.vae_cfg,
        vae_params=jb.vae_params, clip_cfg=jb.clip_cfg, clip_params=jb.clip_params,
        version="sd2", parameterization="eps", clip_layer="penultimate")
    pb = P.ModelBundle.from_jax_bundle(ns, device="cpu")
    assert (pb.version, pb.parameterization, pb.clip_layer) == ("sd2", "eps", "penultimate")
    assert pb.unet_cfg == convert.config_from(M.UNetConfig, jb.unet_cfg)


# ---- config_from ----

def test_config_from_raises_on_a_dropped_field():
    """A field the port's config lacks raises unless it holds its default.
    The token-reduction fields are the port's now (they map); a JAX-side
    field with no counterpart, set off its default, still raises."""
    got = convert.config_from(M.UNetConfig, dataclasses.replace(
        JU.UNetConfig(), tome_ratio=0.5, tome_mode="merge"))
    assert (got.tome_ratio, got.tome_mode) == (0.5, "merge")

    @dataclasses.dataclass(frozen=True)
    class Wider(JU.UNetConfig):
        hypernetwork: str = ""

    with pytest.raises(ValueError, match="hypernetwork"):
        convert.config_from(M.UNetConfig, Wider(hypernetwork="anime"))
    assert convert.config_from(M.UNetConfig, Wider()) == M.UNetConfig()
    with pytest.raises(ValueError, match="use_pallas"):
        convert.config_from(M.UNetConfig, dataclasses.replace(JU.UNetConfig(), use_pallas="tp"))


@pytest.mark.parametrize("use_pallas,route", [(None, "bsc"), (True, "bsc"), (False, "bsc"),
                                              ("cm", "cm")])
def test_config_from_maps_use_pallas(use_pallas, route):
    jcfg = dataclasses.replace(JU.UNetConfig.tiny(context_dim=32), use_pallas=use_pallas)
    assert convert.config_from(M.UNetConfig, jcfg).attn_route == route
    # an override wins over the mapped value
    assert convert.config_from(M.UNetConfig, jcfg, attn_route="bsc").attn_route == "bsc"


def test_config_from_converts_the_defaults_and_tiny_configs_as_before():
    assert convert.config_from(M.UNetConfig, JU.UNetConfig()) == M.UNetConfig()
    assert convert.config_from(M.VAEConfig, JV.VAEConfig.tiny()) == M.VAEConfig.tiny()
    assert convert.config_from(M.CLIPTextConfig, JC.CLIPTextConfig.tiny()) == \
        M.CLIPTextConfig.tiny()
    tiny = convert.config_from(M.UNetConfig, JU.UNetConfig.tiny(context_dim=64))
    assert tiny == M.UNetConfig.tiny(context_dim=64)


# ---- encode_image on a dark uint8 image ----

def test_encode_image_dark_uint8_matches_jax(jax_bundle):
    """max <= 2: the JAX package casts to f32 first, so its uint8 check never
    fires and the image reaches the VAE unscaled; the port does the same."""
    jb = jax_bundle
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    img = np.random.default_rng(5).integers(0, 3, (1, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(JP.encode_image(jb, img))
    got = P.encode_image(pb, img)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    got_t = P.encode_image(pb, torch.from_numpy(img))
    np.testing.assert_allclose(got_t.numpy(), want, rtol=F32_RTOL, atol=F32_ATOL)
    # a bright image still takes the rescale on both sides
    bright = img * 100
    np.testing.assert_allclose(P.encode_image(pb, bright).numpy(),
                               np.asarray(JP.encode_image(jb, bright)),
                               rtol=F32_RTOL, atol=F32_ATOL)


# ---- the diffusion tables through the bundle conversion ----

# config-1.49.yaml's layout at tiny widths, with betas other than SD's
TABLES_YAML = """\
model:
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.0005
    linear_end: 0.0200
    timesteps: 1000
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        in_channels: 4
        out_channels: 4
        model_channels: 32
        attention_resolutions: [ 2, 1 ]
        num_res_blocks: 1
        channel_mult: [ 1, 2 ]
        num_heads: 2
        context_dim: 64
    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 32
          in_channels: 3
          out_ch: 3
          ch: 32
          ch_mult: [ 1, 2 ]
          num_res_blocks: 1
          attn_resolutions: []
    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""


def test_from_jax_bundle_keeps_the_tables_of_a_yaml(tmp_path, monkeypatch):
    """A JAX bundle from ``bundle_from_yaml`` with non-default betas: the
    port's bundle carries its tables (every field equal) and DDIM samples
    under them, as the JAX package does. (The CLIP preset the YAML names
    is swapped for a tiny one, with the tokenizer's vocabulary, so the
    bundle is small.)"""
    monkeypatch.setattr(JC.CLIPTextConfig, "sd15", staticmethod(
        lambda: dataclasses.replace(JC.CLIPTextConfig.tiny(), vocab_size=49408)))
    path = tmp_path / "tables.yaml"
    path.write_text(TABLES_YAML)
    jb = JCONF.bundle_from_yaml(str(path), seed=0)
    assert not np.array_equal(jb.tables.betas, JS.make_diffusion_tables().betas)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    for f in dataclasses.fields(pb.tables):
        np.testing.assert_array_equal(getattr(pb.tables, f.name), getattr(jb.tables, f.name))
    kw = dict(steps=4, width=32, height=32, batch_size=1)
    x_T = np.random.default_rng(9).standard_normal((1, 4, 4, 4)).astype(np.float32)
    want = JP.txt2img(jb, "a cat", cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T),
                      decode=False)[1]
    got = P.txt2img(pb, "a cat", cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T),
                    decode=False)[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_RTOL, atol=F32_ATOL)
    # an object without tables still gets SD's
    ns = types.SimpleNamespace(**{f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)
                                  if f.name != "tables"})
    np.testing.assert_array_equal(P.ModelBundle.from_jax_bundle(ns, device="cpu").tables.betas,
                                  JS.make_diffusion_tables().betas)
