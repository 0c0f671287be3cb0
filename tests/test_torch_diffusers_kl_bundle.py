"""Port parity: the diffusers UNet layout (``models/params.py``), the
posterior's ``kl`` / ``nll`` (``models/vae.py``) and the JAX-bundle
converter (``convert_jax_bundle.py``), against the JAX package.

The JAX package's own diffusers test takes its state dict from the torch
oracle, which has no diffusers here; this file writes a diffusers-keyed
dict from a random UNet tree (``synth_checkpoint.diffusers_unet_state_dict``)
and runs it through both converters. f32 on the CPU.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.models import UNetConfig as JUNetConfig
from complex_prompt_diffusion_tpu.models import init_unet as j_init_unet
from complex_prompt_diffusion_tpu.models import params as JPR
from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.models import UNetConfig
from complex_prompt_diffusion_tpu_torch.models import params as PR
from complex_prompt_diffusion_tpu_torch.models import vae as V
from complex_prompt_diffusion_tpu_torch.tools.synth_checkpoint import (
    diffusers_unet_state_dict,
    state_dict,
)

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

ROOT = Path(__file__).resolve().parents[1]


def _flat(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _leaf_equal(got, want):
    """Same paths, and every leaf the same array (dtype, shape, bits)."""
    fg, fw = _flat(got), _flat(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, a), (_, b) in zip(fg, fw):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), jax.tree_util.keystr(path)


# ---- the diffusers UNet layout ----

@pytest.mark.parametrize("preset", ["tiny", "tiny_linear", "tiny_depth2"])
@pytest.mark.parametrize("prefix", ["", "unet."])
def test_convert_unet_diffusers_leaf_equal_to_jax(preset, prefix):
    """A random UNet tree written under diffusers keys: the port's
    ``convert_unet_diffusers`` and JAX's give the same leaves
    (``np.array_equal``: the conversion is a relabelling), equal to the tree
    written; the relabelled keys are JAX's ``diffusers_to_compvis_unet``'s
    and the CompVis writer's; a dict under another prefix raises."""
    base = JUNetConfig.tiny(context_dim=32)
    jcfg = {"tiny": base,
            "tiny_linear": dataclasses.replace(base, use_linear_in_transformer=True,
                                               num_heads=-1, num_head_channels=16),
            "tiny_depth2": dataclasses.replace(base, transformer_depth=2, num_res_blocks=2)}[preset]
    cfg = convert.config_from(UNetConfig, jcfg)
    tree = jax.tree_util.tree_map(np.asarray, j_init_unet(jax.random.PRNGKey(4), jcfg,
                                                          commit=False))
    # the zero-init output layers get values, so that a mislabelled leaf shows
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: a + rng.standard_normal(a.shape).astype(a.dtype),
                                  tree)
    sd = {k: v.numpy() for k, v in diffusers_unet_state_dict(cfg, tree, prefix=prefix).items()}
    assert any(k.startswith(prefix + "down_blocks.") for k in sd)
    sd[prefix + "time_proj.dummy"] = np.zeros(1, np.float32)  # no parameter: dropped by both
    got = PR.convert_unet_diffusers(cfg, sd, prefix=prefix)
    want = JPR.convert_unet_diffusers(jcfg, sd, prefix=prefix)
    _leaf_equal(got, want)
    _leaf_equal(got, tree)
    keys = PR.diffusers_to_compvis_unet(sd, prefix)
    assert keys.keys() == JPR.diffusers_to_compvis_unet(sd, prefix).keys()
    compvis = state_dict(cfg, tree, _vae_tree(), _clip_tree(), clip_layout="hf")
    unet_keys = {k[len("model.diffusion_model."):] for k in compvis
                 if k.startswith("model.diffusion_model.")}
    assert set(keys) == unet_keys
    with pytest.raises(ValueError, match="not a diffusers UNet"):
        PR.diffusers_to_compvis_unet(sd, "other.")


def _vae_tree():
    jb = _tiny_jax_bundle()
    return jax.tree_util.tree_map(np.asarray, jb.vae_params)


def _clip_tree():
    jb = _tiny_jax_bundle()
    return jax.tree_util.tree_map(np.asarray, jb.clip_params)


_JB = {}


def _tiny_jax_bundle():
    if "tiny" not in _JB:
        _JB["tiny"] = JP.ModelBundle.random("tiny", seed=0)
    return _JB["tiny"]


# ---- the posterior's kl and nll ----

def test_diagonal_gaussian_kl_nll_match_jax():
    """``kl`` and ``nll`` over an encoder posterior of the tiny VAE (the
    moments channels-last [B, h, w, 2 z]), sums over the three non-batch
    axes: equal to JAX's within f32 rounding (rtol 1e-6)."""
    jb = _tiny_jax_bundle()
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    rng = np.random.default_rng(5)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jpost = JV.vae_encode(jb.vae_cfg, jb.vae_params, jnp.asarray(images))
    post = V.vae_encode(pb.vae_cfg, pb.vae_params, torch.from_numpy(images))
    assert tuple(post.mean.shape) == (2, 16, 16, 4)  # the tiny VAE halves the side
    # the same moments on both sides, so that the check is of kl and nll
    jpost = JV.DiagonalGaussian(jnp.asarray(post.mean.numpy()), jnp.asarray(post.logvar.numpy()))
    sample = rng.standard_normal(post.mean.shape).astype(np.float32)
    kl, nll = post.kl(), post.nll(torch.from_numpy(sample))
    assert tuple(kl.shape) == tuple(nll.shape) == (2,) and kl.dtype == torch.float32
    np.testing.assert_allclose(kl.numpy(), np.asarray(jpost.kl()), rtol=1e-6)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jpost.nll(jnp.asarray(sample))), rtol=1e-6)
    # the axes: a posterior that differs in one sample only changes that row
    moments = torch.cat([post.mean, post.logvar], dim=-1)
    moments[1, 0, 0, 0] += 1.0
    shifted = V.DiagonalGaussian.from_moments(moments)
    assert shifted.kl()[0] == kl[0] and shifted.kl()[1] != kl[1]


# ---- the JAX-bundle converter ----

def _load_script():
    spec = importlib.util.spec_from_file_location("convert_jax_bundle",
                                                  ROOT / "convert_jax_bundle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_convert_jax_bundle_round_trip(tmp_path):
    """JAX ``save_bundle`` of the tiny bundle (orbax), the script's
    ``convert``, the port's ``load_bundle``: every leaf equals JAX's
    (dtype and bits), ``meta.json`` has JAX's keys with the same version,
    parameterization, clip_layer and config values (the port's configs'
    fields), and a 2-step tiny render equals ``from_jax_bundle``'s bit for
    bit."""
    jb = dataclasses.replace(_tiny_jax_bundle(), parameterization="v", clip_layer="penultimate")
    JP.save_bundle(jb, str(tmp_path / "jax"))
    meta_jax = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert (tmp_path / "jax" / "params").is_dir()
    _load_script().convert(str(tmp_path / "jax"), str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta.keys() == meta_jax.keys()
    for key in ("version", "parameterization", "clip_layer"):
        assert meta[key] == meta_jax[key]
    # the configs: the same values in every field both have; the UNet's
    # use_pallas is JAX's (TPU dispatch), attn_route its port counterpart
    port_only = {"unet_cfg": {"attn_route"}, "vae_cfg": set(), "clip_cfg": set()}
    for key in ("unet_cfg", "vae_cfg", "clip_cfg"):
        shared = meta[key].keys() & meta_jax[key].keys()
        assert meta[key].keys() - shared == port_only[key]
        assert meta_jax[key].keys() - shared <= {"use_pallas"}
        assert {k: meta[key][k] for k in shared} == {k: meta_jax[key][k] for k in shared}
    pb = P.load_bundle(str(tmp_path / "port"), device="cpu")
    direct = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    for got, want in ((pb.unet_params, jb.unet_params), (pb.vae_params, jb.vae_params),
                      (pb.clip_params, jb.clip_params)):
        fg, fw = _flat(got), _flat(want)
        assert len(fg) == len(fw)
    for got, want in ((pb.unet_params, direct.unet_params), (pb.vae_params, direct.vae_params),
                      (pb.clip_params, direct.clip_params)):
        fg, fw = _flat(got), _flat(want)
        assert [p for p, _ in fg] == [p for p, _ in fw]
        assert all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(fg, fw))
    # the port's leaves are JAX's arrays, relaid out by convert (HWIO -> OIHW)
    jk = np.asarray(jb.unet_params["input_blocks"][0][0]["kernel"])
    pk = pb.unet_params["input_blocks"][0][0]["weight"]
    assert np.array_equal(pk.permute(2, 3, 1, 0).numpy(), jk)
    assert np.array_equal(pb.clip_params["token_embedding"].numpy(),
                          np.asarray(jb.clip_params["token_embedding"]))
    for f in ("unet_cfg", "vae_cfg", "clip_cfg"):
        assert getattr(pb, f) == getattr(direct, f)
    assert (pb.version, pb.parameterization, pb.clip_layer) == (jb.version, "v", "penultimate")
    cfg = P.RenderConfig(steps=2, width=32, height=32, seed=3)
    _, lat = P.txt2img(pb, "a red cube", cfg=cfg, decode=False)
    _, lat_direct = P.txt2img(direct, "a red cube", cfg=cfg, decode=False)
    assert torch.equal(lat, lat_direct)
