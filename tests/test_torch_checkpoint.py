"""Checkpoints, YAML configs and bundle I/O against the JAX package.

``tools/synth_checkpoint.py`` writes CompVis state dicts from parameter
trees; the JAX package's converters read them back into the trees they
were written from, which holds the tool's key names to the reference.
The port's loader (``models/params.py``, its own safetensors reader) then
gives trees bit-equal to the JAX package's ``load_sd_checkpoint`` on the
same ``.ckpt`` and ``.safetensors`` files. ``load_sd_checkpoint`` reads
the full-size presets, so the tests swap tiny configs into both packages'
preset functions with ``monkeypatch``. The YAML fixtures are the public
``v2-inference-v.yaml`` and ``config-1.49.yaml``, written to ``tmp_path``.
"""

import ast
import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import save_file as st_save_torch

from complex_prompt_diffusion_tpu import config as JCONF
from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import params as JPAR
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu_torch import config as CONF
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.guidance import GuidanceConfig
from complex_prompt_diffusion_tpu_torch.models import params as PAR
from complex_prompt_diffusion_tpu_torch.tools import synth_checkpoint as SC

ROOT = pathlib.Path(__file__).resolve().parents[1]

V2_INFERENCE_V_YAML = """\
model:
  base_learning_rate: 1.0e-4
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    parameterization: "v"
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    image_size: 96
    channels: 4
    cond_stage_trainable: false
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215
    use_ema: False

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        use_checkpoint: True
        use_fp16: True
        image_size: 32 # unused
        in_channels: 4
        out_channels: 4
        model_channels: 320
        attention_resolutions: [ 4, 2, 1 ]
        num_res_blocks: 2
        channel_mult: [ 1, 2, 4, 4 ]
        num_head_channels: 64
        use_spatial_transformer: True
        use_linear_in_transformer: True
        transformer_depth: 1
        context_dim: 1024
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenOpenCLIPEmbedder
      params:
        freeze: True
        layer: "penultimate"
"""

CONFIG_1_49_YAML = """\
model:
  base_learning_rate: 1.0e-04
  target: ldm.models.diffusion.ddpm.LatentDiffusion
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: 1000
    first_stage_key: "jpg"
    cond_stage_key: "txt"
    image_size: 64
    channels: 4
    cond_stage_trainable: false
    conditioning_key: crossattn
    monitor: val/loss_simple_ema
    scale_factor: 0.18215

    scheduler_config:
      target: ldm.lr_scheduler.LambdaLinearScheduler
      params:
        warm_up_steps: [ 10000 ]
        cycle_lengths: [ 10000000000000 ]
        f_start: [ 1.e-6 ]
        f_max: [ 1. ]
        f_min: [ 1. ]

    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        image_size: 32 # unused
        in_channels: 4
        out_channels: 4
        model_channels: 320
        attention_resolutions: [ 4, 2, 1 ]
        num_res_blocks: 2
        channel_mult: [ 1, 2, 4, 4 ]
        num_heads: 8
        use_spatial_transformer: True
        transformer_depth: 1
        context_dim: 768
        use_checkpoint: True
        legacy: False

    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: 4
          resolution: 256
          in_channels: 3
          out_ch: 3
          ch: 128
          ch_mult:
          - 1
          - 2
          - 4
          - 4
          num_res_blocks: 2
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""

YAMLS = {"v2-inference-v": V2_INFERENCE_V_YAML, "config-1.49": CONFIG_1_49_YAML}


# ---- tiny presets in both packages ----

def _tiny_jax_presets():
    """Tiny stand-ins for the JAX presets load_sd_checkpoint reads, with
    SD 2.x's and SD 1.x's shapes."""
    sd15 = JU.UNetConfig.tiny(context_dim=64)
    sd21 = dataclasses.replace(sd15, num_heads=-1, num_head_channels=16,
                               use_linear_in_transformer=True)
    return {
        (JU.UNetConfig, "sd15"): sd15,
        (JU.UNetConfig, "sd21"): sd21,
        (JU.UNetConfig, "sd2_depth"): dataclasses.replace(sd21, in_channels=5),
        (JU.UNetConfig, "sd_inpaint"): dataclasses.replace(sd15, in_channels=9),
        (JC.CLIPTextConfig, "sd15"): JC.CLIPTextConfig.tiny(),
        (JC.CLIPTextConfig, "sd21"): dataclasses.replace(JC.CLIPTextConfig.tiny(),
                                                         activation="gelu"),
        (JV.VAEConfig, "sd"): JV.VAEConfig.tiny(),
    }


_PORT_CLASS = {JU.UNetConfig: M.UNetConfig, JC.CLIPTextConfig: M.CLIPTextConfig,
               JV.VAEConfig: M.VAEConfig}


@pytest.fixture
def tiny_presets(monkeypatch):
    """Swap the tiny configs into both packages' preset functions (the port
    gets the same configs, converted); returns the JAX ones."""
    presets = _tiny_jax_presets()
    for (cls, name), cfg in presets.items():
        port_cfg = convert.config_from(_PORT_CLASS[cls], cfg)
        monkeypatch.setattr(cls, name, staticmethod(lambda cfg=cfg: cfg))
        monkeypatch.setattr(_PORT_CLASS[cls], name, staticmethod(lambda c=port_cfg: c))
    return presets


def _trees(version: str, in_ch: int = 4, seed: int = 0):
    """JAX-layout numpy trees of the tiny preset of ``version`` with an
    ``in_ch``-channel UNet input: (unet_cfg, unet, vae, clip)."""
    presets = _tiny_jax_presets()
    ucfg = presets[(JU.UNetConfig, "sd21" if version == "sd2" else "sd15")]
    ucfg = dataclasses.replace(ucfg, in_channels=in_ch)
    ccfg = presets[(JC.CLIPTextConfig, "sd21" if version == "sd2" else "sd15")]
    key = jax.random.PRNGKey(seed)
    return (ucfg, JM.init_unet(key, ucfg, commit=False),
            JM.init_vae(jax.random.fold_in(key, 1), JV.VAEConfig.tiny(), commit=False),
            JM.init_clip_text(jax.random.fold_in(key, 2), ccfg, commit=False))


def _state_dict(version, in_ch=4, seed=0, **kw):
    ucfg, unet, vae, clip = _trees(version, in_ch, seed)
    sd = SC.state_dict(convert.config_from(M.UNetConfig, ucfg), unet, vae, clip,
                       clip_layout="openclip" if version == "sd2" else "hf", **kw)
    return sd, (unet, vae, clip)


def _leaves(tree, pre=""):
    """{path: leaf} of a parameter tree (dicts compared by key, whatever
    their order)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{pre}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{pre}/{i}").items()}
    return {pre: tree}


def _assert_bit_equal(got, want):
    """Bit-equal numpy (or JAX) trees, every leaf f32."""
    fg, fw = ({k: np.asarray(v) for k, v in _leaves(t).items()} for t in (got, want))
    assert fg.keys() == fw.keys()
    for k in fw:
        assert fg[k].dtype == np.float32, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def _write(sd, path: pathlib.Path) -> str:
    if path.suffix == ".safetensors":
        st_save_numpy({k: v.numpy() for k, v in sd.items()}, str(path))
    else:
        SC.write_checkpoint(str(path), sd)
    return str(path)


# ---- the synthesizer against the JAX converters ----

@pytest.mark.parametrize("version", ["sd2", "sd1"])
def test_synth_checkpoint_reads_back_through_the_jax_converters(tmp_path, version):
    """The JAX package's own reader and converters return the trees the
    tool wrote: OpenCLIP (packed in_proj) for SD 2.x, HF CLIP for SD 1.x."""
    sd, (unet, vae, clip) = _state_dict(version)
    path = _write(sd, tmp_path / "model.ckpt")
    raw = JPAR.load_state_dict(path)
    ucfg = _trees(version)[0]
    ccfg = _tiny_jax_presets()[(JC.CLIPTextConfig, "sd21" if version == "sd2" else "sd15")]
    _assert_bit_equal(JPAR.convert_unet(ucfg, raw), unet)
    _assert_bit_equal(JPAR.convert_vae(JV.VAEConfig.tiny(), raw), vae)
    conv = JPAR.convert_clip_openclip if version == "sd2" else JPAR.convert_clip_hf
    _assert_bit_equal(conv(ccfg, raw), clip)
    assert JPAR.detect_sd_version(raw) == version


def test_synth_checkpoint_packs_openclip_qkv():
    sd, (_, _, clip) = _state_dict("sd2")
    w = sd["cond_stage_model.model.transformer.resblocks.1.attn.in_proj_weight"]
    d = clip["layers"][1]["q"]["kernel"].shape[0]
    assert tuple(w.shape) == (3 * d, d)
    np.testing.assert_array_equal(w[d:2 * d].numpy(),
                                  np.asarray(clip["layers"][1]["k"]["kernel"]).T)


# ---- the port's loader against JAX's ----

LOADER_CASES = [("sd2", 4), ("sd2", 5), ("sd1", 4), ("sd1", 9), ("sd1", 5)]


@pytest.mark.parametrize("suffix", [".ckpt", ".safetensors"])
@pytest.mark.parametrize("version,in_ch", LOADER_CASES)
def test_loader_matches_jax_load_sd_checkpoint(tmp_path, tiny_presets, suffix, version, in_ch):
    """Bit-equal trees and equal configs on the same file; the preset
    follows the version and the input width (4 and 5 channels for SD 2.x:
    sd21, sd2_depth; 4 and 9 for SD 1.x: sd15, sd_inpaint; another width
    replaces the preset's)."""
    sd, _ = _state_dict(version, in_ch)
    path = _write(sd, tmp_path / f"model{suffix}")
    want = JPAR.load_sd_checkpoint(path)
    got = PAR.load_sd_checkpoint(path)
    assert got["version"] == want["version"] == version
    for part, cls in (("unet", M.UNetConfig), ("vae", M.VAEConfig), ("clip", M.CLIPTextConfig)):
        assert got[part][0] == convert.config_from(cls, want[part][0]), part
        _assert_bit_equal(got[part][1], want[part][1])
    assert got["unet"][0].in_channels == in_ch
    preset = {("sd2", 4): "sd21", ("sd2", 5): "sd2_depth", ("sd1", 4): "sd15",
              ("sd1", 9): "sd_inpaint", ("sd1", 5): "sd15"}[(version, in_ch)]
    assert got["unet"][0] == dataclasses.replace(getattr(M.UNetConfig, preset)(),
                                                 in_channels=in_ch)


def test_loader_reads_a_half_precision_checkpoint_as_jax(tmp_path, tiny_presets):
    """An fp16 file (as SD checkpoints ship): both packages widen to f32,
    the same bits, the written trees rounded to fp16."""
    sd, (unet, _, _) = _state_dict("sd2", dtype=torch.float16)
    for suffix in (".ckpt", ".safetensors"):
        path = _write(sd, tmp_path / f"half{suffix}")
        got, want = PAR.load_sd_checkpoint(path), JPAR.load_sd_checkpoint(path)
        for part in ("unet", "vae", "clip"):
            _assert_bit_equal(got[part][1], want[part][1])
        half = jax.tree.map(lambda a: np.asarray(a).astype(np.float16).astype(np.float32), unet)
        _assert_bit_equal(got["unet"][1], half)


@pytest.mark.parametrize("use_ema", [False, True])
def test_ema_shadows_match_jax(tmp_path, tiny_presets, use_ema):
    """LitEma shadows: with use_ema the UNet is the shadow tree in both
    packages, without it the trained one; the rest is untouched."""
    _, shadow, _, _ = _trees("sd2", seed=5)
    sd, (unet, vae, _) = _state_dict("sd2", ema_unet=shadow)
    assert "model_ema.decay" in sd and "model_ema.diffusion_modelinput_blocks00weight" in sd
    path = _write(sd, tmp_path / "ema.ckpt")
    got = PAR.load_sd_checkpoint(path, use_ema=use_ema)
    want = JPAR.load_sd_checkpoint(path, use_ema=use_ema)
    _assert_bit_equal(got["unet"][1], want["unet"][1])
    _assert_bit_equal(got["unet"][1], shadow if use_ema else unet)
    _assert_bit_equal(got["vae"][1], vae)
    raw = {k: v.float().numpy() for k, v in sd.items()}
    a, b = PAR.apply_ema_weights(dict(raw)), JPAR.apply_ema_weights(dict(raw))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("keys,version", [
    (["cond_stage_model.model.ln_final.weight"], "sd2"),
    (["cond_stage_model.transformer.text_model.final_layer_norm.weight"], "sd1"),
    (["model.diffusion_model.out.2.weight"], "sd1"),
])
def test_detect_sd_version_matches_jax(keys, version):
    sd = {k: np.zeros(1, np.float32) for k in keys}
    assert PAR.detect_sd_version(sd) == JPAR.detect_sd_version(sd) == version


# ---- the safetensors reader ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64,
                                   torch.int32, torch.uint8, torch.bool, torch.float64])
def test_read_safetensors_every_dtype(tmp_path, dtype):
    """Each dtype widened to f32 as torch widens it (bf16's 16 bits as the
    high half of an f32), with the header's shapes; metadata is skipped."""
    gen = torch.Generator().manual_seed(0)
    base = torch.randn((3, 5, 7), generator=gen) * 50
    tensors = {"a.weight": base.to(dtype), "b": base[0, 0].to(dtype).clone(),
               "c": base[:0].to(dtype).clone()}
    path = str(tmp_path / "t.safetensors")
    st_save_torch(tensors, path, metadata={"format": "pt"})
    got = PAR.read_safetensors(path)
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        assert got[k].dtype == np.float32 and got[k].shape == tuple(t.shape)
        np.testing.assert_array_equal(got[k], t.float().numpy())


def test_read_safetensors_rejects_malformed_files(tmp_path):
    good = tmp_path / "good.safetensors"
    st_save_numpy({"w": np.arange(12, dtype=np.float32).reshape(3, 4)}, str(good))
    data = good.read_bytes()
    for name, blob in (("short", data[:5]), ("cut", data[:-8]),
                       ("header", data[:8] + b"{not json" + data[17:])):
        bad = tmp_path / f"{name}.safetensors"
        bad.write_bytes(blob)
        with pytest.raises(ValueError):
            PAR.read_safetensors(str(bad))
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]}})
    odd = tmp_path / "dtype.safetensors"
    odd.write_bytes(len(header).to_bytes(8, "little") + header.encode() + b"\0")
    with pytest.raises(ValueError, match="unsupported dtype"):
        PAR.read_safetensors(str(odd))


# ---- ModelBundle.from_checkpoint ----

@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_from_checkpoint_matches_jax(tmp_path, tiny_presets, dtype):
    """The bundle's trees are the JAX bundle's converted (the UNet cast to
    ``dtype`` on the host, its config saying so); version, clip layer and
    the tokenizer's padding follow the version, as in the JAX package."""
    sd, _ = _state_dict("sd2")
    path = _write(sd, tmp_path / "sd2.ckpt")
    jb = JP.ModelBundle.from_checkpoint(path, dtype=dtype)
    pb = P.ModelBundle.from_checkpoint(path, dtype=dtype, device="cpu")
    assert (pb.version, pb.clip_layer, pb.parameterization) == \
        (jb.version, jb.clip_layer, jb.parameterization) == ("sd2", "penultimate", "eps")
    assert pb.tokenizer.pad_id == jb.tokenizer.pad_id == 0
    assert pb.unet_cfg == convert.config_from(M.UNetConfig, jb.unet_cfg)
    dt = torch.bfloat16 if dtype else torch.float32
    _assert_tensors_equal(pb.unet_params, convert.unet_params(jb.unet_params, "cpu", dt), dt)
    _assert_tensors_equal(pb.vae_params, convert.vae_params(jb.vae_params), torch.float32)
    _assert_tensors_equal(pb.clip_params, convert.clip_params(jb.clip_params), torch.float32)


def _assert_tensors_equal(got, want, dtype=None):
    """Bit-equal tensor trees: the same paths, dtypes (``dtype``, where
    given), strides and values."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, b in want.items():
        a = got[k]
        assert a.dtype == b.dtype and (dtype is None or a.dtype == dtype), k
        assert a.stride() == b.stride() and torch.equal(a, b), k


def test_from_checkpoint_sd1_pads_with_eos(tmp_path, tiny_presets):
    sd, _ = _state_dict("sd1")
    pb = P.ModelBundle.from_checkpoint(_write(sd, tmp_path / "sd1.ckpt"), device="cpu")
    assert (pb.version, pb.clip_layer) == ("sd1", "last")
    assert pb.tokenizer.pad_id == pb.tokenizer.eos_id


# ---- YAML configs ----

@pytest.mark.parametrize("name", sorted(YAMLS))
def test_bundle_from_yaml_matches_jax(tmp_path, monkeypatch, name):
    """The public configs at their full widths: configs, tables,
    parameterization, clip layer, version and the tokenizer's padding equal
    the JAX package's. The weights' random init is replaced by an empty tree
    in both packages (the full-size init is not what is compared)."""
    path = tmp_path / f"{name}.yaml"
    path.write_text(YAMLS[name])
    for mod in (JM, M):
        monkeypatch.setattr(mod, "init_unet", lambda *a, **k: {})
        monkeypatch.setattr(mod, "init_clip_text", lambda *a, **k: {})
        monkeypatch.setattr(mod, "init_vae", lambda *a, **k: {
            key: {} for key in ("encoder", "decoder", "quant_conv", "post_quant_conv")})
    jb = JCONF.bundle_from_yaml(str(path))
    pb = CONF.bundle_from_yaml(str(path), device="cpu")
    assert pb.unet_cfg == convert.config_from(M.UNetConfig, jb.unet_cfg)
    assert pb.vae_cfg == convert.config_from(M.VAEConfig, jb.vae_cfg)
    assert pb.clip_cfg == convert.config_from(M.CLIPTextConfig, jb.clip_cfg)
    for f in dataclasses.fields(pb.tables):
        np.testing.assert_array_equal(getattr(pb.tables, f.name), getattr(jb.tables, f.name))
    assert (pb.version, pb.parameterization, pb.clip_layer) == \
        (jb.version, jb.parameterization, jb.clip_layer)
    assert pb.tokenizer.pad_id == jb.tokenizer.pad_id
    want = {"v2-inference-v": ("sd2", "v", "penultimate", M.UNetConfig.sd21(), 0),
            "config-1.49": ("sd1", "eps", "last", M.UNetConfig.sd15(), pb.tokenizer.eos_id)}
    assert (pb.version, pb.parameterization, pb.clip_layer, pb.unet_cfg,
            pb.tokenizer.pad_id) == want[name]


TINY_V_YAML = V2_INFERENCE_V_YAML.replace("model_channels: 320", "model_channels: 32") \
    .replace("channel_mult: [ 1, 2, 4, 4 ]", "channel_mult: [ 1, 2 ]") \
    .replace("attention_resolutions: [ 4, 2, 1 ]", "attention_resolutions: [ 2, 1 ]") \
    .replace("num_res_blocks: 2\n        channel_mult", "num_res_blocks: 1\n        channel_mult") \
    .replace("num_head_channels: 64", "num_head_channels: 16") \
    .replace("context_dim: 1024", "context_dim: 64") \
    .replace("linear_start: 0.00085", "linear_start: 0.0009") \
    .replace("linear_end: 0.0120", "linear_end: 0.0135") \
    .replace("ch: 128\n          ch_mult:\n          - 1\n          - 2\n          - 4\n"
             "          - 4\n          num_res_blocks: 2",
             "ch: 32\n          ch_mult:\n          - 1\n          - 2\n"
             "          num_res_blocks: 1")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_bundle_from_yaml_with_a_checkpoint_matches_jax(tmp_path, tiny_presets, dtype):
    """v2-inference-v at tiny widths with a checkpoint: the weights are the
    checkpoint's, the configs, tables and parameterization the YAML's, in
    both packages; ``dtype`` casts the port's UNet on the host."""
    assert "model_channels: 32" in TINY_V_YAML and "- 4\n" not in TINY_V_YAML.split(
        "first_stage_config")[1]
    yml = tmp_path / "tiny-v.yaml"
    yml.write_text(TINY_V_YAML)
    sd, (unet, vae, clip) = _state_dict("sd2")
    ckpt = _write(sd, tmp_path / "tiny.ckpt")
    jb = JCONF.bundle_from_yaml(str(yml), checkpoint_path=ckpt)
    pb = CONF.bundle_from_yaml(str(yml), checkpoint_path=ckpt, device="cpu", dtype=dtype)
    want_cfg = convert.config_from(M.UNetConfig, jb.unet_cfg)
    assert pb.unet_cfg == (dataclasses.replace(want_cfg, dtype=dtype) if dtype else want_cfg)
    assert pb.vae_cfg == convert.config_from(M.VAEConfig, jb.vae_cfg)
    assert (pb.version, pb.parameterization, pb.clip_layer, pb.tokenizer.pad_id) == \
        (jb.version, jb.parameterization, jb.clip_layer, jb.tokenizer.pad_id) == \
        ("sd2", "v", "penultimate", 0)
    np.testing.assert_array_equal(pb.tables.betas, jb.tables.betas)
    assert not np.array_equal(pb.tables.betas, P.S.make_diffusion_tables().betas)
    _assert_tensors_equal(pb.unet_params,
                          convert.unet_params(unet, "cpu", torch.bfloat16 if dtype else None))
    _assert_tensors_equal(pb.vae_params, convert.vae_params(vae))
    _assert_tensors_equal(pb.clip_params, convert.clip_params(clip))


def test_bundle_from_config_needs_no_pyyaml(tmp_path, monkeypatch):
    """Without PyYAML, load_yaml_config raises an ImportError naming it,
    and the dict-level builder still builds from a parsed mapping."""
    import yaml

    conf = yaml.safe_load(TINY_V_YAML)
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "x.yaml"
    path.write_text(TINY_V_YAML)
    with pytest.raises(ImportError, match="PyYAML"):
        CONF.load_yaml_config(str(path))
    with pytest.raises(ImportError, match="PyYAML"):
        CONF.bundle_from_yaml(str(path), device="cpu")
    for mapping in (conf, conf["model"]):
        pb = CONF.bundle_from_config(mapping, seed=3, device="cpu")
        assert (pb.version, pb.parameterization, pb.unet_cfg.model_channels) == ("sd2", "v", 32)
    a, b = (CONF.bundle_from_config(conf["model"], seed=s, device="cpu") for s in (3, 3))
    c = CONF.bundle_from_config(conf["model"], seed=4, device="cpu")
    key = "/input_blocks/1/0/in_conv/weight"
    wa, wb, wc = (_leaves(x.unet_params)[key] for x in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == a.unet_cfg.compute_dtype


def test_chip_smoke_literal_is_the_v2_inference_v_model_section():
    """The card has no PyYAML: ``chip_smoke.py`` builds SD 2.1-v from a
    Python literal of v2-inference-v.yaml's ``model:`` section, which must
    be the parsed file."""
    import yaml

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.V2_INFERENCE_V_MODEL == yaml.safe_load(V2_INFERENCE_V_YAML)["model"]


# ---- bundle I/O and the render config ----

def test_save_load_bundle_round_trip(tmp_path):
    """Bit-exact trees (dtypes and conv layouts too), the same fields; the
    meta.json keys are the JAX package's."""
    pb = P.ModelBundle.random("tiny", seed=1, device="cpu").cast("bfloat16")
    pb = dataclasses.replace(pb, version="sd2", parameterization="v", clip_layer="penultimate")
    P.save_bundle(pb, str(tmp_path / "port"))
    got = P.load_bundle(str(tmp_path / "port"), device="cpu")
    for name in ("unet_params", "vae_params", "clip_params"):
        _assert_tensors_equal(getattr(got, name), getattr(pb, name))
    for f in ("version", "parameterization", "clip_layer", "unet_cfg", "vae_cfg", "clip_cfg"):
        assert getattr(got, f) == getattr(pb, f), f
    assert got.tokenizer.pad_id == 0
    jb = JP.ModelBundle.random("tiny", seed=1)
    JP.save_bundle(jb, str(tmp_path / "jax"))
    port_meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert port_meta.keys() == jax_meta.keys()
    assert port_meta["vae_cfg"].keys() == jax_meta["vae_cfg"].keys()
    assert port_meta["clip_cfg"].keys() == jax_meta["clip_cfg"].keys()


def test_load_bundle_reads_a_jax_meta_json(tmp_path):
    """The configs of a JAX package's meta.json load (fields the port lacks
    dropped) beside a port params file."""
    jb = JP.ModelBundle.random("tiny", seed=1)
    JP.save_bundle(jb, str(tmp_path / "b"))
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    torch.save({"unet": pb.unet_params, "vae": pb.vae_params, "clip": pb.clip_params},
               tmp_path / "b" / P.PARAMS_FILE)
    got = P.load_bundle(str(tmp_path / "b"), device="cpu")
    assert got.unet_cfg == pb.unet_cfg and got.vae_cfg == pb.vae_cfg
    assert (got.version, got.parameterization, got.clip_layer) == ("sd1", "eps", "last")


RENDER_CONFIGS = [
    {},
    dict(steps=20, sampler="DPM++ 2m", sigma_schedule="karras", guidance_scale=9.0,
         width=768, height=768, batch_size=4, seed=7),
    dict(sampler="UniPC", solver_order=3, unipc_variant="vary_coeff", eta=0.3),
    dict(sampler="Euler", s_churn=0.5, s_tmax=10.0, denoising_strength=0.4,
         guidance=GuidanceConfig(guidance_scale=5.0)),
]


@pytest.mark.parametrize("kw", RENDER_CONFIGS, ids=range(len(RENDER_CONFIGS)))
def test_render_config_json_equals_jax(kw):
    from complex_prompt_diffusion_tpu.guidance import GuidanceConfig as JGuidance

    jkw = dict(kw)
    if "guidance" in jkw:
        jkw["guidance"] = JGuidance(**dataclasses.asdict(jkw["guidance"]))
    cfg, jcfg = P.RenderConfig(**kw), JP.RenderConfig(**jkw)
    data = P.render_config_to_json(cfg)
    assert data == JP.render_config_to_json(jcfg)
    assert P.render_config_from_json(json.loads(json.dumps(data))) == cfg
    assert P.render_config_from_json({**data, "unknown": 1}) == cfg


# ---- what the port imports ----

def _imports(path: pathlib.Path):
    """(module name, enclosing function name or None) of every import."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import):
                out.extend((a.name, name) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                out.append((child.module or "", name))
            visit(child, name)

    visit(tree, None)
    return out


def test_port_imports_no_jax_safetensors_orbax_and_yaml_only_to_parse():
    """No module of the port and no line of ``chip_smoke.py`` imports jax,
    the JAX package, safetensors, orbax, lark, cv2 or skimage (the card's
    machine has none of them: ``utils/cv.py`` replaces cv2); PyYAML only in
    ``config.load_yaml_config``; PIL only inside ``utils/image.py``'s three
    file functions."""
    files = sorted((ROOT / "complex_prompt_diffusion_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    # the subpackages and modules of the last slice are in the scan
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"complex_prompt_diffusion_tpu_torch/parallel/mesh.py",
            "complex_prompt_diffusion_tpu_torch/parallel/tp.py",
            "complex_prompt_diffusion_tpu_torch/parallel/dryrun.py",
            "complex_prompt_diffusion_tpu_torch/ops/sharding.py",
            "complex_prompt_diffusion_tpu_torch/models/embedders.py"} <= scanned
    pil = []
    for path in files:
        for mod, fn in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "safetensors", "orbax", "lark",
                               "complex_prompt_diffusion_tpu", "cv2", "skimage"), (path, mod)
            if top == "yaml":
                assert path.name == "config.py" and fn == "load_yaml_config", (path, fn)
            if top == "PIL":
                pil.append((path.relative_to(ROOT).as_posix(), fn))
    image = "complex_prompt_diffusion_tpu_torch/utils/image.py"
    assert sorted(pil) == [(image, "load_image"), (image, "load_mask"), (image, "save_image")], pil
