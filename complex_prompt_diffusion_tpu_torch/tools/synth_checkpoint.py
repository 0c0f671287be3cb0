"""Write parameter trees as a CompVis Stable Diffusion checkpoint, a
diffusers UNet state dict or an HF T5 encoder state dict.

Test tooling, not an entry point: the inverse of the key maps of
``models/params.py`` and ``models/embedders.py``. From a UNet, a VAE and a CLIP text tower in the
JAX package's tree layout (conv kernels HWIO, linears ``[in, out]``, norms
``{scale, bias}``; numpy arrays or torch tensors on any device) it builds
the state dict a CompVis checkpoint holds:

  * the UNet under ``model.diffusion_model.*``, and with ``ema_unet`` a
    second UNet as LitEma shadows (``model_ema.`` + the name after
    ``model.`` without its dots, and the ``decay`` / ``num_updates``
    buffers);
  * the VAE under ``first_stage_model.*``;
  * an OpenCLIP text tower under ``cond_stage_model.model.*`` (q, k and v
    packed into ``attn.in_proj_weight`` / ``in_proj_bias``), or an HF CLIP
    one under ``cond_stage_model.transformer.text_model.*``.

:func:`diffusers_unet_state_dict` writes a UNet tree under a diffusers
``UNet2DConditionModel``'s keys (what ``params.convert_unet_diffusers``
reads), :func:`hf_t5_state_dict` a T5 encoder tree under an HF
``T5EncoderModel``'s (what ``embedders.convert_t5_hf`` reads).

:func:`write_checkpoint` saves it as a ``.ckpt`` (``{"state_dict": ...}``
through ``torch.save``). The UNet may have any input width: the
concat models' 9 (SD-1 inpaint) or 5 (SD-2 depth), which the loader's
detection maps to ``UNetConfig.sd_inpaint`` / ``sd2_depth``. The CPU tests
hold the keys to the JAX package's converters; ``chip_smoke.py`` writes
full-width SD-2.1, SD-1.5 inpaint and SD-2 depth files with it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.models.unet import UNetConfig, build_plan

__all__ = ["state_dict", "compvis_unet_state_dict", "diffusers_unet_state_dict", "hf_t5_state_dict",
           "write_checkpoint"]


class _Writer:
    """Accumulates torch-layout tensors in ``dtype`` on the CPU."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.sd: Dict[str, torch.Tensor] = {}

    def tensor(self, a) -> torch.Tensor:
        t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        # cast where the tensor lies (on the card: half the bytes to copy)
        return t.to(self.dtype).cpu().contiguous()

    def put(self, key: str, a) -> None:
        self.sd[key] = self.tensor(a)

    def conv(self, prefix: str, p) -> None:
        self.sd[prefix + ".weight"] = self.tensor(p["kernel"]).permute(3, 2, 0, 1).contiguous()
        self.put(prefix + ".bias", p["bias"])

    def linear(self, prefix: str, p) -> None:
        self.sd[prefix + ".weight"] = self.tensor(p["kernel"]).t().contiguous()
        if "bias" in p:
            self.put(prefix + ".bias", p["bias"])

    def norm(self, prefix: str, p) -> None:
        self.put(prefix + ".weight", p["scale"])
        self.put(prefix + ".bias", p["bias"])


# a ResBlock's CompVis names, and the diffusers names of the same layers
_RES_COMPVIS = ("in_layers.0", "in_layers.2", "emb_layers.1", "out_layers.0", "out_layers.3",
                "skip_connection")
_RES_DIFFUSERS = ("norm1", "conv1", "time_emb_proj", "norm2", "conv2", "conv_shortcut")


def _unet(w: _Writer, cfg: UNetConfig, p, prefix: str, diffusers: bool = False) -> None:
    """The UNet tree under ``prefix``: CompVis keys, or with ``diffusers``
    those of a diffusers ``UNet2DConditionModel`` (down / mid / up blocks,
    one ``layers_per_block`` R: down level i's j-th block is CompVis input
    block 1 + i (R + 1) + j, up level i's output block i (R + 1) + j)."""
    res_names = _RES_DIFFUSERS if diffusers else _RES_COMPVIS

    def res(q, r):
        w.norm(f"{q}.{res_names[0]}", r["in_norm"])
        w.conv(f"{q}.{res_names[1]}", r["in_conv"])
        w.linear(f"{q}.{res_names[2]}", r["emb"])
        w.norm(f"{q}.{res_names[3]}", r["out_norm"])
        w.conv(f"{q}.{res_names[4]}", r["out_conv"])
        if "skip" in r:
            w.conv(f"{q}.{res_names[5]}", r["skip"])

    def transformer(q, t):
        w.norm(f"{q}.norm", t["norm"])
        proj = w.linear if cfg.use_linear_in_transformer else w.conv
        proj(f"{q}.proj_in", t["proj_in"])
        proj(f"{q}.proj_out", t["proj_out"])
        for d, blk in enumerate(t["blocks"]):
            b = f"{q}.transformer_blocks.{d}"
            for n in ("norm1", "norm2", "norm3"):
                w.norm(f"{b}.{n}", blk[n])
            for a in ("attn1", "attn2"):
                for n in ("to_q", "to_k", "to_v"):
                    w.linear(f"{b}.{a}.{n}", blk[a][n])
                w.linear(f"{b}.{a}.to_out.0", blk[a]["to_out"])
            w.linear(f"{b}.ff.net.0.proj", blk["ff"]["proj"])
            w.linear(f"{b}.ff.net.2", blk["ff"]["out"])

    def sublayer(desc, q, s):
        kind = desc[0]
        if kind == "conv_in":
            w.conv(q, s)
        elif kind == "down":
            w.conv(q if diffusers else f"{q}.op", s)
        elif kind == "up":
            w.conv(q if diffusers else f"{q}.conv", s)
        elif kind == "res":
            res(q, s)
        elif kind == "attn":
            transformer(q, s)
        else:
            raise ValueError(kind)

    def diffusers_name(where: str, i: int, desc, j: int) -> str:
        """The diffusers module of CompVis sublayer ``where``.i.j."""
        kind = desc[0]
        if where == "middle_block":
            return {"res": f"mid_block.resnets.{j // 2}", "attn": "mid_block.attentions.0"}[kind]
        if kind == "conv_in":
            return "conv_in"
        level, k = divmod(i - 1 if where == "input_blocks" else i, r + 1)
        blocks = "down_blocks" if where == "input_blocks" else "up_blocks"
        return {"res": f"{blocks}.{level}.resnets.{k}",
                "attn": f"{blocks}.{level}.attentions.{k}",
                "down": f"down_blocks.{level}.downsamplers.0.conv",
                "up": f"up_blocks.{level}.upsamplers.0.conv"}[kind]

    input_plan, middle_plan, output_plan = build_plan(cfg)
    if diffusers:
        if len(set(cfg.res_blocks_per_level)) != 1:
            raise ValueError("the diffusers layout has one layers_per_block; got "
                             f"{cfg.res_blocks_per_level}")
        r = cfg.res_blocks_per_level[0]
    names = (("time_embedding.linear_1", "time_embedding.linear_2", "conv_norm_out", "conv_out",
              "class_embedding.weight") if diffusers
             else ("time_embed.0", "time_embed.2", "out.0", "out.2", "label_emb.weight"))
    w.linear(f"{prefix}{names[0]}", p["time_embed"]["lin1"])
    w.linear(f"{prefix}{names[1]}", p["time_embed"]["lin2"])
    for name, plan in (("input_blocks", input_plan), ("output_blocks", output_plan)):
        for i, (block, params) in enumerate(zip(plan, p[name])):
            for j, (desc, s) in enumerate(zip(block, params)):
                q = diffusers_name(name, i, desc, j) if diffusers else f"{name}.{i}.{j}"
                sublayer(desc, prefix + q, s)
    for j, (desc, s) in enumerate(zip(middle_plan, p["middle_block"])):
        q = diffusers_name("middle_block", 0, desc, j) if diffusers else f"middle_block.{j}"
        sublayer(desc, prefix + q, s)
    w.norm(f"{prefix}{names[2]}", p["out"]["norm"])
    w.conv(f"{prefix}{names[3]}", p["out"]["conv"])
    if "label_emb" in p:
        w.put(f"{prefix}{names[4]}", p["label_emb"]["embedding"])


def _vae(w: _Writer, p, prefix: str) -> None:
    def res(q, r):
        for n in ("norm1", "norm2"):
            w.norm(f"{q}.{n}", r[n])
        for n in ("conv1", "conv2", "nin_shortcut"):
            if n in r:
                w.conv(f"{q}.{n}", r[n])

    def attn(q, a):
        w.norm(f"{q}.norm", a["norm"])
        for n in ("q", "k", "v", "proj_out"):
            w.conv(f"{q}.{n}", a[n])

    for part, levels, resample in (("encoder", "down", "downsample"),
                                   ("decoder", "up", "upsample")):
        e = p[part]
        base = f"{prefix}{part}"
        w.conv(f"{base}.conv_in", e["conv_in"])
        for lv, level in enumerate(e[levels]):
            for b, r in enumerate(level["block"]):
                res(f"{base}.{levels}.{lv}.block.{b}", r)
            for b, a in enumerate(level["attn"]):
                attn(f"{base}.{levels}.{lv}.attn.{b}", a)
            if resample in level:
                w.conv(f"{base}.{levels}.{lv}.{resample}.conv", level[resample])
        res(f"{base}.mid.block_1", e["mid"]["block_1"])
        attn(f"{base}.mid.attn_1", e["mid"]["attn_1"])
        res(f"{base}.mid.block_2", e["mid"]["block_2"])
        w.norm(f"{base}.norm_out", e["norm_out"])
        w.conv(f"{base}.conv_out", e["conv_out"])
    w.conv(f"{prefix}quant_conv", p["quant_conv"])
    w.conv(f"{prefix}post_quant_conv", p["post_quant_conv"])


def _openclip(w: _Writer, p, prefix: str) -> None:
    w.put(f"{prefix}token_embedding.weight", p["token_embedding"])
    w.put(f"{prefix}positional_embedding", p["position_embedding"])
    w.norm(f"{prefix}ln_final", p["final_ln"])
    for i, layer in enumerate(p["layers"]):
        b = f"{prefix}transformer.resblocks.{i}"
        w.norm(f"{b}.ln_1", layer["ln1"])
        w.sd[f"{b}.attn.in_proj_weight"] = torch.cat(
            [w.tensor(layer[n]["kernel"]).t() for n in ("q", "k", "v")]).contiguous()
        w.sd[f"{b}.attn.in_proj_bias"] = torch.cat(
            [w.tensor(layer[n]["bias"]) for n in ("q", "k", "v")])
        w.linear(f"{b}.attn.out_proj", layer["out"])
        w.norm(f"{b}.ln_2", layer["ln2"])
        w.linear(f"{b}.mlp.c_fc", layer["fc1"])
        w.linear(f"{b}.mlp.c_proj", layer["fc2"])
    if "text_projection" in p:
        w.put(f"{prefix}text_projection", p["text_projection"]["kernel"])


def _hf_clip(w: _Writer, p, prefix: str) -> None:
    t = f"{prefix}text_model."
    w.put(f"{t}embeddings.token_embedding.weight", p["token_embedding"])
    w.put(f"{t}embeddings.position_embedding.weight", p["position_embedding"])
    w.norm(f"{t}final_layer_norm", p["final_ln"])
    for i, layer in enumerate(p["layers"]):
        b = f"{t}encoder.layers.{i}"
        w.norm(f"{b}.layer_norm1", layer["ln1"])
        for n in ("q", "k", "v", "out"):
            w.linear(f"{b}.self_attn.{n}_proj", layer[n])
        w.norm(f"{b}.layer_norm2", layer["ln2"])
        w.linear(f"{b}.mlp.fc1", layer["fc1"])
        w.linear(f"{b}.mlp.fc2", layer["fc2"])
    if "text_projection" in p:
        w.linear(f"{prefix}text_projection", p["text_projection"])


def state_dict(
    unet_cfg: UNetConfig,
    unet: Any,
    vae: Any,
    clip: Any,
    *,
    clip_layout: str = "openclip",
    ema_unet: Optional[Any] = None,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """The CompVis state dict of the three trees (see the module
    docstring), every tensor in ``dtype`` on the CPU. ``clip_layout``:
    "openclip" (SD 2.x) or "hf" (SD 1.x); ``ema_unet``: a UNet tree written
    as the EMA shadows of ``unet``."""
    if clip_layout not in ("openclip", "hf"):
        raise ValueError(f"unknown clip_layout {clip_layout!r} (openclip|hf)")
    in_ch = unet["input_blocks"][0][0]["kernel"].shape[2]
    if in_ch != unet_cfg.in_channels:
        raise ValueError(f"the UNet tree's conv_in takes {in_ch} channels, its config "
                         f"{unet_cfg.in_channels}")
    w = _Writer(dtype)
    _unet(w, unet_cfg, unet, "model.diffusion_model.")
    _vae(w, vae, "first_stage_model.")
    if clip_layout == "openclip":
        _openclip(w, clip, "cond_stage_model.model.")
    else:
        _hf_clip(w, clip, "cond_stage_model.transformer.")
    if ema_unet is not None:
        shadow = _Writer(dtype)
        _unet(shadow, unet_cfg, ema_unet, "model.diffusion_model.")
        for k, v in shadow.sd.items():
            w.sd["model_ema." + k[len("model."):].replace(".", "")] = v
        w.sd["model_ema.decay"] = torch.tensor(0.9999, dtype=torch.float32)
        w.sd["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    return w.sd


def compvis_unet_state_dict(unet_cfg: UNetConfig, unet: Any, *,
                            prefix: str = "model.diffusion_model.",
                            dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The UNet tree alone under CompVis keys (what :func:`state_dict`
    writes for it), every tensor in ``dtype`` on the CPU:
    ``models.params.convert_unet`` reads it back to the tree."""
    w = _Writer(dtype)
    _unet(w, unet_cfg, unet, prefix)
    return w.sd


def diffusers_unet_state_dict(unet_cfg: UNetConfig, unet: Any, *, prefix: str = "",
                              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The UNet tree as a diffusers ``UNet2DConditionModel`` state dict
    under ``prefix``, every tensor in ``dtype`` on the CPU:
    ``models.params.convert_unet_diffusers`` reads it back to the tree."""
    w = _Writer(dtype)
    _unet(w, unet_cfg, unet, prefix, diffusers=True)
    return w.sd


def hf_t5_state_dict(t5, *, prefix: str = "encoder.",
                     dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A T5 encoder tree (``models.embedders.init_t5_encoder``'s layout) as
    an HF ``T5EncoderModel`` state dict: ``shared.weight`` and its tied
    ``{prefix}embed_tokens.weight``, the layer-0 relative attention bias,
    every block's ``layer.0`` (layer_norm, SelfAttention q/k/v/o) and
    ``layer.1`` (layer_norm, DenseReluDense wi_0/wi_1/wo), and
    ``{prefix}final_layer_norm``; linears as torch ``[out, in]`` weights.
    ``models.embedders.convert_t5_hf`` reads it back to the tree."""
    w = _Writer(dtype)
    w.put("shared.weight", t5["token_embedding"])
    w.put(f"{prefix}embed_tokens.weight", t5["token_embedding"])
    w.put(f"{prefix}block.0.layer.0.SelfAttention.relative_attention_bias.weight",
          t5["relative_bias"])
    for i, layer in enumerate(t5["layers"]):
        b = f"{prefix}block.{i}.layer"
        w.put(f"{b}.0.layer_norm.weight", layer["ln1"])
        for n in ("q", "k", "v", "o"):
            w.linear(f"{b}.0.SelfAttention.{n}", layer[n])
        w.put(f"{b}.1.layer_norm.weight", layer["ln2"])
        for n in ("wi_0", "wi_1", "wo"):
            w.linear(f"{b}.1.DenseReluDense.{n}", layer[n])
    w.put(f"{prefix}final_layer_norm.weight", t5["final_ln"])
    return w.sd


def write_checkpoint(path: str, sd: Dict[str, torch.Tensor]) -> int:
    """Save ``sd`` as a CompVis ``.ckpt`` (``{"state_dict": sd}``); returns
    the file's size in bytes."""
    torch.save({"state_dict": sd}, path)
    return os.path.getsize(path)
