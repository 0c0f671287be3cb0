"""Checkpoint loading: torch / safetensors state dicts -> parameter trees.

Counterpart of ``complex_prompt_diffusion_tpu/models/params.py``, in numpy:
the trees it returns are the JAX package's, leaf for leaf (conv kernels
HWIO, linears ``[in, out]``, norms ``{scale, bias}``, f32 numpy), and
``convert.py`` turns them into the port's layout. CompVis single-file
layout:

  * ``model.diffusion_model.*``        -> UNet
  * ``first_stage_model.*``            -> VAE (AutoencoderKL)
  * ``cond_stage_model.transformer.*`` -> HF CLIP text (SD 1.x)
  * ``cond_stage_model.model.*``       -> OpenCLIP text (SD 2.x; the packed
    ``attn.in_proj_weight`` is split into q, k and v)

``.ckpt`` / ``.pt`` files are read with ``torch.load``; ``.safetensors``
files with :func:`read_safetensors`, a reader of the format's own (an
8-byte little-endian header length, a JSON header of dtype, shape and
offsets, then the raw bytes), so no safetensors package is needed.

``convert_clip_vision_hf`` reads the guide CLIP's vision tower from HF's
``CLIPVisionModelWithProjection`` layout. ``attach_hypernetwork`` adds
AUTOMATIC1111-style hypernetwork modules to the cross-attention sites of a
UNet tree (the JAX package's numpy tree or the port's tensor tree).
``make_it_fit`` and ``zero_extend_input_conv`` are the weight surgery of
the concat models' finetune seeding, on raw state dicts.
``convert_unet_diffusers`` reads a diffusers ``UNet2DConditionModel``
state dict: :func:`diffusers_to_compvis_unet` relabels its keys to the
CompVis layout, then :func:`convert_unet` maps them, as the JAX package
does.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import re
import struct
from typing import Any, Dict, Mapping

import numpy as np

from complex_prompt_diffusion_tpu_torch.models.clip import CLIPTextConfig
from complex_prompt_diffusion_tpu_torch.models.unet import UNetConfig, build_plan
from complex_prompt_diffusion_tpu_torch.models.vae import VAEConfig

__all__ = [
    "read_safetensors",
    "load_state_dict",
    "convert_unet",
    "diffusers_to_compvis_unet",
    "convert_unet_diffusers",
    "convert_vae",
    "convert_clip_hf",
    "convert_clip_openclip",
    "convert_clip_vision_hf",
    "attach_hypernetwork",
    "apply_ema_weights",
    "make_it_fit",
    "zero_extend_input_conv",
    "detect_sd_version",
    "load_sd_checkpoint",
]

Array = np.ndarray
StateDict = Mapping[str, Array]

# safetensors dtype tags -> little-endian numpy dtypes; BF16 is read as its
# 16 bits and widened to f32
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: str) -> Dict[str, Array]:
    """Every tensor of a ``.safetensors`` file as f32 numpy (a copy; the
    file is closed on return). Raises ValueError on a malformed file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", head)
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable safetensors header") from e
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            data_len = len(mm) - 8 - n
            out = {}
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dt = _ST_DTYPES.get(info.get("dtype"))
                if dt is None:
                    raise ValueError(f"{path}: {name} has unsupported dtype {info.get('dtype')!r}")
                begin, end = info["data_offsets"]
                shape = tuple(info["shape"])
                count = int(np.prod(shape, dtype=np.int64))
                size = count * np.dtype(dt).itemsize
                if not 0 <= begin <= end <= data_len or end - begin != size:
                    raise ValueError(f"{path}: {name} offsets {begin}..{end} do not hold "
                                     f"{shape} {info['dtype']}")
                a = np.frombuffer(mm, dtype=dt, count=count, offset=8 + n + begin)
                if info["dtype"] == "BF16":
                    a = (a.astype(np.uint32) << 16).view(np.float32)
                out[name] = a.astype(np.float32).reshape(shape)
                del a  # no view of the mapping may outlive it
    return out


def load_state_dict(path: str) -> Dict[str, Array]:
    """Read a torch .ckpt/.pt (pickle; its ``state_dict`` if it has one) or
    a .safetensors file into f32 numpy, as the JAX package does. A pickle
    runs code when it is read: load only files from a trusted source."""
    if path.endswith(".safetensors"):
        raw = read_safetensors(path)
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        raw = {k: v.float().numpy() for k, v in obj.items() if hasattr(v, "numpy")}
    return {k: np.asarray(v, dtype=np.float32) for k, v in raw.items()}


def _conv(sd: StateDict, prefix: str) -> Dict[str, Array]:
    w = sd[prefix + ".weight"]
    return {
        "kernel": np.transpose(w, (2, 3, 1, 0)),  # OIHW -> HWIO
        "bias": sd[prefix + ".bias"],
    }


def _linear(sd: StateDict, prefix: str, bias: bool = True) -> Dict[str, Array]:
    p = {"kernel": sd[prefix + ".weight"].T}
    if bias:
        p["bias"] = sd[prefix + ".bias"]
    return p


def _norm(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


# --------------------------------------------------------------------------
# UNet (CompVis model.diffusion_model.* layout)
# --------------------------------------------------------------------------


def _convert_res(sd: StateDict, p: str) -> Dict[str, Any]:
    out = {
        "in_norm": _norm(sd, f"{p}.in_layers.0"),
        "in_conv": _conv(sd, f"{p}.in_layers.2"),
        "emb": _linear(sd, f"{p}.emb_layers.1"),
        "out_norm": _norm(sd, f"{p}.out_layers.0"),
        "out_conv": _conv(sd, f"{p}.out_layers.3"),
    }
    if f"{p}.skip_connection.weight" in sd:
        out["skip"] = _conv(sd, f"{p}.skip_connection")
    return out


def _convert_spatial_transformer(
    sd: StateDict, p: str, depth: int, use_linear: bool
) -> Dict[str, Any]:
    proj = _linear if use_linear else _conv
    blocks = []
    for d in range(depth):
        b = f"{p}.transformer_blocks.{d}"

        def attn(name):
            return {
                "to_q": _linear(sd, f"{b}.{name}.to_q", bias=False),
                "to_k": _linear(sd, f"{b}.{name}.to_k", bias=False),
                "to_v": _linear(sd, f"{b}.{name}.to_v", bias=False),
                "to_out": _linear(sd, f"{b}.{name}.to_out.0"),
            }

        blocks.append(
            {
                "norm1": _norm(sd, f"{b}.norm1"),
                "attn1": attn("attn1"),
                "norm2": _norm(sd, f"{b}.norm2"),
                "attn2": attn("attn2"),
                "norm3": _norm(sd, f"{b}.norm3"),
                "ff": {
                    "proj": _linear(sd, f"{b}.ff.net.0.proj"),
                    "out": _linear(sd, f"{b}.ff.net.2"),
                },
            }
        )
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "proj_in": proj(sd, f"{p}.proj_in"),
        "proj_out": proj(sd, f"{p}.proj_out"),
        "blocks": blocks,
    }


def convert_unet(
    cfg: UNetConfig, sd: StateDict, prefix: str = "model.diffusion_model."
) -> Dict[str, Any]:
    """Map CompVis UNet keys onto the plan of :func:`build_plan`."""
    input_plan, middle_plan, output_plan = build_plan(cfg)

    def convert_sublayer(desc, p: str):
        kind = desc[0]
        if kind == "down":
            return _conv(sd, f"{p}.op")
        if kind == "up":
            return _conv(sd, f"{p}.conv")
        if kind == "conv_in":
            return _conv(sd, p)
        if kind == "res":
            return _convert_res(sd, p)
        if kind == "attn":
            return _convert_spatial_transformer(sd, p, desc[4], cfg.use_linear_in_transformer)
        raise ValueError(kind)

    params: Dict[str, Any] = {
        "time_embed": {
            "lin1": _linear(sd, f"{prefix}time_embed.0"),
            "lin2": _linear(sd, f"{prefix}time_embed.2"),
        },
        "input_blocks": [
            [convert_sublayer(desc, f"{prefix}input_blocks.{i}.{j}")
             for j, desc in enumerate(block)]
            for i, block in enumerate(input_plan)
        ],
        "middle_block": [
            convert_sublayer(desc, f"{prefix}middle_block.{j}")
            for j, desc in enumerate(middle_plan)
        ],
        "output_blocks": [
            [convert_sublayer(desc, f"{prefix}output_blocks.{i}.{j}")
             for j, desc in enumerate(block)]
            for i, block in enumerate(output_plan)
        ],
        "out": {
            "norm": _norm(sd, f"{prefix}out.0"),
            "conv": _conv(sd, f"{prefix}out.2"),
        },
    }
    if cfg.num_classes and f"{prefix}label_emb.weight" in sd:
        params["label_emb"] = {"embedding": sd[f"{prefix}label_emb.weight"]}
    return params


# --------------------------------------------------------------------------
# Diffusers UNet layout (UNet2DConditionModel): relabelled key by key to the
# CompVis layout, then through convert_unet
# --------------------------------------------------------------------------

_DIFFUSERS_RES_MAP = {
    "norm1": "in_layers.0",
    "conv1": "in_layers.2",
    "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0",
    "conv2": "out_layers.3",
    "conv_shortcut": "skip_connection",
}


def diffusers_to_compvis_unet(sd: StateDict, prefix: str = "") -> Dict[str, Array]:
    """A diffusers ``UNet2DConditionModel`` state dict under CompVis
    ``model.diffusion_model``-style keys (without that prefix); entries
    under ``prefix`` only, when given. The values are passed through as
    they are.

    Blocks: input_blocks[0] is conv_in; down level i gives R resnets (and
    attentions) at 1 + i (R + 1) + j and its downsampler at 1 + i (R + 1) +
    R; an up level has R + 1 resnets, its upsampler an extra sublayer of
    the level's last block (after the attention where the level has one).
    Keys of no parameter the map knows (time_proj buffers) are dropped; a
    dict with no ``down_blocks.*`` raises ValueError."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    r = -1  # layers_per_block, and the up levels with attention
    up_attn_levels = set()
    for k in sd:
        m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.", k)
        if m:
            r = max(r, int(m.group(2)) + 1)
        m = re.match(r"up_blocks\.(\d+)\.attentions\.", k)
        if m:
            up_attn_levels.add(int(m.group(1)))
    if r <= 0:
        raise ValueError("not a diffusers UNet state_dict (no down_blocks.*)")

    def res_key(base, rest):
        head, _, tail = rest.partition(".")
        return f"{base}.{_DIFFUSERS_RES_MAP[head]}.{tail}"

    simple = {"conv_in.": "input_blocks.0.0", "time_embedding.linear_1.": "time_embed.0",
              "time_embedding.linear_2.": "time_embed.2", "class_embedding.": "label_emb",
              "conv_norm_out.": "out.0", "conv_out.": "out.2"}
    out: Dict[str, Array] = {}
    for k, v in sd.items():
        parts = k.split(".")
        head = next((h for h in simple if k.startswith(h)), None)
        if head is not None:
            nk = f"{simple[head]}.{parts[-1]}"
        elif parts[0] in ("down_blocks", "up_blocks"):
            i, kind, j = int(parts[1]), parts[2], int(parts[3])
            rest = ".".join(parts[4:])
            if parts[0] == "down_blocks":
                block = f"input_blocks.{1 + i * (r + 1) + j}"
                if kind == "resnets":
                    nk = res_key(f"{block}.0", rest)
                elif kind == "attentions":
                    nk = f"{block}.1.{rest}"
                elif kind == "downsamplers":
                    nk = f"input_blocks.{1 + i * (r + 1) + r}.0.op.{parts[-1]}"
                else:
                    raise ValueError(f"unknown down_blocks entry {k!r}")
            else:
                block = f"output_blocks.{i * (r + 1) + j}"
                if kind == "resnets":
                    nk = res_key(f"{block}.0", rest)
                elif kind == "attentions":
                    nk = f"{block}.1.{rest}"
                elif kind == "upsamplers":
                    sub = 2 if i in up_attn_levels else 1
                    nk = f"output_blocks.{i * (r + 1) + r}.{sub}.conv.{parts[-1]}"
                else:
                    raise ValueError(f"unknown up_blocks entry {k!r}")
        elif parts[0] == "mid_block":
            kind, j = parts[1], int(parts[2])
            rest = ".".join(parts[3:])
            if kind == "resnets":
                nk = res_key(f"middle_block.{0 if j == 0 else 2}", rest)
            elif kind == "attentions":
                nk = f"middle_block.1.{rest}"
            else:
                raise ValueError(f"unknown mid_block entry {k!r}")
        else:
            continue  # no parameter (time_proj buffers and the like)
        out[nk] = v
    return out


def convert_unet_diffusers(cfg: UNetConfig, sd: StateDict, prefix: str = "") -> Dict[str, Any]:
    """A diffusers-layout UNet state dict as the UNet tree of ``cfg``'s
    plan (:func:`diffusers_to_compvis_unet`, then :func:`convert_unet`)."""
    return convert_unet(cfg, diffusers_to_compvis_unet(sd, prefix), prefix="")


# --------------------------------------------------------------------------
# VAE (first_stage_model.* layout)
# --------------------------------------------------------------------------


def _convert_vae_res(sd: StateDict, p: str) -> Dict[str, Any]:
    out = {
        "norm1": _norm(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, f"{p}.nin_shortcut")
    return out


def _convert_vae_attn(sd: StateDict, p: str) -> Dict[str, Any]:
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "q": _conv(sd, f"{p}.q"),
        "k": _conv(sd, f"{p}.k"),
        "v": _conv(sd, f"{p}.v"),
        "proj_out": _conv(sd, f"{p}.proj_out"),
    }


def _convert_vae_level(sd: StateDict, base: str, n_blocks: int, resample: str):
    level: Dict[str, Any] = {
        "block": [_convert_vae_res(sd, f"{base}.block.{b}") for b in range(n_blocks)],
        "attn": [],
    }
    b = 0
    while f"{base}.attn.{b}.q.weight" in sd:
        level["attn"].append(_convert_vae_attn(sd, f"{base}.attn.{b}"))
        b += 1
    if f"{base}.{resample}.conv.weight" in sd:
        level[resample] = _conv(sd, f"{base}.{resample}.conv")
    return level


def convert_vae(
    cfg: VAEConfig, sd: StateDict, prefix: str = "first_stage_model."
) -> Dict[str, Any]:
    n_levels = len(cfg.ch_mult)

    def mid(part):
        return {
            "block_1": _convert_vae_res(sd, f"{prefix}{part}.mid.block_1"),
            "attn_1": _convert_vae_attn(sd, f"{prefix}{part}.mid.attn_1"),
            "block_2": _convert_vae_res(sd, f"{prefix}{part}.mid.block_2"),
        }

    enc = {
        "conv_in": _conv(sd, f"{prefix}encoder.conv_in"),
        "down": [_convert_vae_level(sd, f"{prefix}encoder.down.{lv}", cfg.num_res_blocks,
                                    "downsample") for lv in range(n_levels)],
        "mid": mid("encoder"),
        "norm_out": _norm(sd, f"{prefix}encoder.norm_out"),
        "conv_out": _conv(sd, f"{prefix}encoder.conv_out"),
    }
    dec = {
        "conv_in": _conv(sd, f"{prefix}decoder.conv_in"),
        "mid": mid("decoder"),
        "up": [_convert_vae_level(sd, f"{prefix}decoder.up.{lv}", cfg.num_res_blocks + 1,
                                  "upsample") for lv in range(n_levels)],
        "norm_out": _norm(sd, f"{prefix}decoder.norm_out"),
        "conv_out": _conv(sd, f"{prefix}decoder.conv_out"),
    }
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, f"{prefix}quant_conv"),
        "post_quant_conv": _conv(sd, f"{prefix}post_quant_conv"),
    }


# --------------------------------------------------------------------------
# CLIP text towers
# --------------------------------------------------------------------------


def convert_clip_hf(
    cfg: CLIPTextConfig,
    sd: StateDict,
    prefix: str = "cond_stage_model.transformer.",
) -> Dict[str, Any]:
    """HF CLIPTextModel layout (SD 1.x)."""
    t = f"{prefix}text_model."
    params: Dict[str, Any] = {
        "token_embedding": sd[f"{t}embeddings.token_embedding.weight"],
        "position_embedding": sd[f"{t}embeddings.position_embedding.weight"],
        "layers": [],
        "final_ln": _norm(sd, f"{t}final_layer_norm"),
    }
    for i in range(cfg.num_layers):
        b = f"{t}encoder.layers.{i}"
        params["layers"].append(
            {
                "ln1": _norm(sd, f"{b}.layer_norm1"),
                "q": _linear(sd, f"{b}.self_attn.q_proj"),
                "k": _linear(sd, f"{b}.self_attn.k_proj"),
                "v": _linear(sd, f"{b}.self_attn.v_proj"),
                "out": _linear(sd, f"{b}.self_attn.out_proj"),
                "ln2": _norm(sd, f"{b}.layer_norm2"),
                "fc1": _linear(sd, f"{b}.mlp.fc1"),
                "fc2": _linear(sd, f"{b}.mlp.fc2"),
            }
        )
    if f"{prefix}text_projection.weight" in sd:
        params["text_projection"] = _linear(sd, f"{prefix}text_projection", bias=False)
    return params


def convert_clip_openclip(
    cfg: CLIPTextConfig, sd: StateDict, prefix: str = "cond_stage_model.model."
) -> Dict[str, Any]:
    """OpenCLIP text-tower layout (SD 2.x): packed in_proj qkv, c_fc/c_proj."""
    d = cfg.hidden_size
    params: Dict[str, Any] = {
        "token_embedding": sd[f"{prefix}token_embedding.weight"],
        "position_embedding": sd[f"{prefix}positional_embedding"],
        "layers": [],
        "final_ln": _norm(sd, f"{prefix}ln_final"),
    }
    for i in range(cfg.num_layers):
        b = f"{prefix}transformer.resblocks.{i}"
        w = sd[f"{b}.attn.in_proj_weight"]  # [3d, d]
        bias = sd[f"{b}.attn.in_proj_bias"]  # [3d]
        params["layers"].append(
            {
                "ln1": _norm(sd, f"{b}.ln_1"),
                "q": {"kernel": w[:d].T, "bias": bias[:d]},
                "k": {"kernel": w[d: 2 * d].T, "bias": bias[d: 2 * d]},
                "v": {"kernel": w[2 * d:].T, "bias": bias[2 * d:]},
                "out": _linear(sd, f"{b}.attn.out_proj"),
                "ln2": _norm(sd, f"{b}.ln_2"),
                "fc1": _linear(sd, f"{b}.mlp.c_fc"),
                "fc2": _linear(sd, f"{b}.mlp.c_proj"),
            }
        )
    if f"{prefix}text_projection" in sd:
        params["text_projection"] = {"kernel": sd[f"{prefix}text_projection"]}
    return params


def convert_clip_vision_hf(cfg, sd: StateDict, prefix: str = "") -> Dict[str, Any]:
    """HF ``CLIPVisionModelWithProjection`` layout (the guide CLIP's image
    encoder); ``cfg``: ``CLIPVisionConfig``. The patch embedding's torch
    conv weight [O, I, kh, kw] becomes the JAX package's HWIO kernel
    (``convert.clip_vision_params`` makes it the port's [O, I, kh, kw]
    again); the pre-LN is read under HF's spelling ``pre_layrnorm`` or
    ``pre_layernorm``."""
    v = f"{prefix}vision_model."
    pre = f"{v}pre_layrnorm" if f"{v}pre_layrnorm.weight" in sd else f"{v}pre_layernorm"
    params: Dict[str, Any] = {
        "class_embedding": sd[f"{v}embeddings.class_embedding"],
        "patch_embedding": np.transpose(sd[f"{v}embeddings.patch_embedding.weight"],
                                        (2, 3, 1, 0)),
        "position_embedding": sd[f"{v}embeddings.position_embedding.weight"],
        "pre_ln": _norm(sd, pre),
        "layers": [],
        "post_ln": _norm(sd, f"{v}post_layernorm"),
    }
    for i in range(cfg.num_layers):
        b = f"{v}encoder.layers.{i}"
        params["layers"].append(
            {
                "ln1": _norm(sd, f"{b}.layer_norm1"),
                "q": _linear(sd, f"{b}.self_attn.q_proj"),
                "k": _linear(sd, f"{b}.self_attn.k_proj"),
                "v": _linear(sd, f"{b}.self_attn.v_proj"),
                "out": _linear(sd, f"{b}.self_attn.out_proj"),
                "ln2": _norm(sd, f"{b}.layer_norm2"),
                "fc1": _linear(sd, f"{b}.mlp.fc1"),
                "fc2": _linear(sd, f"{b}.mlp.fc2"),
            }
        )
    if f"{prefix}visual_projection.weight" in sd:
        params["visual_projection"] = _linear(sd, f"{prefix}visual_projection", bias=False)
    return params


# --------------------------------------------------------------------------
# hypernetworks
# --------------------------------------------------------------------------


def _hyper_by_dim(hyper_sd) -> Dict[int, Dict[str, Dict[str, Any]]]:
    """{dim: {"k" | "v": {"linear1", "linear2"}}} from the nested layout
    (linears as ``{"kernel": [in, out], "bias"}``) or the flat one
    (``"<dim>.<k|v>.<linear1|linear2>.<weight|bias>"``, torch [out, in]
    weights); a slot without both linears raises ValueError."""
    by_dim: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for k, v in hyper_sd.items():
        if isinstance(v, dict):
            by_dim[int(k)] = v
        else:
            dim, kv, lin, kind = str(k).split(".")
            slot = by_dim.setdefault(int(dim), {}).setdefault(kv, {}).setdefault(lin, {})
            slot["kernel" if kind == "weight" else "bias"] = v.T if kind == "weight" else v
    for dim, kvs in by_dim.items():
        for kv, mlp in kvs.items():
            missing = {"linear1", "linear2"} - set(mlp)
            if missing:
                raise ValueError(
                    f"hypernetwork for dim {dim} slot {kv!r} is missing {sorted(missing)} "
                    "(each slot needs linear1 + linear2 weight/bias pairs)"
                )
    return by_dim


def _copy_tree(tree):
    """The dicts and lists of a tree copied, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def attach_hypernetwork(unet_params, hyper_sd, multiplier: float = 1.0):
    """A new UNet tree with AUTOMATIC1111-style hypernetwork modules
    ("hyper_k" / "hyper_v": ``{linear1, linear2, multiplier}``) on every
    cross-attention site whose context width has weights in ``hyper_sd``
    (:func:`_hyper_by_dim`'s layouts), as the JAX package attaches them.
    The UNet applies ``z + linear2(linear1(z)) * multiplier`` to the
    context before that site's k or v projection. On the JAX package's
    tree the modules are added as given (the multiplier a Python float);
    on the port's tensor tree they become tensors on the site's device in
    f32 (the multiplier an f32 scalar, as ``convert.to_port`` makes it).
    The input tree's leaves are shared, not copied."""
    import torch

    from complex_prompt_diffusion_tpu_torch import convert

    by_dim = _hyper_by_dim(hyper_sd)
    params = _copy_tree(unet_params)

    def visit(blocks):
        for block in blocks:
            for layer in block if isinstance(block, list) else [block]:
                if not isinstance(layer, dict) or "blocks" not in layer:
                    continue
                for tb in layer["blocks"]:
                    attn2 = tb["attn2"]
                    kernel = attn2["to_k"]["kernel"]
                    dim = kernel.shape[0]
                    for kv, name in (("k", "hyper_k"), ("v", "hyper_v")):
                        if kv not in by_dim.get(dim, {}):
                            continue
                        mlp = by_dim[dim][kv]
                        mod = {"linear1": mlp["linear1"], "linear2": mlp["linear2"],
                               "multiplier": multiplier}
                        if isinstance(kernel, torch.Tensor):
                            mod = convert.to_port(mod, kernel.device, torch.float32)
                        attn2[name] = mod

    visit(params["input_blocks"])
    visit([params["middle_block"]])
    visit(params["output_blocks"])
    return params


# --------------------------------------------------------------------------
# whole-checkpoint entry point
# --------------------------------------------------------------------------


def apply_ema_weights(sd: Dict[str, Array]) -> Dict[str, Array]:
    """Swap UNet weights for their EMA shadows when the checkpoint carries
    them (LitEma buffers: ``model_ema.`` + the parameter's name after
    ``model.`` with its dots removed)."""
    if not any(k.startswith("model_ema.") for k in sd):
        return sd
    out = dict(sd)
    prefix = "model.diffusion_model."
    for k in sd:
        if k.startswith(prefix):
            ema_key = "model_ema." + k[len("model."):].replace(".", "")
            if ema_key in sd:
                out[k] = sd[ema_key]
    return out


def make_it_fit(sd: StateDict, target_shapes: Dict[str, tuple]) -> Dict[str, Array]:
    """Fit checkpoint weights onto a model whose first two (torch-layout:
    out, in) axes differ, e.g. a 9-channel inpaint UNet's input conv from a
    4-channel checkpoint: each leaf of ``target_shapes`` that ``sd`` holds
    with another shape is tiled cyclically over those axes and, for >= 2-D
    weights, divided by an input-usage count so the layer's output scale
    holds. Raw torch-layout state dict; trailing (spatial) axes must match.

    The reference's counter starts at 1, not 0, so each count is 1 + the
    real uses; kept, as the JAX package keeps it: a weight whose input dim
    is unchanged while its output dim grows is halved."""
    out = dict(sd)
    for name, want in target_shapes.items():
        if name not in sd:
            continue
        old = np.asarray(sd[name])
        want = tuple(want)
        if old.shape == want:
            continue
        if len(old.shape) != len(want):
            raise ValueError(f"{name}: rank mismatch {old.shape} -> {want} "
                             "(make_it_fit only adapts same-rank weights)")
        if len(want) > 2 and old.shape[2:] != want[2:]:
            raise ValueError(f"{name}: trailing axes must match ({old.shape} -> {want})")
        idx0 = np.arange(want[0]) % old.shape[0]
        if old.ndim == 1:
            out[name] = old[idx0]
            continue
        idx1 = np.arange(want[1]) % old.shape[1]
        new = old[idx0][:, idx1]
        n_used_old = np.ones(old.shape[1])
        np.add.at(n_used_old, idx1, 1)
        n_used_new = n_used_old[idx1]
        new = new / n_used_new.reshape((1, -1) + (1,) * (old.ndim - 2))
        out[name] = new.astype(old.dtype)
    return out


def zero_extend_input_conv(sd: StateDict, new_in_channels: int,
                           keep_dims: int = 4) -> Dict[str, Array]:
    """Widen the UNet's input conv (and its EMA shadow) to
    ``new_in_channels``, keeping the checkpoint's first ``keep_dims`` input
    channels and zeroing the new ones, so the seeded concat model at first
    ignores its conditioning and reproduces the base model. Raw
    torch-layout [out, in, kh, kw] state dict."""
    key = "model.diffusion_model.input_blocks.0.0.weight"
    ema_key = "model_ema.diffusion_modelinput_blocks00weight"
    out = dict(sd)
    for k in (key, ema_key):
        if k not in sd:
            continue
        old = np.asarray(sd[k])
        if old.shape[1] >= new_in_channels:
            continue
        new = np.zeros((old.shape[0], new_in_channels) + old.shape[2:], old.dtype)
        new[:, :keep_dims] = old[:, :keep_dims]
        out[k] = new
    return out


def detect_sd_version(sd: StateDict) -> str:
    """"sd2" if the checkpoint carries an OpenCLIP tower, else "sd1"."""
    if any(k.startswith("cond_stage_model.model.") for k in sd):
        return "sd2"
    return "sd1"


def load_sd_checkpoint(path: str, use_ema: bool = False):
    """Load a CompVis SD checkpoint: {"version", "unet": (cfg, params),
    "vae": (cfg, params), "clip": (cfg, params)}, the configs the presets
    the JAX package picks (SD 2.x: ``UNetConfig.sd21``, or ``sd2_depth`` for
    a 5-channel input; SD 1.x: ``sd15``, or ``sd_inpaint`` for 9 channels;
    another input width replaces the preset's). ``use_ema``: prefer the
    EMA shadow weights where present."""
    sd = load_state_dict(path)
    if use_ema:
        sd = apply_ema_weights(sd)
    version = detect_sd_version(sd)
    in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    if version == "sd2":
        unet_cfg = UNetConfig.sd2_depth() if in_ch == 5 else UNetConfig.sd21()
        clip_cfg = CLIPTextConfig.sd21()
        clip_params = convert_clip_openclip(clip_cfg, sd)
    else:
        unet_cfg = UNetConfig.sd_inpaint() if in_ch == 9 else UNetConfig.sd15()
        clip_cfg = CLIPTextConfig.sd15()
        clip_params = convert_clip_hf(clip_cfg, sd)
    if unet_cfg.in_channels != in_ch:
        # non-standard concat widths (finetune variants) follow the checkpoint
        unet_cfg = dataclasses.replace(unet_cfg, in_channels=in_ch)
    vae_cfg = VAEConfig.sd()
    return {
        "version": version,
        "unet": (unet_cfg, convert_unet(unet_cfg, sd)),
        "vae": (vae_cfg, convert_vae(vae_cfg, sd)),
        "clip": (clip_cfg, clip_params),
    }
