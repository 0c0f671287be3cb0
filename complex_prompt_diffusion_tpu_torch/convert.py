"""Weight bridge: the JAX package's parameter trees -> the port's tensors.

The JAX package keeps parameters as nested dicts/lists of arrays with conv
kernels in HWIO and linears as ``[in, out]``. The port keeps the same tree
with two changes of layout:

  * a conv ``{"kernel": [KH, KW, I, O], "bias"}`` becomes
    ``{"weight": [O, I, KH, KW] in channels_last memory, "bias"}`` — what
    ``F.conv2d`` takes on the NCHW view of an NHWC activation;
  * a linear ``{"kernel": [in, out], "bias"}`` stays as it is (``x @ kernel``;
    the K2 GEGLU kernel reads W1/W2 in that row-major layout).

Leaves may be numpy arrays, anything ``np.asarray`` accepts (JAX arrays,
without importing jax here) or torch tensors, so the port's own random
init and checkpoint loader (both build the JAX layout) go through the same
function. A Python float leaf (a hypernetwork's ``multiplier``) becomes an
f32 scalar tensor, as JAX puts it on the device; a ``dtype`` casts it with
the rest, as the JAX bundle's ``cast`` does. The CLIP vision tower's bare
``patch_embedding`` kernel (HWIO) becomes ``[D, 3, p, p]``
(:func:`clip_vision_params`). :func:`embedder_params` carries the T5 and
transformer text encoders' trees. :func:`tables_from` carries a bundle's diffusion tables across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["to_port", "unet_params", "vae_params", "clip_params", "clip_vision_params",
           "embedder_params", "config_from", "tables_from"]


def _leaf(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    if isinstance(a, float):
        a = torch.tensor(a, dtype=torch.float32)
    elif not isinstance(a, torch.Tensor):
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin
            a = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            a = torch.from_numpy(np.array(arr, order="C"))  # a copy, row-major
    a = a.to(device)
    if dtype is not None and a.is_floating_point():
        a = a.to(dtype)
    return a


def to_port(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Convert a JAX-layout parameter tree (see module docstring)."""
    if isinstance(tree, dict):
        if "kernel" in tree and np.ndim(tree["kernel"]) == 4:
            w = _leaf(tree["kernel"], device, dtype).permute(3, 2, 0, 1)
            out = {"weight": w.contiguous(memory_format=torch.channels_last)}
            out.update(
                {k: to_port(v, device, dtype) for k, v in tree.items() if k != "kernel"}
            )
            return out
        return {k: to_port(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_port(v, device, dtype) for v in tree]
    return _leaf(tree, device, dtype)


def unet_params(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    return to_port(tree, device, dtype)


_VAE_KEYS = ("encoder", "decoder", "quant_conv", "post_quant_conv", "quantize")


def vae_params(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """The first stage's tree: encoder, decoder, quant_conv and
    post_quant_conv, and a VQ model's ``quantize`` codebook where the tree
    has one (kept f32 whatever ``dtype``: ``vq_quantize`` measures
    distances in f32)."""
    out = to_port({k: tree[k] for k in _VAE_KEYS if k != "quantize"}, device, dtype)
    if "quantize" in tree:
        out["quantize"] = to_port(tree["quantize"], device, torch.float32)
    return out


def clip_params(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    return to_port(tree, device, dtype)


def clip_vision_params(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """The CLIP vision tower's tree: the HWIO patch-embedding kernel [p, p,
    3, D] as ``F.conv2d``'s weight [D, 3, p, p], every other leaf as
    :func:`to_port` converts it."""
    out = to_port({k: v for k, v in tree.items() if k != "patch_embedding"}, device, dtype)
    w = _leaf(tree["patch_embedding"], device, dtype)
    out["patch_embedding"] = w.permute(3, 2, 0, 1).contiguous()
    return out


def embedder_params(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A T5 encoder's or a transformer text encoder's tree
    (``models/embedders.py``): the same layout in both packages (linears
    ``[in, out]``, norms, the GRU gates' ``[3d, d]`` weights), every leaf
    a tensor on ``device``."""
    return to_port(tree, device, dtype)


def config_from(cls, cfg, **overrides):
    """The port's config dataclass ``cls`` from any config object (e.g. the
    JAX package's) with same-named fields; tuples are kept as tuples.

    A field of ``cfg`` that ``cls`` lacks must hold its own class's default
    (read from ``dataclasses.fields(type(cfg))`` when ``cfg`` is a
    dataclass): anything else is a mode the port does not have (ToMe's
    ``tome_ratio > 0``, say), and raises ValueError rather than convert to
    a different model. ``use_pallas`` is the exception: its value maps to
    ``attn_route`` (``"cm"`` -> ``"cm"``; None, True and False pick a route
    with the same result and map to nothing). ``overrides`` win."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {name: getattr(cfg, name) for name in names if hasattr(cfg, name)}
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(type(cfg)):
            if f.name in names:
                continue
            value = getattr(cfg, f.name)
            if f.name == "use_pallas" and "attn_route" in names:
                if isinstance(value, str) and value == "cm":
                    kw["attn_route"] = "cm"
                elif not (value is None or value is True or value is False):
                    raise ValueError(f"use_pallas={value!r} has no counterpart in the port "
                                     f"(None, True, False or 'cm')")
                continue
            if f.default is not dataclasses.MISSING:
                default = f.default
            elif f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            else:
                default = dataclasses.MISSING
            if default is dataclasses.MISSING or value != default:
                raise ValueError(
                    f"{type(cfg).__name__}.{f.name}={value!r} (default {default!r}) has no "
                    f"counterpart in the port's {cls.__name__}: converting would drop it")
    kw.update(overrides)
    return cls(**kw)


def tables_from(tables):
    """The port's ``DiffusionTables`` from any object with its fields (the
    JAX package's tables, say), each read as a numpy array as it is."""
    from complex_prompt_diffusion_tpu_torch.schedules import DiffusionTables

    return DiffusionTables(**{f.name: np.asarray(getattr(tables, f.name))
                              for f in dataclasses.fields(DiffusionTables)})
