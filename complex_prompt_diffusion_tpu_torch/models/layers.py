"""Primitive layers as plain functions on tensors.

Counterpart of ``complex_prompt_diffusion_tpu/models/layers.py``, math only.
Of the TPU conv routes only the Pallas 3x3 kernel's is ported (K4, see
:func:`conv3x3_wanted`); every other conv is ``F.conv2d``. Activations are
NHWC at every public function, as in the JAX package; a conv runs on the
zero-copy NCHW view of an NHWC tensor, which PyTorch treats as
``channels_last``.

Parameter layouts (see ``convert.py``):
  * conv:   ``{"weight": [O, I, kh, kw] (channels_last), "bias": [O]}``
  * linear: ``{"kernel": [in, out], "bias": [out]}`` (``x @ kernel``)
  * norms:  ``{"scale": [C], "bias": [C]}``
Norm statistics are f32 whatever the activation dtype.

The ``init_*`` functions build random parameters in the JAX package's
layout (HWIO conv kernels), on a device, from a ``torch.Generator``;
``convert.py`` turns them into the port's layout.

``CPD_TPU_SUBPIXEL_UP`` (read at import, as the JAX package reads it) picks
the form of the 3x3 conv after a nearest 2x upsample (the UNet's "up" op,
the VAE decoder's upsamplers): "1" the exact subpixel form
:func:`conv3x3_after_upsample2x` for every 3x3 kernel, "0" or "auto" (the
JAX package's "auto" means a TPU backend) the conv of the upsampled plane.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.ops import group_norm, group_norm_silu
from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3, conv3x3_supported

__all__ = [
    "init_conv",
    "init_linear",
    "init_group_norm",
    "init_layer_norm",
    "conv3x3_wanted",
    "conv2d",
    "conv3x3_after_upsample2x",
    "subpixel_up_wanted",
    "linear",
    "layer_norm",
    "group_norm_p",
    "group_norm_silu_p",
    "timestep_embedding",
    "silu",
    "gelu",
    "upsample_nearest2x",
    "avg_pool2x",
]


def _uniform(gen, shape, bound, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -bound, bound, generator=gen
    )


def init_conv(gen, in_ch: int, out_ch: int, kernel: int = 3, zero: bool = False,
              device="cpu"):
    """Conv params in the JAX layout {kernel: [KH,KW,I,O], bias: [O]};
    uniform fan-in init (zero=True: the zero_module init)."""
    shape = (kernel, kernel, in_ch, out_ch)
    if zero:
        w = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        w = _uniform(gen, shape, 1.0 / math.sqrt(in_ch * kernel * kernel), device)
    return {"kernel": w, "bias": torch.zeros(out_ch, device=device)}


def init_linear(gen, in_f: int, out_f: int, bias: bool = True, zero: bool = False,
                device="cpu"):
    if zero:
        w = torch.zeros((in_f, out_f), dtype=torch.float32, device=device)
    else:
        w = _uniform(gen, (in_f, out_f), 1.0 / math.sqrt(in_f), device)
    p = {"kernel": w}
    if bias:
        p["bias"] = torch.zeros(out_f, device=device)
    return p


def init_group_norm(ch: int, device="cpu"):
    return {"scale": torch.ones(ch, device=device), "bias": torch.zeros(ch, device=device)}


init_layer_norm = init_group_norm


def conv3x3_wanted(x, w_shape, stride: int = 1, padding=None) -> bool:
    """The JAX package's conv dispatch (``_pallas_conv_wanted`` and
    ``conv3x3_supported``): stride-1 3x3 'same' convs at batch <= 4 on
    16^2..32^2 planes (256 <= H*W <= 1024), in any dtype (K4 runs bf16 and
    f32)."""
    b, h, w, _ = x.shape
    return (
        b <= 4
        and 256 <= h * w <= 1024
        and conv3x3_supported(x.shape, w_shape, stride, padding)
    )


def conv2d(params, x, stride: int = 1, padding=None):
    """Conv over NHWC with torch-style symmetric padding; default pad =
    (k-1)//2, i.e. Conv2d(padding=k//2) for odd k. Convs that
    :func:`conv3x3_wanted` admits go through the K4 kernel."""
    w = params["weight"]
    dt = x.dtype
    if conv3x3_wanted(x, w.shape, stride, padding):
        return conv3x3(x, w, params["bias"])
    if padding is None:
        padding = (w.shape[-1] - 1) // 2
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(dt), params["bias"].to(dt),
        stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1)


# output phase -> {padded offset: the 3x3 taps a nearest 2x upsample folds
# onto it}: output row 2i + p reads upsampled rows 2i + p + dh - 1, i.e.
# source rows i - 1 (dh 0) and i (dh 1, 2) for p = 0, i (dh 0, 1) and i + 1
# (dh 2) for p = 1; padded offset o reads source row i + o - 1
_PHASE_TAPS = {0: {0: (0,), 1: (1, 2)}, 1: {1: (0, 1), 2: (2,)}}

_SUBPIXEL_UP = os.environ.get("CPD_TPU_SUBPIXEL_UP", "auto")


def conv3x3_after_upsample2x(params, x):
    """``conv2d(params, upsample_nearest2x(x))`` without the upsampled
    plane (the JAX package's exact subpixel form): for each output phase
    (ph, pw), the taps the duplication folds onto one small-plane pixel are
    summed into one kernel, so 16 contractions of shifted small-plane
    slices replace 9 over the plane four times larger (2.25x fewer
    flops). The summed kernels are rounded to x's dtype and each product
    and the sums run in f32, as the JAX function's ``dot_general`` with
    f32 accumulation; one rounding to x's dtype at the end. The JAX package
    leaves this to XLA, outside any Pallas kernel, so the products are
    ``torch.matmul``."""
    w = params["weight"].float()  # [Co, C, 3, 3]
    b, h, wd, _ = x.shape
    co = w.shape[0]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    phases = []
    for ph in (0, 1):
        for pw in (0, 1):
            acc = None
            for oh, dhs in _PHASE_TAPS[ph].items():
                for ow, dws in _PHASE_TAPS[pw].items():
                    k2 = sum(w[:, :, dh, dw] for dh in dhs for dw in dws)  # [Co, C]
                    t = torch.matmul(xp[:, oh:oh + h, ow:ow + wd], k2.to(x.dtype).float().t())
                    acc = t if acc is None else acc + t
            phases.append(acc + params["bias"].float())
    y = torch.stack(phases, dim=-2).reshape(b, h, wd, 2, 2, co)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * wd, co).to(x.dtype)


def subpixel_up_wanted(w_shape) -> bool:
    """Whether the conv of weight shape ``w_shape`` ([Co, C, kh, kw]) after
    a nearest 2x upsample takes :func:`conv3x3_after_upsample2x`: under
    ``CPD_TPU_SUBPIXEL_UP=1`` every 3x3 kernel; "0" never; "auto" never on
    this card (the JAX package's "auto" is on for a TPU backend only)."""
    return _SUBPIXEL_UP == "1" and tuple(w_shape[2:]) == (3, 3)


def linear(params, x):
    dt = x.dtype
    y = torch.matmul(x, params["kernel"].to(dt))
    if "bias" in params:
        y = y + params["bias"].to(dt)
    return y


def layer_norm(params, x, eps: float = 1e-5):
    """LayerNorm over the last dim, output in x.dtype. PyTorch computes the
    statistics and the affine in f32 for bf16 inputs and rounds once, as
    the JAX package's f32-stats LayerNorm does."""
    dt = x.dtype
    return F.layer_norm(
        x, x.shape[-1:], params["scale"].to(dt), params["bias"].to(dt), eps
    )


def group_norm_p(params, x, num_groups: int = 32, eps: float = 1e-5):
    return group_norm(x, params["scale"], params["bias"], num_groups, eps)


def group_norm_silu_p(params, x, num_groups: int = 32, eps: float = 1e-5):
    return group_norm_silu(x, params["scale"], params["bias"], num_groups, eps)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, CompVis ordering [cos | sin] (diffusers uses
    [sin | cos]; the order matters for weight parity). f32 output."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x)


def upsample_nearest2x(x):
    """Nearest-neighbour 2x upsample of an NHWC tensor."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def avg_pool2x(x):
    """2x2 average pool (stride 2) of an NHWC tensor."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
