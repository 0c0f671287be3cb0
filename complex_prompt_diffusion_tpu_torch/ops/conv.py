"""3x3 stride-1 'same' convolution over NHWC, with the K4 CUDA kernels.

Counterpart of ``complex_prompt_diffusion_tpu/ops/conv.py``. The weight is
the port's conv weight ``[Co, C, 3, 3]`` (``convert.py``; channels_last
memory, so it is a row-major ``[Co, 9C]`` matrix that the kernels read in
place), the bias ``[Co]``. ``models/layers.conv2d`` decides which convs come
here (the JAX package's batch and plane-size gate); :func:`conv3x3` then
routes each by dtype and shape (:func:`k4_body`) to one of K4's bodies:

  * Co <= 8 or C <= 16 (the UNet's conv_in and out conv, the VAE's conv_in
    and encoder conv_out), both dtypes: :func:`conv3x3_narrow`, a narrow-Co
    body (K split over warps, a fixed-order fold) and a narrow-C body (the
    neighbourhood and the weights resident in shared memory), in
    ``csrc/conv3x3_narrow.cu``;
  * the other bf16 convs with C % 8 == 0 (every 3x3 conv of the SD-1.5
    UNet's 16^2 and 32^2 planes, and of a UNet at CompVis LDM-VQ-4's widths,
    224 .. 1568 channels): :func:`conv3x3_sm90`, TMA + wgmma
    (``csrc/conv3x3_sm90.cu``), with the tile and split-K plan of
    :func:`conv3x3_plan`;
  * the other f32 convs with C % 4 == 0 (the same convs of an f32 UNet, the
    exact decode's on small planes, the tiny config's): :func:`conv3x3_f32_sm90`,
    the same implicit GEMM of three TF32 products a product on wgmma
    (``csrc/conv3x3_f32_sm90.cu``), with the plan's f32 form;
  * the rest (bf16 C % 8 != 0, f32 C % 4 != 0, past the narrow widths):
    :func:`conv3x3_generic`, the mma.sync / FMA body (``csrc/conv3x3.cu``),
    which the other bodies replaced at their widths.

A Hopper body's k-step is one tap and 64 channels (f32: 32), one 128-byte
TMA row; a width off that tile costs one partly zero k-step a tap (TMA fills
the channels past C with zeros) and a last output tile partly past Co.

The Hopper bodies read the weight in place, a channel slice of a wider
channels_last weight too (the UNet's split in_convs): their TMA map walks
[Co, 9, Cw] with the slice's channel stride Cw.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_supported", "conv3x3_sm90",
           "conv3x3_f32_sm90", "conv3x3_narrow", "conv3x3_generic", "conv3x3_plan",
           "Conv3x3Plan", "k4_body"]

SM90_BM, SM90_BN, SM90_BK = 128, 128, 64  # the sm90 body's tile: pixels, channels, k-step
F32_BK = 32  # the f32 body's k-step: one tap and 32 channels (a 128-byte row)
# the channel multiple a Hopper body takes: its TMA maps' strides of 16 bytes
SM90_ALIGN = {torch.bfloat16: 8, torch.float32: 4}
SM90_SMS = 132  # H100 SXM; one block an SM (128 KB of shared memory each)
NARROW_CO, NARROW_C = 8, 16  # the widths csrc/conv3x3_narrow.cu takes: Co <= 8 or C <= 16
# The split-K cost model of conv3x3_plan, in microseconds on an H100 80GB
# HBM3 (700 W), fitted to a sweep of splits 1-8 over the ten batch-1 UNet
# shapes (PERF.md section 6): a 128 x 128 x 64 k-step of one block
# (2.1 MFLOP; 0.28 us at an SM's share of the 989 TFLOP/s peak), the reduce
# kernel's launch, and the rate at which the f32 partials are written and
# read back.
_STEP_US = 0.45
_REDUCE_US = 2.0
_PARTIALS_BYTES_PER_US = 2.8e6
# f32: a 128 x 128 x 32 k-step of three TF32 products (3.1 MFLOP, 0.84 us
# at an SM's share of the 495 TFLOP/s peak), fitted as the mean of the
# unsplit runs (1.588-1.681 us) in tools/conv_splits.py --dtype float32's
# sweep of splits 1-16 over the 11 f32 shapes (H100 80GB HBM3, 700 W); there
# the plan is within 0.8% of the best split at every shape (PERF.md 6)
_F32_STEP_US = 1.63
_MAX_SPLITS = 16


def conv3x3_supported(x_shape, w_shape, stride: int, padding) -> bool:
    """The shape half of the JAX guard: stride 1, a 3x3 kernel, padding 1
    (or the default), W % 8 == 0 and H, W >= 8. ``w_shape`` is the port's
    ``[Co, C, 3, 3]``. The TPU's VMEM budget has no counterpart here."""
    if stride != 1 or padding not in (None, 1):
        return False
    if len(w_shape) != 4 or tuple(w_shape[2:]) != (3, 3):
        return False
    _, h, w, c = x_shape
    return w % 8 == 0 and h >= 8 and w >= 8 and w_shape[1] == c


def conv3x3_plain(x, weight, bias):
    """Plain PyTorch twin, the TPU kernel's arithmetic: nine shifted f32
    products over one zero-padded f32 copy of x (f32 matmuls, which PyTorch
    runs without TF32 by default), the bias in f32, one rounding to x's
    dtype."""
    _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = weight.float()
    y = None
    for dy in range(3):
        for dx in range(3):
            t = torch.matmul(xp[:, dy:dy + h, dx:dx + w], wf[:, :, dy, dx].t())
            y = t if y is None else y + t
    return (y + bias.float()).to(x.dtype)


def conv3x3(x, weight, bias):
    """K4 wrapper: ``conv3x3(x, w) + b`` for NHWC ``x`` [B, H, W, C].

    CPU tensors run :func:`conv3x3_plain`. CUDA tensors go by
    :func:`k4_body` to :func:`conv3x3_sm90`, :func:`conv3x3_f32_sm90` or
    :func:`conv3x3_generic`; each launches its kernel or raises. The weight
    is taken in x's dtype, the bias in f32 (or bf16, which the bf16 kernels
    widen themselves), as the TPU kernel does. Under grad the backward is
    the VJP of :func:`conv3x3_plain` on the saved x, weight and bias (the
    JAX rule's VJP of ``_xla_conv``), each gradient in its input's dtype.
    ``conv3x3.launches`` counts calls of every body."""
    if x.ndim != 4:
        raise ValueError(f"conv3x3 expects NHWC, got shape {tuple(x.shape)}")
    _, _, _, c, co = _check_shapes(x, weight, bias)
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    body = {"bf16_sm90": conv3x3_sm90, "f32_sm90": conv3x3_f32_sm90,
            "narrow": conv3x3_narrow, "generic": conv3x3_generic}[k4_body(x.dtype, c, co)]
    return _build.kernel_with_plain_vjp(functools.partial(_conv3x3_counted, body),
                                        conv3x3_plain, (), x, weight, bias)


def _conv3x3_counted(body, x, weight, bias):
    y = body(x, weight, bias)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def _check_shapes(x, weight, bias):
    """(B, H, W, C, Co) of a conv of NHWC x by a [Co, C, 3, 3] weight and a
    [Co] bias; raises on shapes that do not fit together."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    if tuple(weight.shape) != (co, c, 3, 3) or tuple(bias.shape) != (co,):
        raise ValueError(
            f"conv3x3 shapes x{tuple(x.shape)} weight{tuple(weight.shape)} "
            f"bias{tuple(bias.shape)} are inconsistent"
        )
    return b, h, w, c, co


def _hopper_operands(x, weight, plan, what):
    """A Hopper body's launch operands: x contiguous; the weight in x's
    dtype as [Co, 3, 3, C] with its channel stride Cw: a channels_last
    weight, or a channel slice of a wider one (Cw > C: the UNet's split
    in_convs), as it lies (the TMA map walks [Co, 9, Cw]), anything else
    (or a Cw that is not a multiple of 16 bytes) copied to the contiguous
    layout (Cw = C), as is a slice that does not start on 16 bytes; both
    16-byte aligned (TMA); the output and the split-K
    partials (f32) when the plan splits."""
    x = x.contiguous()
    wt = weight.to(x.dtype).permute(0, 2, 3, 1)  # [Co, 3, 3, C]
    cw = wt.stride(2)
    if (wt.stride(3) != 1 or wt.stride(1) != 3 * cw or wt.stride(0) != 9 * cw
            or cw < wt.shape[3] or cw * wt.element_size() % 16 or wt.data_ptr() % 16):
        wt, cw = wt.contiguous(), wt.shape[3]
    for name, t in (("x", x), ("weight", wt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} needs a 16-byte aligned {name} (TMA)")
    b, h, w, _ = x.shape
    co = wt.shape[0]
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.splits, b * h * w, co), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else y)
    return x, wt, cw, y, ws


def conv3x3_narrow(x, weight, bias):
    """K4's narrow bodies (``csrc/conv3x3_narrow.cu``) on a CUDA bf16 or f32
    x [B, H, W, C] whose conv has Co <= 8 (the narrow-Co body) or C <= 16
    (the narrow-C body); anything else raises. Products exact and summed in
    f32 in a fixed order, the bias added in f32, one rounding: the same
    bits on every run. CPU tensors run :func:`conv3x3_plain` after the same
    checks. ``conv3x3_narrow.launches`` counts its launches (one a call)."""
    if x.ndim != 4:
        raise ValueError(f"conv3x3_narrow expects NHWC, got shape {tuple(x.shape)}")
    b, h, w, c, co = _check_shapes(x, weight, bias)
    if co > NARROW_CO and c > NARROW_C:
        raise ValueError(f"conv3x3_narrow takes Co <= {NARROW_CO} or C <= {NARROW_C}; got C={c}, "
                         f"Co={co}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 supports bfloat16 and float32 activations, got {x.dtype}")
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    _build.refuse_grad("conv3x3 (K4, narrow body)", x, weight, bias)
    x = x.contiguous()
    wt = weight.to(x.dtype).permute(0, 2, 3, 1).contiguous()  # [Co, 3, 3, C]
    if not (x.dtype == torch.bfloat16 and bias.dtype == torch.bfloat16):
        bias = bias.to(torch.float32)
    bias = bias.contiguous()
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    err = _build.kernel_library().cpd_conv3x3_narrow(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.float32),
        int(x.dtype == torch.float32), y.data_ptr(), b, h, w, c, co, _build.stream_ptr(x.device))
    _build.check(err, "conv3x3 (K4, narrow body)")
    conv3x3_narrow.launches += 1
    return y


conv3x3_narrow.launches = 0


def conv3x3_generic(x, weight, bias):
    """K4's body for any C and Co (``csrc/conv3x3.cu``: bf16 on the tensor
    cores with mma.sync, its first design; f32 with exact FMAs), for the
    widths no other body takes (bf16 C % 8 != 0, f32 C % 4 != 0, past the
    narrow widths), and the replaced body that phase 1 times beside the
    narrow bodies at theirs (and beside :func:`conv3x3_sm90` and
    :func:`conv3x3_f32_sm90` at theirs), for CUDA tensors;
    :func:`conv3x3_plain` for CPU ones. ``conv3x3_generic.launches`` counts
    its launches."""
    b, h, w, c = x.shape
    co = weight.shape[0]
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 supports bfloat16 and float32 activations, got {x.dtype}")
    _build.refuse_grad("conv3x3 (K4)", x, weight, bias)
    x = x.contiguous()
    wt = weight.to(x.dtype).permute(0, 2, 3, 1)  # [Co, 3, 3, C]
    if not wt.is_contiguous():
        wt = wt.contiguous()
    if not (x.dtype == torch.bfloat16 and bias.dtype == torch.bfloat16):
        bias = bias.to(torch.float32)
    bias = bias.contiguous()
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    lib = _build.kernel_library()
    dims = (b, h, w, c, co, _build.stream_ptr(x.device))
    if x.dtype == torch.bfloat16:
        err = lib.cpd_conv3x3_bf16(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                                   int(bias.dtype == torch.float32), y.data_ptr(), *dims)
    else:
        err = lib.cpd_conv3x3_f32(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                  *dims)
    _build.check(err, "conv3x3 (K4)")
    conv3x3_generic.launches += 1
    return y


conv3x3_generic.launches = 0


def k4_body(dtype, c: int, co: int) -> str:
    """The route of :func:`conv3x3`: ``"narrow"`` for Co <= 8 or C <= 16;
    of the other shapes ``"bf16_sm90"`` for bf16 with C % 8 == 0 and
    ``"f32_sm90"`` for f32 with C % 4 == 0 (their TMA maps' 16-byte
    strides; any Co), ``"generic"`` for the rest (bf16 C = 20, say); raises
    for any other dtype (f16)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 supports bfloat16 and float32 activations, got {dtype}")
    if co <= NARROW_CO or c <= NARROW_C:
        return "narrow"
    if c % SM90_ALIGN[dtype] == 0:
        return "bf16_sm90" if dtype == torch.bfloat16 else "f32_sm90"
    return "generic"


class Conv3x3Plan(NamedTuple):
    """How a Hopper body covers a conv: output tiles of ``wt x ht = 128``
    pixels of one image by 128 channels (``n_tiles = ceil(Co / 128)``, the
    last partly past Co), ``ksteps = 9 ceil(C / 64)`` reduction steps of
    (tap, 64 channels) (f32: ``9 ceil(C / 32)`` of 32 channels; a tap's last
    step partly past C) cut into ``splits`` runs of ``steps_per_split``
    (the last may be shorter, none is empty)."""

    wt: int
    ht: int
    tiles_w: int
    tiles_h: int
    m_tiles: int  # b * tiles_h * tiles_w
    n_tiles: int
    ksteps: int
    splits: int
    steps_per_split: int

    def k_range(self, split: int) -> range:
        lo = split * self.steps_per_split
        return range(lo, min(self.ksteps, lo + self.steps_per_split))


@functools.lru_cache(maxsize=1024)
def conv3x3_plan(b: int, h: int, w: int, c: int, co: int,
                 splits: Optional[int] = None, dtype=torch.bfloat16) -> Conv3x3Plan:
    """The tile and split-K plan a Hopper body runs for x [b, h, w, c] of
    ``dtype`` (bf16: the sm90 body, C % 8 == 0; f32: the f32 body, C % 4 ==
    0) and ``co`` output channels (any). Tiles are 32 x 4 pixels where W % 32 == 0, 16 x 8
    where W % 16 == 0, else 8 x 16 (TMA zero-fills what falls outside the
    plane). ``splits`` (default: chosen here) divides the k-steps among
    blocks: the choice minimises the modelled time, waves of blocks on 132
    SMs x k-steps a block, plus, with more than one split, the reduce pass
    (a launch and the f32 partials written and read); the smaller count
    wins a tie. Cached by shape: the batch-1 render asks for the same 22
    plans every step, and its steps wait on the host."""
    f32 = dtype == torch.float32
    bk = F32_BK if f32 else SM90_BK
    align = SM90_ALIGN[torch.float32 if f32 else torch.bfloat16]
    if c <= 0 or c % align or co <= 0:
        raise ValueError(f"the {'f32' if f32 else 'sm90'} conv needs C % {align} == 0 and Co > 0; "
                         f"got C={c}, Co={co}")
    wt = 32 if w % 32 == 0 else 16 if w % 16 == 0 else 8
    ht = SM90_BM // wt
    tiles_w, tiles_h = -(-w // wt), -(-h // ht)
    m_tiles = b * tiles_h * tiles_w
    n_tiles = -(-co // SM90_BN)
    ksteps = 9 * -(-c // bk)
    tiles = m_tiles * n_tiles
    if splits is None:
        partial_bytes = 4.0 * b * h * w * co

        def cost(s):
            waves = math.ceil(tiles * s / SM90_SMS)
            t = waves * math.ceil(ksteps / s) * (_F32_STEP_US if f32 else _STEP_US)
            if s > 1:
                t += _REDUCE_US + 2 * s * partial_bytes / _PARTIALS_BYTES_PER_US
            return t

        splits = min(range(1, min(_MAX_SPLITS, ksteps) + 1), key=lambda s: (cost(s), s))
    if not 1 <= splits <= ksteps:
        raise ValueError(f"splits must lie in 1..{ksteps}; got {splits}")
    per = -(-ksteps // splits)
    return Conv3x3Plan(wt, ht, tiles_w, tiles_h, m_tiles, n_tiles, ksteps, -(-ksteps // per),
                       per)


def conv3x3_sm90(x, weight, bias, splits: Optional[int] = None):
    """K4's TMA + wgmma body (``csrc/conv3x3_sm90.cu``) on a CUDA bf16 x
    [B, H, W, C] with C % 8 == 0 (any Co); anything else raises.
    ``splits`` forces the split-K count of :func:`conv3x3_plan` (the tests
    compare counts). Bits do not depend on the run: the splits are summed
    in a fixed order. CPU tensors run :func:`conv3x3_plain` after the same
    checks. ``conv3x3_sm90.launches`` counts calls that launch it (one call
    = the GEMM kernel, and the reduce kernel when split)."""
    if x.ndim != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_sm90 takes a bf16 NHWC tensor; got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, h, w, c, co = _check_shapes(x, weight, bias)
    plan = conv3x3_plan(b, h, w, c, co, splits)
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    _build.refuse_grad("conv3x3 (K4, sm90 body)", x, weight, bias)
    if bias.dtype != torch.bfloat16:
        bias = bias.to(torch.float32)
    bias = bias.contiguous()
    x, wt, cw, y, ws = _hopper_operands(x, weight, plan, "conv3x3_sm90")
    err = _build.kernel_library().cpd_conv3x3_sm90_bf16(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.float32),
        y.data_ptr(), ws.data_ptr(), b, h, w, c, co, cw, plan.wt, plan.ht, plan.splits,
        plan.steps_per_split, _build.stream_ptr(x.device))
    _build.check(err, "conv3x3 (K4, sm90 body)")
    conv3x3_sm90.launches += 1
    return y


conv3x3_sm90.launches = 0


def conv3x3_f32_sm90(x, weight, bias, splits: Optional[int] = None):
    """K4's f32 body (``csrc/conv3x3_f32_sm90.cu``: TMA + wgmma, three TF32
    products a product, exact f32) on a CUDA f32 x [B, H, W, C] with C % 4
    == 0 (any Co); anything else raises. ``splits`` forces the
    split-K count of :func:`conv3x3_plan` (the tests and
    ``tools/conv_splits.py``). Bits do not depend on the run: the splits are
    summed in a fixed order. CPU tensors run :func:`conv3x3_plain` after
    the same checks. ``conv3x3_f32_sm90.launches`` counts calls that launch
    it (one call = the GEMM kernel, and the reduce kernel when split)."""
    if x.ndim != 4 or x.dtype != torch.float32:
        raise ValueError(f"conv3x3_f32_sm90 takes an f32 NHWC tensor; got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, h, w, c, co = _check_shapes(x, weight, bias)
    plan = conv3x3_plan(b, h, w, c, co, splits, torch.float32)
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    _build.refuse_grad("conv3x3 (K4, f32 body)", x, weight, bias)
    bias = bias.to(torch.float32).contiguous()
    x, wt, cw, y, ws = _hopper_operands(x, weight, plan, "conv3x3_f32_sm90")
    err = _build.kernel_library().cpd_conv3x3_f32_sm90(
        x.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(), b, h, w, c,
        co, cw, plan.wt, plan.ht, plan.splits, plan.steps_per_split,
        _build.stream_ptr(x.device))
    _build.check(err, "conv3x3 (K4, f32 body)")
    conv3x3_f32_sm90.launches += 1
    return y


conv3x3_f32_sm90.launches = 0
