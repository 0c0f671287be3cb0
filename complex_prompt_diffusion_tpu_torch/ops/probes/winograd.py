"""Winograd F(2x2,3x3) conv3x3 with the K6 CUDA kernels (an opt-in probe).

Counterpart of ``complex_prompt_diffusion_tpu/ops/probes/winograd.py``:
the same 3x3 stride-1 'same' conv as ``ops/conv.py`` computed with 16
multiplies per 2x2 output tile (4 per output point instead of 9), at the
price of add-only tile transforms. As in the JAX package, no layer
dispatches it: ``models/layers.conv2d`` never calls it.

  * ``U = G g G^T`` (:func:`winograd_weights`, f32 math, then cast to x's
    dtype) is computed here in the wrapper, or passed in;
  * each kernel transforms every 4x4 input tile with its halo from NHWC x
    (``V = B^T d B``: adds only, in f32, rounded once to x's dtype), takes
    the 16 products ``V_ij [tiles, C] x U_ij [C, Co]`` with f32
    accumulation, applies the output transform ``A^T M A`` and the bias in
    f32 and writes NHWC. The transformed tiles never reach device memory.

:func:`wino3x3` routes CUDA tensors by a shape rule (:func:`k6_body`):
bf16 with C % 8 == 0 (every ResBlock conv of the SD-1.5 UNet and of a UNet
at CompVis LDM-VQ-4's widths, 224 .. 896 channels) to :func:`wino3x3_sm90`
(``csrc/winograd_sm90.cu``: TMA + wgmma, the split of
:func:`wino3x3_plan`), f32 with C % 4 == 0 (the same convs) to
:func:`wino3x3_f32_sm90` (``csrc/winograd_f32_sm90.cu``: TMA + wgmma, each
product as three TF32 products, the split of ``wino3x3_plan(...,
dtype=float32)``), any Co; everything else to :func:`wino3x3_prior`
(``csrc/winograd.cu``, the first body: mma.sync for bf16, exact FMAs for
f32). A Hopper body's chunk is 64 channels (f32: 32), one 128-byte TMA row;
a width off that tile costs one partly zero chunk (TMA fills the channels
past C with zeros) and a last block partly past Co.

Numerics: the weight transform's halves are exact in bf16 and f32; in bf16
the rounding of V and U gives about 5e-3 relative deviation from the direct
bf16 conv, the same order as that conv's own deviation from f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch import _build
# the channel multiple a Hopper body takes (K4's rule: the TMA maps' 16-byte
# strides), for C and U's row stride
from complex_prompt_diffusion_tpu_torch.ops.conv import SM90_ALIGN

__all__ = ["wino3x3", "wino3x3_plain", "wino3x3_supported", "winograd_weights", "wino3x3_sm90",
           "wino3x3_f32_sm90", "wino3x3_prior", "wino3x3_plan", "Wino3x3Plan", "k6_body"]

# G for F(2x2,3x3): exact in bf16/f32 except the halves (exact in f32).
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
# A^T rows (output transform): y0 = m0+m1+m2, y1 = m1-m2-m3
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


_G_ON = {}  # device -> G, copied to a device once, so a CUDA graph can capture the transform


def winograd_weights(kernel):
    """[3, 3, C, Co] -> U = G g G^T as [16, C, Co] (f32 math)."""
    g = _G_ON.get(kernel.device)
    if g is None:
        g = _G_ON[kernel.device] = torch.tensor(_G, dtype=torch.float32, device=kernel.device)
    u = torch.einsum("ik,klcf->ilcf", g, kernel.float())
    u = torch.einsum("ilcf,jl->ijcf", u, g)
    return u.reshape(16, kernel.shape[2], kernel.shape[3])


def wino3x3_supported(x_shape, k_shape, stride: int, padding) -> bool:
    """The shape rule of the JAX guard: stride-1 3x3 'same' convs (padding 1
    or the default) on even planes with H, W >= 8. ``k_shape`` is HWIO. The
    JAX guard's second clause, that the working set fits the TPU's VMEM, has
    no counterpart on this card and is dropped."""
    if stride != 1 or padding not in (None, 1):
        return False
    if len(k_shape) != 4 or k_shape[0] != 3 or k_shape[1] != 3:
        return False
    _, h, w, c = x_shape
    if h % 2 or w % 2 or h < 8 or w < 8:
        return False
    return k_shape[2] == c


def _butterfly(a0, a1, a2, a3):
    """B^T applied along one axis of a 4-vector of planes."""
    return a0 - a2, a1 + a2, a2 - a1, a1 - a3


def wino3x3_plain(x, u, bias):
    """Plain PyTorch twin of K6, the kernel's arithmetic: 4x4 input tiles
    from a zero-padded f32 copy of x, ``B^T d B`` in f32 rounded once to x's
    dtype, the 16 products in f32 (exact products of the rounded values,
    f32 sums; PyTorch runs f32 matmuls without TF32 by default), ``A^T M A``
    and the bias in f32, one rounding to x's dtype. ``u``: [16, C, Co] in
    x's dtype."""
    b, h, w, _ = x.shape
    th, tw = h // 2, w // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    # d[k][l]: element (k, l) of every tile, [B, TH, TW, C]
    d = [[xp[:, k:k + 2 * th:2, l:l + 2 * tw:2] for l in range(4)] for k in range(4)]
    wk = [_butterfly(*d[k]) for k in range(4)]  # wk[k][j]
    y = [[None, None], [None, None]]
    for j in range(4):
        col = _butterfly(wk[0][j], wk[1][j], wk[2][j], wk[3][j])  # V_ij over i
        for i in range(4):
            v = col[i].to(x.dtype).float()
            m = torch.matmul(v, u[i * 4 + j].float())
            for a in range(2):
                for bb in range(2):
                    coeff = _AT[a][i] * _AT[bb][j]
                    if coeff:
                        t = m if coeff > 0 else -m
                        y[a][bb] = t if y[a][bb] is None else y[a][bb] + t
    bias = bias.float()
    rows = [torch.stack([y[a][0] + bias, y[a][1] + bias], dim=3) for a in range(2)]
    out = torch.stack(rows, dim=2)  # [B, TH, 2, TW, 2, Co]
    return out.reshape(b, h, w, -1).to(x.dtype)


def k6_body(dtype, c: int, co: int) -> str:
    """The route of :func:`wino3x3`: ``"bf16_sm90"`` for bf16 with C % 8 ==
    0, ``"f32_sm90"`` for f32 with C % 4 == 0 (the input map's 16-byte
    strides; chunks of 64 or 32 channels, the last partly past C; U's boxes
    of 64 output channels, the last partly past Co: any Co), ``"prior"``
    (the first body) for the other bf16 and f32 shapes; raises for any
    other dtype (f16)."""
    if dtype not in SM90_ALIGN:
        raise TypeError(f"K6 supports bfloat16 and float32 activations, got {dtype}")
    if c % SM90_ALIGN[dtype]:
        return "prior"
    return "bf16_sm90" if dtype == torch.bfloat16 else "f32_sm90"


SM90_BT, SM90_BN, SM90_KC = 64, 128, 64  # the Hopper body's block: tiles, channels, chunk
F32_KC = 32  # the f32 Hopper body's chunk: 32 f32 channels, one 128-byte row
SM90_SMS = 132  # H100 SXM; one block an SM (220 KB of shared memory each)
# The split cost model of wino3x3_plan, in microseconds on an H100 80GB HBM3
# (700 W): the weight of one chunk of a block, the reduce kernel's launch,
# and the rate at which the f32 partials are written and read back (K4's,
# ops/conv.py). The chunk weight is a time for bf16 only:
#   * bf16: a 64-channel chunk as measured (a run with one split over its
#     chunks: 7.9 us at the phase-9 shapes, against 2.2 us of tensor-core
#     work);
#   * f32: not a time but a weight fitted to the picks. A 32-channel chunk
#     measures 20.6-23.7 us unsplit (tools/wino_splits.py; 6.7 us of
#     tensor-core work as three TF32 products), but the model charges every
#     block of a thin last wave the whole wave's chunks, so at that weight
#     it prices more blocks too high against the partials' pass and picks 8
#     splits at B2 32^2 1280->1280 (1.9% over the best, 3). Any weight in
#     4-12 picks the split count that measured fastest at the 11 shapes
#     tools/wino_splits.py sweeps (phase 9's ten distinct ResBlock convs at
#     UNet batch 2 and B1 32^2 512->512); 12 is used. Other shapes are not
#     validated.
_CHUNK_WEIGHT_US = {torch.bfloat16: 7.9, torch.float32: 12.0}
_REDUCE_US = 2.0
_PARTIALS_BYTES_PER_US = 2.8e6
_MAX_SPLITS = 16


class Wino3x3Plan(NamedTuple):
    """How the Hopper body covers a conv: blocks of ``tw x th = 64`` output
    tiles (2x2 pixels each) of one image by 128 output channels (the last
    partly past Co); the ceil(C / 64) chunks (f32: ceil(C / 32), the last
    partly past C) cut into ``splits`` runs of ``chunks_per_split`` (the
    last may be shorter, none is empty); ``launches`` kernels (the
    reduction with more than one split)."""

    tw: int
    th: int
    rects_w: int
    rects_h: int
    m_blocks: int  # b * rects_h * rects_w
    n_blocks: int
    kchunks: int
    splits: int
    chunks_per_split: int
    kc: int = SM90_KC  # channels a chunk: 64 (bf16) or 32 (f32)

    @property
    def launches(self) -> int:
        return 1 if self.splits == 1 else 2

    def c_range(self, split: int) -> range:
        """The chunk channels split ``split`` reduces over (past C in the
        last chunk: channels the kernel reads as zeros)."""
        lo = split * self.chunks_per_split
        hi = min(self.kchunks, lo + self.chunks_per_split)
        return range(lo * self.kc, hi * self.kc)

    def tiles(self, block: int) -> list:
        """The (image, tile row, tile column) of block row ``block`` (its
        rectangle; tiles past the plane are computed and not written)."""
        rw = block % self.rects_w
        rh = block // self.rects_w % self.rects_h
        b = block // (self.rects_w * self.rects_h)
        return [(b, rh * self.th + t // self.tw, rw * self.tw + t % self.tw)
                for t in range(SM90_BT)]


@functools.lru_cache(maxsize=1024)
def wino3x3_plan(b: int, h: int, w: int, c: int, co: int,
                 splits: Optional[int] = None, dtype=torch.bfloat16) -> Wino3x3Plan:
    """The block and split plan a Hopper body runs for x [b, h, w, c] of
    ``dtype`` (bf16: :func:`wino3x3_sm90`, C % 8 == 0, 64-channel chunks;
    f32: :func:`wino3x3_f32_sm90`, C % 4 == 0, 32-channel chunks) and ``co``
    output channels (any).
    Rectangles are 16 x 4 tiles where W / 2 >= 16, 8 x 8 where W / 2 >= 8,
    else 4 x 16 (TMA zero-fills what falls outside the plane). ``splits``
    (default: chosen here) divides the chunks among blocks: the choice
    minimises the modelled time, waves of blocks on 132 SMs x chunks a
    block, plus, with more than one split, the reduce pass (a launch and the
    f32 partials written and read); the smaller count wins a tie."""
    kc = F32_KC if dtype == torch.float32 else SM90_KC
    align = SM90_ALIGN[torch.float32 if dtype == torch.float32 else torch.bfloat16]
    if c <= 0 or c % align or co <= 0:
        raise ValueError(f"the Hopper Winograd body needs C % {align} == 0 and Co > 0; got "
                         f"C={c}, Co={co}")
    if h % 2 or w % 2 or h < 8 or w < 8:
        raise ValueError(f"the Hopper Winograd body needs even H, W >= 8; got {h}x{w}")
    th_tiles, tw_tiles = h // 2, w // 2
    tw = 16 if tw_tiles >= 16 else 8 if tw_tiles >= 8 else 4
    th = SM90_BT // tw
    rects_w, rects_h = -(-tw_tiles // tw), -(-th_tiles // th)
    m_blocks = b * rects_h * rects_w
    n_blocks = -(-co // SM90_BN)
    kchunks = -(-c // kc)
    blocks = m_blocks * n_blocks
    if splits is None:
        partial_bytes = 4.0 * b * h * w * co

        def cost(s):
            t = math.ceil(blocks * s / SM90_SMS) * math.ceil(kchunks / s) * _CHUNK_WEIGHT_US[dtype]
            if s > 1:
                t += _REDUCE_US + 2 * s * partial_bytes / _PARTIALS_BYTES_PER_US
            return t

        splits = min(range(1, min(_MAX_SPLITS, kchunks) + 1), key=lambda s: (cost(s), s))
    if not 1 <= splits <= kchunks:
        raise ValueError(f"splits must lie in 1..{kchunks}; got {splits}")
    per = -(-kchunks // splits)
    return Wino3x3Plan(tw, th, rects_w, rects_h, m_blocks, n_blocks, kchunks, -(-kchunks // per),
                       per, kc)


def _check_args(x, kernel, bias, u):
    """Shape checks of every K6 entry; returns U in x's dtype."""
    if x.ndim != 4 or not wino3x3_supported(x.shape, kernel.shape, 1, 1):
        raise ValueError(
            f"wino3x3 takes NHWC x with even H, W >= 8 and a [3, 3, C, Co] kernel; "
            f"got x{tuple(x.shape)} kernel{tuple(kernel.shape)}"
        )
    c, co = x.shape[3], kernel.shape[3]
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias{tuple(bias.shape)} does not match Co={co}")
    if u is None:
        return winograd_weights(kernel).to(x.dtype)
    if tuple(u.shape) != (16, c, co) or u.dtype != x.dtype:
        raise ValueError(f"u must be [16, {c}, {co}] in {x.dtype}")
    return u


def wino3x3(x, kernel, bias, u=None):
    """K6 wrapper: 3x3 stride-1 'same' conv + bias via Winograd F(2x2,3x3),
    NHWC ``x`` [B, H, W, C] x HWIO ``kernel`` [3, 3, C, Co].

    ``u``: ``winograd_weights(kernel).to(x.dtype)`` computed ahead, for a
    caller that reuses one weight over many calls; by default it is
    computed here. CPU tensors run :func:`wino3x3_plain`. CUDA tensors go
    by :func:`k6_body` to the bf16 Hopper body (:func:`wino3x3_sm90`), the
    f32 one (:func:`wino3x3_f32_sm90`) or the first body
    (:func:`wino3x3_prior`); each launches its kernels or raises. Shapes
    outside :func:`wino3x3_supported` raise on every device. Under grad the
    backward is the VJP of :func:`wino3x3_plain` on the saved x, U and bias,
    and the kernel's gradient follows through :func:`winograd_weights`
    (together the VJP of the conv the JAX rule takes, ``_xla_conv``).
    ``wino3x3.launches`` counts the kernels launched by every body, each
    body's own counter those of that body."""
    u = _check_args(x, kernel, bias, u)
    if not x.is_cuda:
        return wino3x3_plain(x, u, bias)
    return _build.kernel_with_plain_vjp(_wino3x3_cuda, wino3x3_plain, (), x, u, bias)


def _wino3x3_cuda(x, u, bias):
    """K6's forward on CUDA tensors: the body :func:`k6_body` names."""
    _build.refuse_grad("Winograd conv3x3 (K6)", x, u, bias)
    b, h, w, c = x.shape
    co = u.shape[2]
    body = k6_body(x.dtype, c, co)
    lib = _build.kernel_library()
    if body == "bf16_sm90":
        y, n = _launch_sm90(lib, x, u, bias, wino3x3_plan(b, h, w, c, co))
        wino3x3_sm90.launches += n
    elif body == "f32_sm90":
        y, n = _launch_sm90(lib, x, u, bias, wino3x3_plan(b, h, w, c, co, dtype=torch.float32))
        wino3x3_f32_sm90.launches += n
    else:
        y, n = _launch_prior(lib, x, u, bias)
        wino3x3_prior.launches += n
    wino3x3.launches += n
    return y


wino3x3.launches = 0


def wino3x3_sm90(x, kernel, bias, u=None, splits: Optional[int] = None):
    """K6's TMA + wgmma body (``csrc/winograd_sm90.cu``) on a CUDA bf16 x
    with C % 8 == 0 (any Co); anything else raises. ``splits``
    forces the split count of :func:`wino3x3_plan` (the tests compare
    counts); the splits are summed in a fixed order, so the bits do not
    depend on the run. CPU tensors run :func:`wino3x3_plain` after the same
    checks. ``wino3x3_sm90.launches`` counts the kernels the library reports
    it launched (1, or 2 with the reduction)."""
    u = _check_args(x, kernel, bias, u)
    b, h, w, c = x.shape
    co = kernel.shape[3]
    if x.dtype != torch.bfloat16 or k6_body(x.dtype, c, co) != "bf16_sm90":
        raise ValueError(f"wino3x3_sm90 takes bf16 with C % 8 == 0; got {x.dtype} C={c} "
                         f"Co={co}")
    plan = wino3x3_plan(b, h, w, c, co, splits)
    if not x.is_cuda:
        return wino3x3_plain(x, u, bias)
    _build.refuse_grad("Winograd conv3x3 (K6, Hopper body)", x, kernel, bias, u)
    y, n = _launch_sm90(_build.kernel_library(), x, u, bias, plan)
    wino3x3_sm90.launches += n
    return y


wino3x3_sm90.launches = 0


def wino3x3_f32_sm90(x, kernel, bias, u=None, splits: Optional[int] = None):
    """K6's f32 TMA + wgmma body (``csrc/winograd_f32_sm90.cu``: each
    product as three TF32 products, hi and lo split in the kernel, so its
    result holds the f32 twin to ~1e-6) on a CUDA f32 x with C % 4 == 0
    (any Co); anything else raises. ``splits`` forces the split
    count of ``wino3x3_plan(..., dtype=float32)``; the splits are summed in
    a fixed order, so the bits do not depend on the run. CPU tensors run
    :func:`wino3x3_plain` after the same checks.
    ``wino3x3_f32_sm90.launches`` counts the kernels the library reports it
    launched (1, or 2 with the reduction)."""
    u = _check_args(x, kernel, bias, u)
    b, h, w, c = x.shape
    co = kernel.shape[3]
    if x.dtype != torch.float32 or k6_body(x.dtype, c, co) != "f32_sm90":
        raise ValueError(f"wino3x3_f32_sm90 takes f32 with C % 4 == 0; got {x.dtype} C={c} "
                         f"Co={co}")
    plan = wino3x3_plan(b, h, w, c, co, splits, torch.float32)
    if not x.is_cuda:
        return wino3x3_plain(x, u, bias)
    _build.refuse_grad("Winograd conv3x3 (K6, f32 Hopper body)", x, kernel, bias, u)
    y, n = _launch_sm90(_build.kernel_library(), x, u, bias, plan)
    wino3x3_f32_sm90.launches += n
    return y


wino3x3_f32_sm90.launches = 0


def wino3x3_prior(x, kernel, bias, u=None):
    """K6's first body (``csrc/winograd.cu``): bf16 on the tensor cores
    with mma.sync (C % 8 == 0 and Co % 8 == 0), f32 with exact FMAs (Co % 4
    == 0); the body the Hopper one replaced for its shapes and the body of
    every other one. CPU tensors run :func:`wino3x3_plain`.
    ``wino3x3_prior.launches`` counts its launches."""
    u = _check_args(x, kernel, bias, u)
    if not x.is_cuda:
        return wino3x3_plain(x, u, bias)
    _build.refuse_grad("Winograd conv3x3 (K6, first body)", x, kernel, bias, u)
    y, n = _launch_prior(_build.kernel_library(), x, u, bias)
    wino3x3_prior.launches += n
    return y


wino3x3_prior.launches = 0


def _launch_sm90(lib, x, u, bias, plan):
    """(y, kernels launched) of the Hopper body of x's dtype (bf16 or f32)
    on checked CUDA tensors. U's rows are padded with zero columns to a
    multiple of 16 bytes where Co is not (its TMA map's stride); the kernel
    reads Co of them."""
    b, h, w, c = x.shape
    co = u.shape[2]
    x = x.contiguous()
    cu = -(-co // SM90_ALIGN[x.dtype]) * SM90_ALIGN[x.dtype]
    u = u.contiguous() if cu == co else F.pad(u, (0, cu - co))
    bias = bias.to(torch.float32).contiguous()
    for name, t in (("x", x), ("u", u)):
        if t.data_ptr() % 16:
            raise ValueError(f"the Hopper Winograd body needs a 16-byte aligned {name} (TMA)")
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.splits, b * h * w, co), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else y)
    launched = ctypes.c_int(0)
    f32 = x.dtype == torch.float32
    fn = lib.cpd_wino3x3_f32_sm90 if f32 else lib.cpd_wino3x3_sm90_bf16
    err = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(), b, h, w, c,
             co, cu, plan.tw, plan.splits, plan.chunks_per_split, ctypes.byref(launched),
             _build.stream_ptr(x.device))
    _build.check(err, f"Winograd conv3x3 (K6, {'f32 ' if f32 else ''}Hopper body)")
    return y, launched.value


def _launch_prior(lib, x, u, bias):
    """(y, kernels launched) of the first body on checked CUDA tensors."""
    b, h, w, c = x.shape
    co = u.shape[2]
    if x.dtype == torch.bfloat16:
        if c % 8 or co % 8:
            raise ValueError(f"K6 bf16 needs C % 8 == 0 and Co % 8 == 0; got {c}, {co}")
        fn = lib.cpd_wino3x3_bf16
    elif x.dtype == torch.float32:
        if co % 4:
            raise ValueError(f"K6 f32 needs Co % 4 == 0; got {co}")
        fn = lib.cpd_wino3x3_f32
    else:
        raise TypeError(f"K6 supports bfloat16 and float32 activations, got {x.dtype}")
    x = x.contiguous()
    u = u.contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(), y.data_ptr(), b, h, w, c, co,
             _build.stream_ptr(x.device))
    _build.check(err, "Winograd conv3x3 (K6)")
    return y, 1
