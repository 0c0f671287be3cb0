"""GEGLU feed-forward (the SpatialTransformer MLP), with the K2 CUDA kernel.

Counterpart of ``complex_prompt_diffusion_tpu/ops/mlp.py``:
``out = (split_half(x @ W1 + b1) -> v * gelu_erf(g)) @ W2 + b2`` with
``W1 [C, 2*H4]`` (value columns, then gate columns) and ``W2 [H4, C]``.
For CUDA tensors K2 runs it as two TMA + wgmma GEMMs, with the tile and
split-K plan of :func:`geglu_plan`: bf16 on ``csrc/geglu_ff_sm90.cu``, f32 on
``csrc/geglu_ff_f32_sm90.cu`` (three TF32 products a product, the exact-f32
arithmetic of the TPU kernel); :func:`k2_body` names the body.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["geglu_ff", "geglu_ff_bf16_sm90", "geglu_ff_f32_sm90", "geglu_ff_plain",
           "geglu_plan", "k2_body", "GemmPlan", "GegluPlan"]

GEGLU_BM, GEGLU_BK = 128, 64  # K2's work-unit rows and k-step (bf16)
GEGLU1_WIDTHS = (64, 128)  # value columns of a GEMM1 tile (as many gate columns beside)
GEGLU2_WIDTHS = (64, 128, 192, 256)  # output columns of a GEMM2 tile
# the f32 body: k-steps of 32 (one 128-byte row of f32), GEMM1 units of 64
# value (and 64 gate) columns, GEMM2 units of 128 columns; shared memory
# (a 4-stage ring and three split buffers of 32 KB) leaves no room for wider
F32_BK = 32
F32_WIDTHS1, F32_WIDTHS2 = (64,), (128,)
SMS = 132  # H100 SXM: the persistent grids' block count
# The plan's cost model, in microseconds on an H100 80GB HBM3 (700 W): a
# 128-row k-step of one block costs a fixed part and a part per output column
# (fitted to GEMM2's widths in tools/geglu_plans.py's sweep at M2048 C1280), a
# work unit's epilogue, and the split-K reduce's launch and the rate at which
# it writes and reads the f32 partials (ops/conv.py's).
_STEP_US = 0.24
_STEP_US_PER_COLUMN = 0.00215
_UNIT_US = 1.0
_REDUCE_US = 2.0
_PARTIALS_BYTES_PER_US = 2.8e6
# f32: a 128 x 128 x 32 k-step of three TF32 products (3.1 MFLOP, 0.84 us
# at an SM's share of the 495 TFLOP/s peak), fitted to the planned GEMMs'
# device times in tools/geglu_plans.py --dtype float32 (H100 80GB HBM3,
# 700 W): 1.69-2.21 us, GEMM1 (two weight boxes transposed, the gate) 2.02
# on average and GEMM2 1.79; the epilogue as bf16's. In that sweep of
# splits 1-16 the plan is the best split at 13 of the 14 GEMMs and 0.1% over
# it at the last, for any value from 1.7 to 2.2 (PERF.md 6)
_F32_STEP_US = 1.9
_MAX_SPLITS = 16


def geglu_ff_plain(x, w1, b1, w2, b2):
    """Plain PyTorch GEGLU in x's dtype (``_ff_xla`` of the JAX package)."""
    dt = x.dtype
    y = torch.matmul(x, w1.to(dt)) + b1.to(dt)
    v, g = y.chunk(2, dim=-1)
    y = v * F.gelu(g)
    return torch.matmul(y, w2.to(dt)) + b2.to(dt)


class GemmPlan(NamedTuple):
    """How one of K2's GEMMs covers ``m x n`` outputs over a reduction of
    ``k``: tiles of 128 rows by ``bn`` columns (GEMM1: ``bn`` value and
    ``bn`` gate columns), ``ksteps = ceil(k / 64)`` k-steps cut into
    ``splits`` runs of ``steps_per_split`` (the last may be shorter, none is
    empty)."""

    bn: int
    m_tiles: int
    n_tiles: int
    ksteps: int
    splits: int
    steps_per_split: int

    def k_range(self, split: int) -> range:
        lo = split * self.steps_per_split
        return range(lo, min(self.ksteps, lo + self.steps_per_split))


class GegluPlan(NamedTuple):
    gemm1: GemmPlan  # x W1 with the GEGLU epilogue: m x H4 over C
    gemm2: GemmPlan  # hidden W2 + b2: m x C over H4

    @property
    def launches(self) -> int:
        """Kernels a call launches: the two GEMMs and a reduce for each
        split GEMM."""
        return 2 + (self.gemm1.splits > 1) + (self.gemm2.splits > 1)


def _gemm_plan(m: int, n: int, k: int, widths, gates: int, bn=None, splits=None,
               f32: bool = False) -> GemmPlan:
    """Minimise the modelled time over tile widths and split counts: waves
    of work units on 132 SMs x (k-steps a unit at the width's rate + the
    epilogue), plus, when split, the reduce (a launch and the f32 partials
    written and read). A tie goes to fewer splits, then the wider tile."""
    ksteps = -(-k // (F32_BK if f32 else GEGLU_BK))
    m_tiles = -(-m // GEGLU_BM)
    # a width more than one 64-column box past n only adds empty columns
    cands = [w for w in widths if w - 64 < n] or [widths[0]]
    if bn is not None:
        if bn not in widths:
            raise ValueError(f"bn must be one of {widths}; got {bn}")
        cands = [bn]
    split_cands = range(1, min(_MAX_SPLITS, ksteps) + 1)
    if splits is not None:
        if not 1 <= splits <= ksteps:
            raise ValueError(f"splits must lie in 1..{ksteps}; got {splits}")
        split_cands = [splits]

    def cost(w, s):
        units = m_tiles * -(-n // w) * s
        step = _F32_STEP_US if f32 else _STEP_US + _STEP_US_PER_COLUMN * gates * w
        t = math.ceil(units / SMS) * (math.ceil(ksteps / s) * step + _UNIT_US)
        if s > 1:
            t += _REDUCE_US + 2 * s * 4.0 * m * n * gates / _PARTIALS_BYTES_PER_US
        return t

    w, s = min(((w, s) for w in cands for s in split_cands),
               key=lambda ws: (cost(*ws), ws[1], -ws[0]))
    per = -(-ksteps // s)
    return GemmPlan(w, m_tiles, -(-n // w), ksteps, -(-ksteps // per), per)


@functools.lru_cache(maxsize=1024)
def geglu_plan(m: int, c: int, h4: int, dtype=torch.bfloat16) -> GegluPlan:
    """The tiles and split-K counts K2 runs for ``m`` rows of width ``c``
    and hidden width ``h4`` in ``dtype`` (its body: :func:`k2_body`). Pure
    Python, cached by shape: the render asks for the same 4 plans every
    step."""
    return _forced_plan(m, c, h4, dtype=dtype)


def _forced_plan(m: int, c: int, h4: int, bn1: Optional[int] = None,
                 splits1: Optional[int] = None, bn2: Optional[int] = None,
                 splits2: Optional[int] = None, dtype=torch.bfloat16) -> GegluPlan:
    """:func:`geglu_plan` with the tile width or split count of either GEMM
    forced (the tests and ``tools/geglu_plans.py`` pass the result to
    ``geglu_ff(..., plan=)``)."""
    if m <= 0 or c % 8 or h4 % 8 or c <= 0 or h4 <= 0:
        raise ValueError(f"K2 needs M > 0 and C, H4 multiples of 8; got M={m} C={c} H4={h4}")
    f32 = k2_body(dtype, c, h4) == "f32_sm90"
    w1, w2 = (F32_WIDTHS1, F32_WIDTHS2) if f32 else (GEGLU1_WIDTHS, GEGLU2_WIDTHS)
    return GegluPlan(_gemm_plan(m, h4, c, w1, 2, bn1, splits1, f32),
                     _gemm_plan(m, c, h4, w2, 1, bn2, splits2, f32))


def k2_body(dtype, c: int, h4: int) -> str:
    """K2's body for activations of ``dtype``: ``"bf16_sm90"``
    (``csrc/geglu_ff_sm90.cu``) or ``"f32_sm90"`` (``csrc/geglu_ff_f32_sm90.cu``,
    exact f32 by three TF32 products); raises for any other dtype (f16) and
    for C or H4 that are not multiples of 8."""
    if c % 8 or h4 % 8:
        raise ValueError(f"K2 needs C and H4 multiples of 8, got C={c} H4={h4}")
    if dtype == torch.bfloat16:
        return "bf16_sm90"
    if dtype == torch.float32:
        return "f32_sm90"
    raise TypeError(f"K2 supports bfloat16 and float32 activations, got {dtype}")


def _as(t, dtype):
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _check_shapes(x, w1, b1, w2, b2):
    c = x.shape[-1]
    h4 = w2.shape[0]
    if tuple(w1.shape) != (c, 2 * h4) or tuple(b1.shape) != (2 * h4,) or tuple(
        w2.shape
    ) != (h4, c) or tuple(b2.shape) != (c,):
        raise ValueError(
            f"GEGLU shapes x[..., {c}] w1{tuple(w1.shape)} b1{tuple(b1.shape)} "
            f"w2{tuple(w2.shape)} b2{tuple(b2.shape)} are inconsistent"
        )
    return c, h4


def _launch_operands(x, w1, b1, w2, b2, c, h4, dtype, plan):
    """What one K2 launch in ``dtype`` takes: its plan (``plan``, or
    :func:`geglu_plan`'s), the addresses of x as contiguous [M, C] rows, of
    the weights (converted where they are not ``dtype`` and contiguous), of
    the fresh hidden and output, and of the split GEMMs' f32 partials; and
    the output."""
    w1, b1, w2, b2 = (_as(t, dtype) for t in (w1, b1, w2, b2))
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"K2 needs a 16-byte aligned {name} (TMA)")
    m = x2.shape[0]
    p = plan if plan is not None else geglu_plan(m, c, h4, dtype)
    hidden = torch.empty((m, h4), dtype=dtype, device=x.device)
    out = torch.empty((m, c), dtype=dtype, device=x.device)
    ws1 = (torch.empty((p.gemm1.splits, m, 2 * h4), dtype=torch.float32, device=x.device)
           if p.gemm1.splits > 1 else hidden)
    ws2 = (torch.empty((p.gemm2.splits, m, c), dtype=torch.float32, device=x.device)
           if p.gemm2.splits > 1 else out)
    return p, [t.data_ptr() for t in (x2, w1, b1, w2, b2, hidden, out, ws1, ws2)], out


def geglu_ff(x, w1, b1, w2, b2, plan: Optional[GegluPlan] = None):
    """K2 wrapper: GEGLU FF over x [..., C].

    CPU tensors run :func:`geglu_ff_plain`. CUDA tensors go by
    :func:`k2_body`: bf16 launches ``csrc/geglu_ff_sm90.cu``
    (:func:`geglu_ff_bf16_sm90`: GEMM1 with the GEGLU epilogue, then GEMM2 +
    b2, each followed by a reduce kernel when the plan splits its K), f32
    :func:`geglu_ff_f32_sm90`; anything else raises (C and H4 multiples of
    8, 16-byte aligned operands). ``plan`` overrides :func:`geglu_plan`'s
    choice (the tests force split counts). Under grad the backward is the
    VJP of :func:`geglu_ff_plain` on the saved x and weights (the JAX
    rule's VJP of ``_ff_xla``); weights of another dtype than x (f32 master
    weights under bf16 activations) are cast inside, so each gradient comes
    back in its weight's dtype. ``geglu_ff.launches`` adds the kernels the
    library reports it launched on either body: 2 a call, plus 1 for each
    split GEMM (what ``GegluPlan.launches`` predicts)."""
    if not x.is_cuda:
        return geglu_ff_plain(x, w1, b1, w2, b2)
    c, h4 = _check_shapes(x, w1, b1, w2, b2)
    k2_body(x.dtype, c, h4)
    return _build.kernel_with_plain_vjp(functools.partial(_geglu_ff_cuda, plan=plan),
                                        geglu_ff_plain, (), x, w1, b1, w2, b2)


geglu_ff.launches = 0


def _geglu_ff_cuda(x, w1, b1, w2, b2, plan):
    """K2's forward on CUDA tensors: the body :func:`k2_body` names."""
    if x.dtype == torch.float32:
        before = geglu_ff_f32_sm90.launches
        out = geglu_ff_f32_sm90(x, w1, b1, w2, b2, plan)
        geglu_ff.launches += geglu_ff_f32_sm90.launches - before
        return out
    return geglu_ff_bf16_sm90(x, w1, b1, w2, b2, plan)


def geglu_ff_bf16_sm90(x, w1, b1, w2, b2, plan: Optional[GegluPlan] = None):
    """K2's bf16 body (``csrc/geglu_ff_sm90.cu``): GEGLU FF over a bf16 x
    [..., C] as two persistent TMA + wgmma GEMMs with :func:`geglu_plan`'s
    plan (or ``plan``); the weights are read where they lie (bf16,
    contiguous; others are converted). CPU tensors run
    :func:`geglu_ff_plain` after the same checks; a CUDA x that is not
    bf16 raises. Its launches count into ``geglu_ff.launches``."""
    c, h4 = _check_shapes(x, w1, b1, w2, b2)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K2's bf16 body takes bfloat16 activations, got {x.dtype}")
    k2_body(x.dtype, c, h4)
    if not x.is_cuda:
        return geglu_ff_plain(x, w1, b1, w2, b2)
    _build.refuse_grad("geglu_ff (K2)", x, w1, b1, w2, b2)
    if x.numel() == 0:
        return x.new_empty(x.shape)
    p, ptrs, out = _launch_operands(x, w1, b1, w2, b2, c, h4, torch.bfloat16, plan)
    g1, g2 = p
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_geglu_ff_sm90_bf16(
        *ptrs, out.shape[0], c, h4, g1.bn, g1.splits, g1.steps_per_split, g2.bn, g2.splits,
        g2.steps_per_split, ctypes.addressof(launched), _build.stream_ptr(x.device))
    geglu_ff.launches += launched.value
    _build.check(err, "geglu_ff (K2)")
    return out.reshape(x.shape)


def geglu_ff_f32_sm90(x, w1, b1, w2, b2, plan: Optional[GegluPlan] = None):
    """K2's f32 body (``csrc/geglu_ff_f32_sm90.cu``): GEGLU FF over an f32 x
    [..., C] in exact f32 (three TF32 products a product on wgmma, the
    hidden kept in f32), with :func:`geglu_plan`'s f32 plan (or ``plan``).
    The weights are read where they lie (f32, contiguous; others are
    converted). CPU tensors run :func:`geglu_ff_plain` after the same
    checks; a CUDA x that is not f32 raises. ``geglu_ff_f32_sm90.launches`` adds the kernels the library
    reports it launched (``GegluPlan.launches``)."""
    c, h4 = _check_shapes(x, w1, b1, w2, b2)
    if x.dtype != torch.float32:
        raise TypeError(f"K2's f32 body takes float32 activations, got {x.dtype}")
    k2_body(x.dtype, c, h4)
    if not x.is_cuda:
        return geglu_ff_plain(x, w1, b1, w2, b2)
    _build.refuse_grad("geglu_ff (K2, f32 body)", x, w1, b1, w2, b2)
    if x.numel() == 0:
        return x.new_empty(x.shape)
    p, ptrs, out = _launch_operands(x, w1, b1, w2, b2, c, h4, torch.float32, plan)
    g1, g2 = p
    if (g1.bn, g2.bn) != (F32_WIDTHS1[0], F32_WIDTHS2[0]):
        raise ValueError(f"K2's f32 body runs {F32_WIDTHS1[0]}- and {F32_WIDTHS2[0]}-column "
                         f"units; the plan has {g1.bn} and {g2.bn}")
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_geglu_ff_f32_sm90(
        *ptrs, out.shape[0], c, h4, g1.splits, g1.steps_per_split, g2.splits,
        g2.steps_per_split, ctypes.addressof(launched), _build.stream_ptr(x.device))
    geglu_ff_f32_sm90.launches += launched.value
    _build.check(err, "geglu_ff (K2, f32 body)")
    return out.reshape(x.shape)


geglu_ff_f32_sm90.launches = 0
