"""Softmax attention over the [B, S, H*D] layout, with the K1 and K5 CUDA
kernels.

Counterpart of ``complex_prompt_diffusion_tpu/ops/attention.py``. The
dispatch copies the JAX rule (``attention``: Pallas only for KV > 128):

  * KV length <= 128 — cross-attention over the 77 CLIP tokens and the
    UNet middle block at S = 64 — runs :func:`attention_plain`, plain
    PyTorch with an f32 softmax (the port of ``_xla_attention``), on every
    device;
  * longer KV runs :func:`flash_attention` (K1): for CUDA tensors the
    hand-written kernels, by dtype and head dim (:func:`k1_body`): bf16
    with d <= 256 the TMA + wgmma body :func:`attention_sm90`
    (``csrc/attention_sm90.cu``), bf16 with 256 < d <= 512 the wgmma body
    :func:`attention_bf16_wide_sm90` (``csrc/attention_bf16_wide_sm90.cu``),
    f32 with d <= 160 the fused 3xTF32 body :func:`attention_f32_fused_sm90`
    (``csrc/attention_f32_fused_sm90.cu``), f32 with 160 < d <= 512 the
    unfused 3xTF32 body :func:`attention_f32_sm90`
    (``csrc/attention_f32_sm90.cu``); for CPU tensors its plain PyTorch twin
    :func:`attention_plain`;
  * with ``CPD_ATTN_KCANON=1`` in the environment at import (the JAX
    module's switch, read into ``_USE_KCANON``), KV lengths in (128, 16384]
    with head dim <= 256 run :func:`attention_kcanon` instead: q and v are
    copied sequence-major-last ([B, H, D, S]), k is read where it lies, and
    K5 computes on those operands — the port of ``_onepass_kernel_kcanon``.

:func:`self_attention_cm` is the fused channel-major self-attention block
(``UNetConfig.attn_route == "cm"``): the qkv projection is written straight
into ``[3C, B, S]``, K5 reads its ``[H, D, B, S]`` slices in place, and the
output projection contracts the channel-major result — the port of
``self_attention_cm`` / ``_onepass_kernel_hdbs``.

K5's wrapper is :func:`attention_dmajor`; its plain twin is
:func:`attention_dmajor_plain`. For CUDA tensors it launches the Hopper
body :func:`k5_body` names by dtype and head dim (blocks as
:func:`k5_config` gives them): bf16 the TMA + wgmma body
``csrc/attention_cm_sm90.cu``; f32 with d <= 160 the fused 3xTF32 body
``csrc/attention_cm_f32_sm90.cu``, above that its unfused 3xTF32 kernels.
The bodies they replaced (``csrc/attention_cm.cu``) stay callable as
:func:`attention_dmajor_prior`.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import torch

from complex_prompt_diffusion_tpu_torch import _build

__all__ = [
    "attention",
    "flash_attention",
    "attention_plain",
    "attention_sm90",
    "attention_f32_fused_sm90",
    "attention_f32_sm90",
    "attention_f32_fma",
    "f32_sm90_launches",
    "attention_bf16_wide_sm90",
    "attention_bf16_wide_mma",
    "bf16_wide_launches",
    "k1_body",
    "k1_bf16_key_tile",
    "k1_f32_config",
    "attention_dmajor",
    "attention_dmajor_plain",
    "attention_dmajor_prior",
    "attention_cm_sm90_count",
    "attention_cm_f32_sm90_count",
    "k5_body",
    "k5_config",
    "K5Config",
    "attention_kcanon",
    "self_attention_cm",
    "self_attention_cm_plain",
    "SHORT_KV",
]

SHORT_KV = 128  # KV lengths up to this take the plain path on every device

# Above this KV length (or head dim) the JAX package's one-pass kernels hand
# over to its streaming kernel; the kcanon route keeps the same range.
_ONEPASS_MAX_KV = 16384
_ONEPASS_MAX_D = 256

# Canonical-K route of attention() (see attention_kcanon): read once at
# import, like the JAX module's flag of the same name.
_USE_KCANON = os.environ.get("CPD_ATTN_KCANON", "0") == "1"

_ATTN_BF16_DP = (16, 32, 48, 64, 80, 96, 128, 160, 256)  # padded head dims K1 has
_ATTN_MAX_D = 512  # bf16 256 < d <= 512 takes K1's wide body
# f32 256 < d <= 512 (the VAE mid-block) takes the 3xTF32 body, whose
# workspace holds f32 scores and P (hi and lo) for a pass of query rows: at
# most this many bytes of them (B4 S4096 one head: 512 MiB, one pass)
_F32_SM90_SP_BYTES = 1 << 30

# K5's Hopper bodies: the head-dim widths each instantiates (width_of in
# csrc/attention_cm_sm90.cu and csrc/attention_cm_f32_sm90.cu); a head dim
# runs at the first width >= d
_K5_BF16_DV = (16, 32, 40, 48, 64, 80, 96, 128, 160, 256)
_K5_F32_DV = (16, 32, 40, 48, 64, 80, 96, 128, 160)
_K5_F32_FUSED_MAX_D = 160  # above: the unfused 3xTF32 kernels
_SMEM_MAX = 232448  # shared memory a block may use on the H100


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, inner = x.shape
    return x.reshape(b, s, heads, inner // heads).transpose(1, 2)


def attention_plain(q, k, v, num_heads: int, scale: Optional[float] = None):
    """Reference-semantics attention in plain PyTorch: f32 scores and
    softmax, probabilities cast to v's dtype for the PV product, output in
    q's dtype (``_xla_attention`` of the JAX package). [B, S, H*D] in/out."""
    b, sq, inner = q.shape
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh, kh, vh = _split(q, num_heads), _split(k, num_heads), _split(v, num_heads)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), vh)
    return out.transpose(1, 2).reshape(b, sq, inner).to(q.dtype)


def _rows_ok(t: torch.Tensor, vec_elems: int) -> bool:
    """Unit column stride and 16-byte aligned rows/batches (the kernel's
    vector loads)."""
    return (
        t.stride(2) == 1
        and t.stride(1) % vec_elems == 0
        and t.stride(0) % vec_elems == 0
        and t.data_ptr() % 16 == 0
    )


def k1_body(dtype, d: int) -> str:
    """The K1 body a CUDA call of :func:`flash_attention` with head dim
    ``d`` launches: ``"sm90"`` (bf16, d % 8 == 0, d <= 256 with a padded
    width in ``_ATTN_BF16_DP``: ``csrc/attention_sm90.cu``), ``"bf16_wide"``
    (bf16, d % 8 == 0, 256 < d <= 512: ``csrc/attention_bf16_wide_sm90.cu``),
    ``"f32_fused"`` (f32, d % 4 == 0, d <= 160: the fused 3xTF32 kernel of
    ``csrc/attention_f32_fused_sm90.cu``) or ``"f32_sm90"`` (f32, d % 4 ==
    0, 160 < d <= 512: the unfused 3xTF32 kernels of
    ``csrc/attention_f32_sm90.cu``, since no fused block of Q's hi and lo, a
    split K and V tile and a landed K and V tile fits 227 KB above 160).
    Anything else raises."""
    if dtype == torch.bfloat16:
        if d % 8 == 0 and 0 < d <= _ONEPASS_MAX_D and (d + 15) // 16 * 16 in _ATTN_BF16_DP:
            return "sm90"
        if d % 8 == 0 and _ONEPASS_MAX_D < d <= _ATTN_MAX_D:
            return "bf16_wide"
        raise ValueError(f"K1 bf16 supports head dims d % 8 == 0, d <= 512; got {d}")
    if dtype == torch.float32:
        if d % 4 == 0 and 0 < d <= _K5_F32_FUSED_MAX_D:
            return "f32_fused"
        if d % 4 == 0 and _K5_F32_FUSED_MAX_D < d <= _ATTN_MAX_D:
            return "f32_sm90"
        raise ValueError(f"K1 f32 supports head dims d % 4 == 0, d <= 512; got {d}")
    raise TypeError(f"K1 supports bfloat16 and float32, got {dtype}")


def k1_bf16_key_tile(d: int) -> int:
    """Keys a K/V tile of K1's bf16 Hopper body at head dim ``d`` (``k1_bkv``
    in ``csrc/attention_sm90.cuh``): 128 where the head dim takes at most
    two 64-column boxes (d <= 128), 64 above."""
    return 128 if -(-d // 64) <= 2 else 64


def _check_qkv(q, k, v, num_heads):
    b, sq, inner = q.shape
    bk, skv, inner_k = k.shape
    if v.shape != k.shape or bk != b or inner_k != inner or inner % num_heads:
        raise ValueError(
            f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} heads={num_heads} are inconsistent"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _launch(fn, what, q, k, v, num_heads, scale, vec):
    b, sq, inner = q.shape
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.refuse_grad(what, q, k, v)
    q, k, v = (t if _rows_ok(t, vec) else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, num_heads, sq, k.shape[1], d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        float(scale), _build.stream_ptr(q.device),
    )
    _build.check(err, what)
    return out


def flash_attention(q, k, v, num_heads: int, scale: Optional[float] = None):
    """K1 wrapper: softmax(scale * Q K^T) V over [B, S, H*D] operands.

    CPU tensors run :func:`attention_plain`. CUDA tensors launch the body
    :func:`k1_body` names (bf16 with d <= 256: :func:`attention_sm90`; bf16
    with 256 < d <= 512: :func:`attention_bf16_wide_sm90`; f32 with d <= 160:
    :func:`attention_f32_fused_sm90`; f32 with 160 < d <= 512:
    :func:`attention_f32_sm90`) or raise; there is no fallback.
    ``flash_attention.launches`` counts the kernels of every body: one a
    call, or the kernels the unfused bodies report (scores, softmax and
    output a pass; the 3xTF32 body's three split kernels first).
    """
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    _check_qkv(q, k, v, num_heads)
    body = k1_body(q.dtype, q.shape[2] // num_heads)
    if body == "sm90":
        out = _attention_sm90(q, k, v, num_heads, scale)
    elif body == "f32_fused":
        out = _attention_f32_fused_sm90(q, k, v, num_heads, scale)
    else:
        out, n = (_attention_f32_sm90 if body == "f32_sm90" else _attention_bf16_wide_sm90)(
            q, k, v, num_heads, scale)
        flash_attention.launches += n
        return out
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_sm90(q, k, v, num_heads: int, scale: Optional[float] = None):
    """K1's TMA + wgmma body (``csrc/attention_sm90.cu``): bf16 [B, S, H*D]
    operands with a head dim :func:`k1_body` sends to ``"sm90"``; anything
    else raises. Operands are read where they lie when their rows are
    16-byte aligned with unit column stride (TMA's rule; views of one qkv
    projection qualify), else from contiguous copies. CPU tensors run
    :func:`attention_plain`. ``attention_sm90.launches`` counts launches."""
    _check_qkv(q, k, v, num_heads)
    if k1_body(q.dtype, q.shape[2] // num_heads) != "sm90":
        raise ValueError(f"the sm90 attention takes bf16 with d <= 256 (K1's padded widths); "
                         f"got {q.dtype}, d = {q.shape[2] // num_heads}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _attention_sm90(q, k, v, num_heads, scale)


def _attention_sm90(q, k, v, num_heads, scale):
    out = _launch(_build.kernel_library().cpd_attention_sm90_bf16, "attention (K1, sm90 body)",
                  q, k, v, num_heads, scale, 8)
    attention_sm90.launches += 1
    return out


attention_sm90.launches = 0


def attention_f32_fused_sm90(q, k, v, num_heads: int, scale: Optional[float] = None):
    """K1's fused 3xTF32 body (``csrc/attention_f32_fused_sm90.cu``, the
    kernel of ``csrc/attention_f32_fused.cuh`` in its row layout): f32
    [B, S, H*D] operands with d % 4 == 0 and d <= 160; anything else raises.
    Products on the TF32 tensor cores as three products of TF32 high and
    low parts, with the error of f32; blocks as :func:`k1_f32_config` gives
    them. Operands are read where they lie when their rows are 16-byte
    aligned with unit column stride, else from contiguous copies. CPU
    tensors run :func:`attention_plain`. ``attention_f32_fused_sm90.launches``
    counts launches (one a call)."""
    _check_qkv(q, k, v, num_heads)
    if k1_body(q.dtype, q.shape[2] // num_heads) != "f32_fused":
        raise ValueError(f"the fused 3xTF32 attention takes f32 with d <= 160; got {q.dtype}, "
                         f"d = {q.shape[2] // num_heads}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _attention_f32_fused_sm90(q, k, v, num_heads, scale)


def _attention_f32_fused_sm90(q, k, v, num_heads, scale):
    out = _launch(_build.kernel_library().cpd_attention_f32_fused_sm90,
                  "attention (K1, fused 3xTF32 body)", q, k, v, num_heads, scale, 4)
    attention_f32_fused_sm90.launches += 1
    return out


attention_f32_fused_sm90.launches = 0


def k1_f32_config(d: int) -> "K5Config":
    """The block of K1's fused f32 body for head dim ``d`` (``CfgF`` of
    ``csrc/attention_f32_fused.cuh``, which K5's f32 body shares; a card
    test holds this mirror to the C entry): 128 query rows and 64-key tiles
    up to width 80, 128 rows and 32 keys up to 128, 64 rows and 32 keys up
    to 160. Head dims the fused body does not take raise."""
    if k1_body(torch.float32, d) != "f32_fused":
        raise ValueError(f"K1's fused f32 body takes d % 4 == 0, d <= 160; got {d}")
    return K5Config("f32_fused", *_f32_fused_block(d))


def attention_f32_fma(q, k, v, num_heads: int, scale: Optional[float] = None):
    """K1's FMA body for f32 (``csrc/attention.cu``, ``attention_f32.cuh``)
    at any head dim it takes (d % 4 == 0, d <= 512): the body the 3xTF32
    bodies replaced (fused at d <= 160, unfused above), kept callable so
    that they can be timed and checked side by side. CPU tensors run
    :func:`attention_plain`. Its launches are counted by no wrapper:
    :func:`flash_attention` counts the route's."""
    _check_qkv(q, k, v, num_heads)
    d = q.shape[2] // num_heads
    if q.dtype != torch.float32 or d % 4 or not 0 < d <= _ATTN_MAX_D:
        raise ValueError(f"the FMA body takes f32 with d % 4 == 0, d <= 512; got {q.dtype}, "
                         f"d = {d}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _launch(_build.kernel_library().cpd_attention_f32, "attention (K1, FMA body)",
                   q, k, v, num_heads, scale, 4)


def _f32_sm90_rows(b, h, sq, skv) -> int:
    """Query rows a pass of the 3xTF32 body: all of them while their scores
    and P (hi and lo, f32) fit ``_F32_SM90_SP_BYTES``, else a multiple of
    128 that does."""
    per_row = b * h * (-(-skv // 4) * 4) * 8
    if sq * per_row <= _F32_SM90_SP_BYTES:
        return sq
    return max(128, _F32_SM90_SP_BYTES // per_row // 128 * 128)


def f32_sm90_launches(b, h, sq, skv, rows: Optional[int] = None) -> int:
    """Kernels a call of the 3xTF32 body launches: three that split Q, K and
    V, then the scores, softmax and output kernels of each pass of
    ``rows`` query rows (by default as many as the call takes)."""
    rows = min(sq, rows or _f32_sm90_rows(b, h, sq, skv))
    return 3 + 3 * -(-sq // rows)


def _f32_sm90_workspace(b, h, sq, skv, d, rows) -> int:
    """Floats of the 3xTF32 body's workspace (``cpd::f32x3_workspace`` in
    ``csrc/attention_f32_sm90.cu``, which checks it): hi and lo of Q, K and
    V's transpose, of the scores and P of a pass, and the row sums."""
    def r32(n):
        return -(-n // 32) * 32

    z, sp = b * h, -(-skv // 4) * 4
    return (2 * r32(z * sq * d) + 2 * r32(z * skv * d) + 2 * r32(z * d * sp)
            + 2 * r32(z * rows * sp) + r32(z * rows))


def attention_f32_sm90(q, k, v, num_heads: int, scale: Optional[float] = None,
                       rows: Optional[int] = None):
    """K1's unfused 3xTF32 body (``csrc/attention_f32_sm90.cu``): f32
    [B, S, H*D] operands with 160 < d <= 512 and d % 4 == 0; anything else
    raises. The
    products run on the TF32 tensor cores as three products of TF32 high
    and low parts, with the error of f32. ``rows`` forces the query rows a
    pass (the tests cover several passes). CPU tensors run
    :func:`attention_plain`. ``attention_f32_sm90.launches`` adds the
    kernels the library reports it launched (what :func:`f32_sm90_launches`
    predicts)."""
    _check_qkv(q, k, v, num_heads)
    if k1_body(q.dtype, q.shape[2] // num_heads) != "f32_sm90":
        raise ValueError(f"the 3xTF32 attention takes f32 with 160 < d <= 512; got {q.dtype}, "
                         f"d = {q.shape[2] // num_heads}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _attention_f32_sm90(q, k, v, num_heads, scale, rows)[0]


def _attention_f32_sm90(q, k, v, num_heads, scale, rows=None):
    """Launch the 3xTF32 body; (its output, the kernels it launched)."""
    b, sq, inner = q.shape
    skv = k.shape[1]
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.refuse_grad("attention (K1, 3xTF32 body)", q, k, v)
    q, k, v = (t if _rows_ok(t, 4) else t.contiguous() for t in (q, k, v))
    rows = min(sq, rows or _f32_sm90_rows(b, num_heads, sq, skv))
    n_ws = _f32_sm90_workspace(b, num_heads, sq, skv, d, rows)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_attention_f32_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), n_ws,
        b, num_heads, sq, skv, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), rows, ctypes.addressof(launched),
        _build.stream_ptr(q.device))
    attention_f32_sm90.launches += launched.value
    _build.check(err, "attention (K1, 3xTF32 body)")
    return out, launched.value


attention_f32_sm90.launches = 0


def _bf16_wide_rows(b, h, sq, skv) -> int:
    """Query rows a pass of the bf16 wide body: all of them while their
    scores (f32) and P (bf16) fit ``_F32_SM90_SP_BYTES``, else a multiple
    of 128 that does."""
    per_row = b * h * (-(-skv // 8) * 8) * 6
    if sq * per_row <= _F32_SM90_SP_BYTES:
        return sq
    return max(128, _F32_SM90_SP_BYTES // per_row // 128 * 128)


def bf16_wide_launches(b, h, sq, skv, rows: Optional[int] = None) -> int:
    """Kernels a call of the bf16 wide body launches: the scores, softmax
    and output kernels of each pass of ``rows`` query rows (by default as
    many as the call takes)."""
    rows = min(sq, rows or _bf16_wide_rows(b, h, sq, skv))
    return 3 * -(-sq // rows)


def _bf16_wide_workspace(b, h, skv, rows) -> int:
    """Bytes of the bf16 wide body's workspace (``workspace_bytes`` in
    ``csrc/attention_bf16_wide_sm90.cu``, which checks it): S (f32), P
    (bf16) and 1 / sum (f32) of a pass."""
    def r256(n):
        return -(-n // 256) * 256

    z, ld = b * h, -(-skv // 8) * 8
    return r256(z * rows * ld * 4) + r256(z * rows * ld * 2) + r256(z * rows * 4)


def attention_bf16_wide_sm90(q, k, v, num_heads: int, scale: Optional[float] = None,
                             rows: Optional[int] = None):
    """K1's bf16 body for 256 < d <= 512 (``csrc/attention_bf16_wide_sm90.cu``:
    scores, softmax and output kernels on TMA + wgmma): bf16 [B, S, H*D]
    operands with d % 8 == 0; anything else raises. ``rows`` forces the
    query rows a pass (the tests cover several passes). CPU tensors run
    :func:`attention_plain`. ``attention_bf16_wide_sm90.launches`` adds the
    kernels the library reports it launched (what
    :func:`bf16_wide_launches` predicts)."""
    _check_qkv(q, k, v, num_heads)
    if k1_body(q.dtype, q.shape[2] // num_heads) != "bf16_wide":
        raise ValueError(f"the bf16 wide attention takes bf16 with 256 < d <= 512; got "
                         f"{q.dtype}, d = {q.shape[2] // num_heads}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _attention_bf16_wide_sm90(q, k, v, num_heads, scale, rows)[0]


def _attention_bf16_wide_sm90(q, k, v, num_heads, scale, rows=None):
    """Launch the bf16 wide body; (its output, the kernels it launched)."""
    b, sq, inner = q.shape
    skv = k.shape[1]
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.refuse_grad("attention (K1, bf16 wide body)", q, k, v)
    q, k, v = (t if _rows_ok(t, 8) else t.contiguous() for t in (q, k, v))
    rows = min(sq, rows or _bf16_wide_rows(b, num_heads, sq, skv))
    n_ws = _bf16_wide_workspace(b, num_heads, skv, rows)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=q.device)
    out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_attention_bf16_wide_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(), n_ws,
        b, num_heads, sq, skv, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), rows, ctypes.addressof(launched),
        _build.stream_ptr(q.device))
    attention_bf16_wide_sm90.launches += launched.value
    _build.check(err, "attention (K1, bf16 wide body)")
    return out, launched.value


attention_bf16_wide_sm90.launches = 0


def attention_bf16_wide_mma(q, k, v, num_heads: int, scale: Optional[float] = None):
    """K1's mma.sync body for bf16 with 256 < d <= 512 (``csrc/attention.cu``,
    ``attention_bf16_wide_kernel``: the head dim split over 8 warps of a
    64-row query tile), the body :func:`attention_bf16_wide_sm90` replaced,
    kept so that the two can be timed and checked side by side. CPU tensors
    run :func:`attention_plain`. Its launches are counted by no wrapper."""
    _check_qkv(q, k, v, num_heads)
    if k1_body(q.dtype, q.shape[2] // num_heads) != "bf16_wide":
        raise ValueError(f"the mma.sync wide body takes bf16 with 256 < d <= 512; got "
                         f"{q.dtype}, d = {q.shape[2] // num_heads}")
    if not q.is_cuda:
        return attention_plain(q, k, v, num_heads, scale)
    return _launch(_build.kernel_library().cpd_attention_bf16,
                   "attention (K1, mma.sync wide body)", q, k, v, num_heads, scale, 8)


def attention_dmajor_plain(q, k, v, scale: float, k_canonical: bool = False,
                           out_hdbs: bool = False):
    """Plain PyTorch twin of K5: q, v [B, H, D, S]; k [B, H, D, Skv], or
    [B, H, Skv, D] with ``k_canonical``. f32 scores and softmax,
    probabilities cast to v's dtype for the PV product, output [B, H, D, Sq]
    in q's dtype (with ``out_hdbs`` a view of a contiguous [H, D, B, Sq])."""
    kt = k.transpose(-1, -2) if k_canonical else k  # [B, H, D, Skv]
    s = torch.matmul(q.float().transpose(-1, -2), kt.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(v, p.to(v.dtype).transpose(-1, -2)).to(q.dtype)
    if out_hdbs:
        out = out.permute(1, 2, 0, 3).contiguous().permute(2, 0, 1, 3)
    return out


class K5Config(NamedTuple):
    """A K5 Hopper body's block for one dtype and head dim: the body
    (:func:`k5_body`), the width it instantiates (0 for the unfused
    kernels), query rows a block, keys a K/V tile, K/V stages (the bf16
    ring; 1 for the f32 body's one split tile and one landed tile) and the
    shared memory a block takes (0 for the unfused kernels, whose GEMM has
    its own)."""

    body: str
    width: int
    query_rows: int
    key_tile: int
    stages: int
    smem_bytes: int


def k5_body(dtype, d: int) -> str:
    """The body a CUDA call of :func:`attention_dmajor` with head dim ``d``
    launches: ``"sm90"`` (bf16, d % 8 == 0 with ceil(d / 16) * 16 in
    ``_ATTN_BF16_DP``: ``csrc/attention_cm_sm90.cu``), ``"f32_sm90"`` (f32,
    d % 4 == 0, d <= 160: the fused 3xTF32 kernel of
    ``csrc/attention_cm_f32_sm90.cu``) or ``"f32_unfused"`` (f32, d % 4 ==
    0, 160 < d <= 256: its split kernels, then the scores, softmax and
    output kernels of K1's 3xTF32 body, since no fused block of Q's hi and
    lo, a split K and V tile and a landed K and V tile fits 227 KB there).
    Anything else raises."""
    if dtype == torch.bfloat16:
        if d % 8 == 0 and 0 < d and (d + 15) // 16 * 16 in _ATTN_BF16_DP:
            return "sm90"
        raise ValueError(f"K5 bf16 supports head dims d % 8 == 0, d <= 256; got {d}")
    if dtype == torch.float32:
        if d % 4 or not 0 < d <= _ONEPASS_MAX_D:
            raise ValueError(f"K5 f32 supports head dims d % 4 == 0, d <= 256; got {d}")
        return "f32_sm90" if d <= _K5_F32_FUSED_MAX_D else "f32_unfused"
    raise TypeError(f"K5 supports bfloat16 and float32, got {dtype}")


def k5_config(dtype, d: int, k_canonical: bool = False) -> K5Config:
    """The block :func:`k5_body`'s body runs for head dim ``d`` (the
    ``Cfg`` / ``CfgF`` of the CUDA sources, which a card test holds this
    mirror to). bf16: 128 query rows, 128-key tiles at widths up to 128 and
    64 above, as many K/V stages (up to 4) as 227 KB holds beside Q. f32
    fused: 128 query rows and 64-key tiles up to width 80, 128 rows and 32
    keys up to 128, 64 rows and 32 keys up to 160."""
    body = k5_body(dtype, d)
    if body == "f32_unfused":
        return K5Config(body, 0, 0, 0, 0, 0)
    if body == "sm90":
        dv = next(w for w in _K5_BF16_DV if w >= d)
        dr = -(-dv // 16) * 16
        bkv = 128 if dv <= 128 else 64
        nsb, ndb = bkv // 64, -(-dv // 64)
        k_bytes = ndb * bkv * 128 if k_canonical else nsb * dr * 128
        v_bytes = nsb * dv * 128
        q_bytes = 2 * dr * 128
        stages = min(4, (_SMEM_MAX - 1024 - q_bytes - 8) // (k_bytes + v_bytes + 24))
        smem = 1024 + q_bytes + stages * (k_bytes + v_bytes) + (1 + 3 * stages) * 8
        return K5Config(body, dv, 128, bkv, stages, smem)
    return K5Config(body, *_f32_fused_block(d))


def _f32_fused_block(d: int) -> tuple:
    """(width, query rows, key tile, 1, shared-memory bytes) of the fused
    3xTF32 block (``CfgF``) for head dim ``d`` <= 160: Q's hi and lo, one
    split K and V tile, one landed K and V tile."""
    dv = next(w for w in _K5_F32_DV if w >= d)
    nkb = -(-dv // 32)
    bq = 128 if dv <= 128 else 64
    bkv = 64 if dv <= 80 else 32
    smem = (1024 + 2 * nkb * bq * 128 + 2 * nkb * bkv * 128 + 2 * (bkv // 32) * dv * 128
            + 2 * bkv * dv * 4 + 3 * 8)
    return dv, bq, bkv, 1, smem


def _check_dmajor(q, k, v, k_canonical):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention_dmajor expects 4-D [B, H, D, S] operands")
    b, h, d, sq = q.shape
    skv = v.shape[3]
    k_want = (b, h, skv, d) if k_canonical else (b, h, d, skv)
    if tuple(v.shape) != (b, h, d, skv) or tuple(k.shape) != k_want:
        raise ValueError(
            f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} (k_canonical={k_canonical}) are inconsistent"
        )


_K5_WHAT = "attention over channel-major operands (K5)"


def _check_dmajor_cuda(q, k, v):
    """dtype, device and the layout rules both K5 bodies share: sequence
    lengths, strides and bases in 16-byte units, unit stride along the last
    axis."""
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    vec = 8 if q.dtype == torch.bfloat16 else 4
    sq, skv = q.shape[3], v.shape[3]
    if sq % vec or skv % vec:
        raise ValueError(
            f"K5 needs sequence lengths that are multiples of {vec} "
            f"(16-byte loads along S); got Sq={sq}, Skv={skv}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3))
                or t.data_ptr() % 16):
            raise ValueError(
                f"K5 needs {name} with unit stride along its last axis and "
                f"16-byte aligned strides; got strides {t.stride()}"
            )


def _dmajor_out(q, out_hdbs):
    b, h, d, sq = q.shape
    if out_hdbs:
        return torch.empty((h, d, b, sq), dtype=q.dtype, device=q.device).permute(2, 0, 1, 3)
    return torch.empty((b, h, d, sq), dtype=q.dtype, device=q.device)


def _strides(*ts):
    return [t.stride(i) for t in ts for i in range(3)]


def attention_dmajor(q, k, v, scale: float, k_canonical: bool = False,
                     out_hdbs: bool = False):
    """K5 wrapper: softmax(scale * Q K^T) V on operands whose sequence axis
    is contiguous.

    q, v: [B, H, D, S] views with unit stride along S and any other strides
    (so the ``[H, D, B, S]`` slices of a ``[3C, B, S]`` projection and a
    contiguous ``[B, H, D, S]`` both fit); k: the same form, or, with
    ``k_canonical``, a [B, H, Skv, D] view with unit stride along D (read in
    place from a ``[B, S, H*D]`` projection). Returns [B, H, D, Sq]: a fresh
    contiguous tensor, or with ``out_hdbs`` a view of a fresh ``[H, D, B,
    Sq]`` tensor (the ``[C, B, S]`` layout the cm block's output projection
    contracts).

    CPU tensors run :func:`attention_dmajor_plain`. CUDA tensors launch the
    Hopper body :func:`k5_body` names (bf16 with a padded head dim K1 has,
    f32 with d <= 256; Sq, Skv and every stride a multiple of 16 bytes) or
    raise; there is no fallback. ``attention_dmajor.launches`` counts the
    kernels launched: one a call, or what the f32 unfused kernels report
    (3 + 3 a pass); ``attention_cm_sm90_count`` counts them too (the Hopper
    bodies, both dtypes) and ``attention_cm_f32_sm90_count`` those of f32
    calls."""
    _check_dmajor(q, k, v, k_canonical)
    if not q.is_cuda:
        return attention_dmajor_plain(q, k, v, scale, k_canonical, out_hdbs)
    _build.refuse_grad(_K5_WHAT, q, k, v)
    b, h, d, sq = q.shape
    skv = v.shape[3]
    body = k5_body(q.dtype, d)
    _check_dmajor_cuda(q, k, v)
    out = _dmajor_out(q, out_hdbs)
    lib = _build.kernel_library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = _strides(q, k, v, out)
    if body == "sm90":
        err = lib.cpd_attention_cm_sm90_bf16(*ptrs, b, h, sq, skv, d, *strides,
                                             int(k_canonical), float(scale),
                                             _build.stream_ptr(q.device))
        n = 1
    else:
        rows, n_ws, ws = 0, 0, None
        if body == "f32_unfused":
            rows = _f32_sm90_rows(b, h, sq, skv)
            n_ws = _f32_sm90_workspace(b, h, sq, skv, d, rows)
            ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
        launched = ctypes.c_int(0)
        err = lib.cpd_attention_cm_f32_sm90(*ptrs, ws.data_ptr() if ws is not None else None,
                                            n_ws, b, h, sq, skv, d, *strides, int(k_canonical),
                                            float(scale), rows, ctypes.addressof(launched),
                                            _build.stream_ptr(q.device))
        n = launched.value
        attention_cm_f32_sm90_count.launches += n
    attention_dmajor.launches += n
    attention_cm_sm90_count.launches += n
    _build.check(err, _K5_WHAT)
    return out


attention_dmajor.launches = 0


class LaunchCount:
    """A count of kernel launches kept beside a wrapper's own ``.launches``
    (``ops.KERNEL_WRAPPERS`` reads that attribute of each entry)."""

    def __init__(self):
        self.launches = 0


# the kernels attention_dmajor launched on K5's Hopper bodies, and on the f32 one
attention_cm_sm90_count = LaunchCount()
attention_cm_f32_sm90_count = LaunchCount()


def attention_dmajor_prior(q, k, v, scale: float, k_canonical: bool = False,
                           out_hdbs: bool = False):
    """The K5 bodies the Hopper ones replaced (``csrc/attention_cm.cu``:
    bf16 on mma.sync with cp.async, f32 on CUDA-core FMAs), on
    :func:`attention_dmajor`'s operands, kept so that the two can be timed
    and checked side by side. CPU tensors run :func:`attention_dmajor_plain`.
    Its launches are counted by no wrapper."""
    _check_dmajor(q, k, v, k_canonical)
    if not q.is_cuda:
        return attention_dmajor_plain(q, k, v, scale, k_canonical, out_hdbs)
    b, h, d, sq = q.shape
    k5_body(q.dtype, d)  # the same head dims as the Hopper bodies
    what = "attention over channel-major operands (K5, replaced body)"
    _build.refuse_grad(what, q, k, v)
    _check_dmajor_cuda(q, k, v)
    lib = _build.kernel_library()
    fn = lib.cpd_attention_cm_bf16 if q.dtype == torch.bfloat16 else lib.cpd_attention_cm_f32
    out = _dmajor_out(q, out_hdbs)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, v.shape[3], d,
             *_strides(q, k, v, out), int(k_canonical), float(scale),
             _build.stream_ptr(q.device))
    _build.check(err, what)
    return out


def attention_kcanon(q, k, v, num_heads: int, scale: Optional[float] = None):
    """The canonical-K route over [B, S, H*D] operands: d-major copies of q
    and v (the JAX wrapper's transposes), k read in place, K5, and the
    result transposed back to [B, Sq, H*D]."""
    b, sq, inner = q.shape
    skv = k.shape[1]
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def t(x):  # [B, S, H*D] -> contiguous [B, H, D, S]
        return x.reshape(b, x.shape[1], num_heads, d).permute(0, 2, 3, 1).contiguous()

    k_n = k.reshape(b, skv, num_heads, d).permute(0, 2, 1, 3)  # a view of k
    out_t = attention_dmajor(t(q), k_n, t(v), scale, k_canonical=True)
    return out_t.permute(0, 3, 1, 2).reshape(b, sq, inner)


def _self_attention_cm(attn, x, wq, wk, wv, wo, bo, num_heads, scale):
    b, s, c = x.shape
    d = c // num_heads
    if s % 128:
        raise ValueError(
            f"the channel-major path requires self-attention with 128-aligned S; got {s}"
        )
    if scale is None:
        scale = d**-0.5
    w = torch.cat([wq, wk, wv], dim=1).to(x.dtype)  # [C, 3C]
    # [3C, C] x [C, B*S]: the projection lands in [3C, B, S] with no relayout
    qkv = torch.matmul(w.t(), x.reshape(b * s, c).t()).view(3, num_heads, d, b, s)
    q, k, v = (qkv[i].permute(2, 0, 1, 3) for i in range(3))  # [B, H, D, S] views
    out = attn(q, k, v, scale, out_hdbs=True)  # a view of [H, D, B, S]
    out = out.permute(1, 2, 0, 3).reshape(c, b * s)  # [C, B*S], no copy
    y = torch.matmul(out.t(), wo.to(x.dtype)).view(b, s, c)
    return y + bo.to(y.dtype)


def self_attention_cm(x, wq, wk, wv, wo, bo, num_heads: int,
                      scale: Optional[float] = None):
    """Self-attention block on the [B, S, C] stream with channel-major
    internals: q/k/v projection (no bias) into ``[3C, B, S]``, K5 on its
    ``[H, D, B, S]`` slices, output projection (+ ``bo``) from ``[C, B, S]``.
    The two projections are plain matrix products, as they are XLA products
    outside the kernel in the JAX package. Weights are cast to x's dtype."""
    return _self_attention_cm(attention_dmajor, x, wq, wk, wv, wo, bo, num_heads, scale)


def self_attention_cm_plain(x, wq, wk, wv, wo, bo, num_heads: int,
                            scale: Optional[float] = None):
    """:func:`self_attention_cm` with K5 replaced by its plain twin on every
    device."""
    return _self_attention_cm(attention_dmajor_plain, x, wq, wk, wv, wo, bo, num_heads, scale)


def attention(q, k, v, num_heads: int, scale: Optional[float] = None):
    """Attention over [B, S, H*D] tensors (the SpatialTransformer layout).

    KV <= 128 takes the plain f32-softmax path on every device (it is
    bandwidth-trivial there); longer KV goes through K1, or, when the
    kcanon flag is set, through K5 in the range the JAX package's one-pass
    kernels cover."""
    skv = k.shape[1]
    if skv <= SHORT_KV:
        return attention_plain(q, k, v, num_heads, scale)
    if _USE_KCANON and skv <= _ONEPASS_MAX_KV and q.shape[2] // num_heads <= _ONEPASS_MAX_D:
        return attention_kcanon(q, k, v, num_heads, scale)
    return flash_attention(q, k, v, num_heads, scale)
