"""The attention probe: K1's and K5's loops with pieces of the work removed
or one design choice changed, through the K7 CUDA kernel
(``csrc/probe_attention.cu``). A probe no layer dispatches.

Counterpart of the TPU probe scripts ``scripts/perf_attn8.py`` ..
``perf_attn12.py``: the instruments the TPU attention kernels were tuned
with. Each mode or flag computes the function the script's kernel computes,
on K1's ``[B, S, H*D]`` layout (or K5's d-major one), with ``scale`` passed
through where a script folds it into q. ``sc`` below is ``scale * log2(e)``
with ``exp="exp2"`` (scores in the base of exp2, as K1 keeps them) and
``scale`` with ``exp="exp"``.

:func:`attention_probe` (K1's layout), ``mode``:

  * ``"full"``: softmax attention; ``denom="sum"`` (row sums of P, K1's
    choice) or ``"ones"`` (a ones column in V at column d, so the PV
    product yields the denominator: ``perf_attn9`` V2/V3, d in 40, 80,
    160); ``exp="exp2"`` (K1) or ``"exp"`` (V1/V2); ``kv_tile`` 64 keys
    (K1) or 128 (``perf_attn8``'s block sweep); ``unnormalized=True`` with
    the ones column returns the f32 accumulator ``[B, H, Sq, d + 8]`` with l
    in column d (``perf_attn11`` h2);
  * ``"scores"``: ``sc * (q . k_0)`` on every column (``perf_attn10`` A; on
    f32 operands F);
  * ``"max"``: the row max of ``sc * q k^T`` (B);
  * ``"exp"``: ``P[:, key 0]`` for the final max, rounded to bf16 (C);
  * ``"pv"``: ``q[:, 0] * sum_keys v`` (E: P is q's first head-dim column);
  * ``"rowsum"``: ``l = sum_keys exp2(sc * s - m)`` (G);
  * ``"loads"`` (no script has it): the Q, K and V tiles streamed as in the
    attention, no arithmetic; ``q[:, 0]`` on every column.

:func:`attention_dmajor_scores` is K5's loop in mode ``"scores"``
(``perf_attn12``'s QK-only ablations of the v3 and h1 forms).
:func:`v3_attention` and :func:`h2_attention` are the ``perf_attn12`` /
``perf_attn11`` wrappers at the UNet interface (every copy inside);
``ops.attention.attention_kcanon`` is the h1 form.

CPU tensors run the plain twins; CUDA tensors launch K7 or raise.
``attention_probe.launches`` counts K7's launches (both wrappers).
"""

from __future__ import annotations

import math

import torch

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.attention import attention_dmajor

__all__ = [
    "MODES",
    "attention_probe",
    "attention_probe_plain",
    "attention_dmajor_scores",
    "attention_dmajor_scores_plain",
    "to_dmajor",
    "v3_attention",
    "h2_attention",
]

LOG2E = math.log2(math.e)
MODES = {"full": 0, "scores": 1, "max": 2, "exp": 3, "pv": 4, "rowsum": 5, "loads": 6}
_DENOMS = {"sum": 0, "ones": 1}
_PROBE_DP = (48, 80, 160)  # padded head dims K7 is built for (d = 40 .. 160)


def _heads(x, num_heads):
    b, s, inner = x.shape
    return x.reshape(b, s, num_heads, inner // num_heads).transpose(1, 2)  # [B, H, S, D]


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _check_combo(mode, denom, exp, unnormalized, kv_tile, d, dtype):
    if mode not in MODES or denom not in _DENOMS or exp not in ("exp2", "exp"):
        raise ValueError(f"unknown probe mode/denom/exp: {mode!r} {denom!r} {exp!r}")
    if dtype == torch.float32:
        if mode != "scores" or d % 4 or d > 512:
            raise ValueError(f"K7 on f32 operands is the scores mode with d % 4 == 0, d <= 512; "
                             f"got {mode!r}, d={d}")
        return
    if dtype != torch.bfloat16:
        raise TypeError(f"K7 supports bfloat16 (and f32 scores), got {dtype}")
    if d % 8 or (d + 15) // 16 * 16 not in _PROBE_DP:
        raise ValueError(f"K7 takes head dims padded to {_PROBE_DP}; got d={d}")
    if mode != "full" and (denom, exp, unnormalized, kv_tile) != ("sum", "exp2", False, 64):
        raise ValueError(f"mode {mode!r} runs K1's own choices (sum, exp2, 64 keys)")
    if kv_tile not in (64, 128):
        raise ValueError(f"kv_tile is 64 or 128 keys, got {kv_tile}")
    if kv_tile == 128 and (denom, exp, unnormalized) != ("sum", "exp2", False):
        raise ValueError("128-key tiles run with K1's denominator and exp2")
    if denom == "ones" and d not in (40, 80, 160):
        raise ValueError(f"the ones column is built for d in 40, 80, 160; got {d}")
    if unnormalized and (denom, exp) != ("ones", "exp2"):
        raise ValueError("the unnormalized output carries l from the ones column (exp2)")


def attention_probe_plain(q, k, v, num_heads: int, scale: float, mode: str = "full",
                          denom: str = "sum", exp: str = "exp2", unnormalized: bool = False,
                          kv_tile: int = 64):
    """Plain PyTorch twin of K7 on K1's layout (f32 scores; P rounded to
    v's dtype before the PV product; the ones denominator sums the rounded
    P). ``kv_tile`` changes no value."""
    b, sq, inner = q.shape
    d = inner // num_heads
    _check_combo(mode, denom, exp, unnormalized, kv_tile, d, q.dtype)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    sc = scale * LOG2E if exp == "exp2" else scale
    if mode == "pv":
        o = qh[..., :1].float() * vh.float().sum(dim=2, keepdim=True)
        return _merge(o).to(q.dtype)
    if mode == "loads":
        return _merge(qh[..., :1].expand(-1, -1, -1, d)).to(q.dtype)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * sc  # [B, H, Sq, Skv]
    if mode == "scores":
        return _merge(s[..., :1].expand(-1, -1, -1, d)).to(q.dtype)
    m = s.amax(dim=-1, keepdim=True)
    if mode == "max":
        return _merge(m.expand(-1, -1, -1, d)).to(q.dtype)
    p = torch.exp2(s - m) if exp == "exp2" else torch.exp(s - m)
    pb = p.to(v.dtype)
    if mode == "exp":
        return _merge(pb[..., :1].float().expand(-1, -1, -1, d)).to(q.dtype)
    if mode == "rowsum":
        return _merge(p.sum(dim=-1, keepdim=True).expand(-1, -1, -1, d)).to(q.dtype)
    o = torch.matmul(pb.float(), vh.float())
    l = (pb.float() if denom == "ones" else p).sum(dim=-1, keepdim=True)
    if unnormalized:
        pad = torch.zeros(o.shape[:-1] + (7,), dtype=torch.float32, device=o.device)
        return torch.cat([o, l, pad], dim=-1)  # [B, H, Sq, d + 8]
    return _merge(o / l).to(q.dtype)


def attention_probe(q, k, v, num_heads: int, scale: float, mode: str = "full",
                    denom: str = "sum", exp: str = "exp2", unnormalized: bool = False,
                    kv_tile: int = 64):
    """K7 wrapper on K1's layout: q [B, Sq, H*D], k and v [B, Skv, H*D]
    (any batch and row strides, unit column stride). Returns [B, Sq, H*D]
    in q's dtype, or with ``unnormalized`` a fresh [B, H, Sq, D + 8] f32.
    bf16 (every mode; d = 40 .. 160 of the UNet levels) or f32 (mode
    ``"scores"``: K1's f32 loop). CPU tensors run
    :func:`attention_probe_plain`; CUDA tensors launch K7 or raise."""
    b, sq, inner = q.shape
    bk, skv, inner_k = k.shape
    if v.shape != k.shape or bk != b or inner_k != inner or inner % num_heads:
        raise ValueError(f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={num_heads} are inconsistent")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    d = inner // num_heads
    _check_combo(mode, denom, exp, unnormalized, kv_tile, d, q.dtype)
    if not q.is_cuda:
        return attention_probe_plain(q, k, v, num_heads, scale, mode, denom, exp,
                                     unnormalized, kv_tile)
    vec = 8 if q.dtype == torch.bfloat16 else 4
    q, k, v = (t if t.stride(2) == 1 and t.stride(1) % vec == 0 and t.stride(0) % vec == 0
               and t.data_ptr() % 16 == 0 else t.contiguous() for t in (q, k, v))
    lib = _build.kernel_library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    if unnormalized:
        out = torch.empty((b, num_heads, sq, d + 8), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        err = lib.cpd_probe_attention_f32(*args, out.data_ptr(), b, num_heads, sq, skv, d,
                                          *strides, float(scale), MODES[mode],
                                          _build.stream_ptr(q.device))
    else:
        err = lib.cpd_probe_attention_bf16(*args, out.data_ptr(), b, num_heads, sq, skv, d,
                                           *strides, float(scale), MODES[mode], _DENOMS[denom],
                                           int(exp == "exp2"), int(unnormalized), int(kv_tile),
                                           _build.stream_ptr(q.device))
    _build.check(err, f"attention probe (K7, {mode})")
    attention_probe.launches += 1
    return out


attention_probe.launches = 0


def attention_dmajor_scores_plain(q, k, v, scale: float, k_canonical: bool = False):
    """Plain twin of K5's scores mode: ``scale * log2(e) * (q . k_0)`` on
    every head-dim row of a [B, H, D, Sq] output in q's dtype."""
    kt = k.transpose(-1, -2) if k_canonical else k  # [B, H, D, Skv]
    s0 = torch.matmul(q.float().transpose(-1, -2), kt[..., :1].float()) * (scale * LOG2E)
    return s0.transpose(-1, -2).expand(-1, -1, q.shape[2], -1).to(q.dtype).contiguous()


def attention_dmajor_scores(q, k, v, scale: float, k_canonical: bool = False):
    """K7's launch of K5's loop in the scores mode, on K5's operands (see
    ``ops.attention.attention_dmajor``; bf16, d = 40 .. 160). Returns a
    fresh [B, H, D, Sq]. Counts into ``attention_probe.launches``."""
    b, h, d, sq = q.shape
    skv = v.shape[3]
    k_want = (b, h, skv, d) if k_canonical else (b, h, d, skv)
    if tuple(v.shape) != (b, h, d, skv) or tuple(k.shape) != k_want:
        raise ValueError(f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (k_canonical={k_canonical}) are inconsistent")
    if not q.is_cuda:
        return attention_dmajor_scores_plain(q, k, v, scale, k_canonical)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("K5's scores mode takes bf16 operands")
    if d % 8 or (d + 15) // 16 * 16 not in _PROBE_DP or sq % 8 or skv % 8:
        raise ValueError(f"K5's scores mode takes d = 40 .. 160 and S % 8 == 0; got d={d}, "
                         f"Sq={sq}, Skv={skv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3)) or t.data_ptr() % 16:
            raise ValueError(f"K5 needs {name} with unit stride along its last axis and "
                             f"16-byte aligned strides; got strides {t.stride()}")
    out = torch.empty((b, h, d, sq), dtype=q.dtype, device=q.device)
    err = _build.kernel_library().cpd_probe_attention_cm_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(k_canonical), float(scale), MODES["scores"], _build.stream_ptr(q.device))
    _build.check(err, "attention probe (K7, K5's loop, scores)")
    attention_probe.launches += 1
    return out


def to_dmajor(x, num_heads: int):
    """[B, S, H*D] -> a contiguous [B, H, D, S] copy."""
    b, s, inner = x.shape
    return x.reshape(b, s, num_heads, inner // num_heads).permute(0, 2, 3, 1).contiguous()


def v3_attention(q, k, v, num_heads: int, scale: float, attn=attention_dmajor):
    """``perf_attn12``'s v3 form at the UNet interface: q, k and v copied
    d-major, K5 (or ``attn``, e.g. :func:`attention_dmajor_scores`) on the
    copies, the result transposed back to [B, Sq, H*D]."""
    b, sq, inner = q.shape
    out = attn(to_dmajor(q, num_heads), to_dmajor(k, num_heads), to_dmajor(v, num_heads), scale)
    return out.permute(0, 3, 1, 2).reshape(b, sq, inner)


def h2_attention(q, k, v, num_heads: int, scale: float):
    """``perf_attn11``'s h2 form: K7 with the ones column and the
    unnormalized f32 output, divided by its column d outside the kernel."""
    b, sq, inner = q.shape
    d = inner // num_heads
    o = attention_probe(q, k, v, num_heads, scale, "full", "ones", "exp2", unnormalized=True)
    return _merge(o[..., :d] / o[..., d:d + 1]).to(q.dtype)
