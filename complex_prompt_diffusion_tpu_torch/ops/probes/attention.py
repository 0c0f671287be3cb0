"""The attention probe: K1's and K5's Hopper loops and K1's fused f32 body
with pieces of the work removed or one design choice changed, through the
K7 CUDA kernel (``csrc/probe_attention.cu``). A probe no layer dispatches.

Counterpart of the TPU probe scripts ``scripts/perf_attn8.py`` ..
``perf_attn12.py``: the instruments the TPU attention kernels were tuned
with. Each mode or flag computes the function the script's kernel computes,
on K1's ``[B, S, H*D]`` layout (or K5's d-major one), with ``scale`` passed
through where a script folds it into q. ``sc`` below is ``scale * log2(e)``
with ``exp="exp2"`` (scores in the base of exp2, as K1 keeps them) and
``scale`` with ``exp="exp"``.

:func:`attention_probe` (K1's layout, head dims 40, 80 and 160: the UNet's),
``mode``:

  * ``"full"``: softmax attention; ``denom="sum"`` (row sums of P, K1's
    choice) or ``"ones"`` (a ones column in V at column d, so the PV
    product yields the denominator: ``perf_attn9`` V2/V3); ``exp="exp2"``
    (K1) or ``"exp"`` (V1/V2); ``kv_tile`` K1's own key tile (the default:
    :func:`~complex_prompt_diffusion_tpu_torch.ops.attention.k1_bf16_key_tile`,
    128 keys at d <= 128 and 64 at 160) or 64 where K1 takes 128, at K1's
    other choices (``perf_attn8``'s block sweep); ``unnormalized=True``
    with the ones column returns the f32 accumulator ``[B, H, Sq, d + 8]``
    with l in column d (``perf_attn11`` h2);
  * ``"scores"``: ``sc * (q . k_0)`` on every column (``perf_attn10`` A; on
    f32 operands F, on K1's fused 3xTF32 body);
  * ``"max"``: the row max of ``sc * q k^T`` (B);
  * ``"exp"``: ``P[:, key 0]`` for the final max, rounded to bf16 (C);
  * ``"pv"``: ``q[:, 0] * sum_keys v`` (E: P is q's first head-dim column);
  * ``"rowsum"``: ``l = sum_keys exp2(sc * s - m)`` (G);
  * ``"loads"`` (no script has it): the Q, K and V tiles streamed as in the
    attention, no arithmetic; ``q[:, 0]`` on every column.

Every mode other than ``"full"`` runs at K1's choices (row sums, exp2,
K1's key tile); the full mode takes one choice changed at a time.

:func:`attention_dmajor_scores` is K5's Hopper loop in mode ``"scores"``
(``perf_attn12``'s QK-only ablations of the v3 and h1 forms).
:func:`v3_attention` and :func:`h2_attention` are the ``perf_attn12`` /
``perf_attn11`` wrappers at the UNet interface (every copy inside);
``ops.attention.attention_kcanon`` is the h1 form.

The loops K7 ran before it moved onto the Hopper loops (K1's and K5's
mma.sync loops, K1's f32 FMA loop: ``csrc/probe_attention_prior.cu``) stay
callable as :func:`attention_probe_prior` and
:func:`attention_dmajor_scores_prior`, with the combinations they were
built for, so that the two can be timed side by side; no wrapper falls
back to them.

CPU tensors run the plain twins; CUDA tensors launch K7 or raise.
``attention_probe.launches`` counts K7's launches (both wrappers);
``attention_probe_prior.launches`` those of the replaced loops (counted by
no registry).
"""

from __future__ import annotations

import math

import torch

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.attention import attention_dmajor, k1_bf16_key_tile

__all__ = [
    "MODES",
    "attention_probe",
    "attention_probe_plain",
    "attention_probe_prior",
    "attention_dmajor_scores",
    "attention_dmajor_scores_plain",
    "attention_dmajor_scores_prior",
    "to_dmajor",
    "v3_attention",
    "h2_attention",
]

LOG2E = math.log2(math.e)
MODES = {"full": 0, "scores": 1, "max": 2, "exp": 3, "pv": 4, "rowsum": 5, "loads": 6}
_DENOMS = {"sum": 0, "ones": 1}
_PROBE_D = (40, 80, 160)  # the head dims K7 is built for: the UNet's levels
_PRIOR_DP = (48, 80, 160)  # padded head dims the replaced loops are built for (d = 40 .. 160)


def _heads(x, num_heads):
    b, s, inner = x.shape
    return x.reshape(b, s, num_heads, inner // num_heads).transpose(1, 2)  # [B, H, S, D]


def _merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _check_names(mode, denom, exp):
    if mode not in MODES or denom not in _DENOMS or exp not in ("exp2", "exp"):
        raise ValueError(f"unknown probe mode/denom/exp: {mode!r} {denom!r} {exp!r}")


def _check_combo(mode, denom, exp, unnormalized, kv_tile, d, dtype):
    """What K7 on the Hopper loops takes: head dims 40, 80, 160; bf16 every
    mode, every ablated mode at K1's choices (row sums, exp2, K1's key
    tile), the full mode with one choice changed (exp, the ones column, the
    ones column unnormalized at K1's tile; 64-key tiles where K1 takes 128);
    f32 the scores mode on the fused 3xTF32 body. ``kv_tile`` None is K1's
    tile. Returns the key tile."""
    _check_names(mode, denom, exp)
    if d not in _PROBE_D:
        raise ValueError(f"K7 takes the UNet's head dims {_PROBE_D}; got d={d}")
    own = k1_bf16_key_tile(d)
    tile = own if kv_tile is None else kv_tile
    if dtype == torch.float32:
        if mode != "scores" or (denom, exp, unnormalized, tile) != ("sum", "exp2", False, own):
            raise ValueError(f"K7 on f32 operands is the scores mode of the fused body; got "
                             f"{mode!r}")
        return tile
    if dtype != torch.bfloat16:
        raise TypeError(f"K7 supports bfloat16 (and f32 scores), got {dtype}")
    k1_choices = (denom, exp, unnormalized) == ("sum", "exp2", False)
    if tile not in (64, 128):
        raise ValueError(f"kv_tile is 64 or 128 keys, got {kv_tile}")
    if mode != "full" and (not k1_choices or tile != own):
        raise ValueError(f"mode {mode!r} runs K1's own choices (sum, exp2, {own} keys at d={d})")
    if tile != own and (own == 64 or not k1_choices):
        raise ValueError(f"{tile}-key tiles run the full mode at K1's other choices where K1 "
                         f"takes {own} (128-key tiles do not fit at d = 160)")
    if unnormalized and (denom, exp) != ("ones", "exp2"):
        raise ValueError("the unnormalized output carries l from the ones column (exp2)")
    return tile


def _check_combo_prior(mode, denom, exp, unnormalized, kv_tile, d, dtype):
    """What the replaced loops take (their rules: d padded to 48, 80, 160;
    ablated modes at 64 keys; f32 scores up to d = 512)."""
    _check_names(mode, denom, exp)
    if dtype == torch.float32:
        if mode != "scores" or d % 4 or d > 512:
            raise ValueError(f"K7's f32 FMA loop is the scores mode with d % 4 == 0, d <= 512; "
                             f"got {mode!r}, d={d}")
        return
    if dtype != torch.bfloat16:
        raise TypeError(f"K7 supports bfloat16 (and f32 scores), got {dtype}")
    if d % 8 or (d + 15) // 16 * 16 not in _PRIOR_DP:
        raise ValueError(f"K7's replaced loop takes head dims padded to {_PRIOR_DP}; got d={d}")
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


def _plain(q, k, v, num_heads, scale, mode, denom, exp, unnormalized):
    """The probe's function in plain PyTorch (f32 scores; P rounded to v's
    dtype before the PV product; the ones denominator sums the rounded P)."""
    b, sq, inner = q.shape
    d = inner // num_heads
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


def attention_probe_plain(q, k, v, num_heads: int, scale: float, mode: str = "full",
                          denom: str = "sum", exp: str = "exp2", unnormalized: bool = False,
                          kv_tile=None):
    """Plain PyTorch twin of K7 on K1's layout (f32 scores; P rounded to
    v's dtype before the PV product; the ones denominator sums the rounded
    P). ``kv_tile`` changes no value."""
    d = q.shape[2] // num_heads
    _check_combo(mode, denom, exp, unnormalized, kv_tile, d, q.dtype)
    return _plain(q, k, v, num_heads, scale, mode, denom, exp, unnormalized)


def _probe_operands(q, k, v, num_heads):
    b, sq, inner = q.shape
    bk, skv, inner_k = k.shape
    if v.shape != k.shape or bk != b or inner_k != inner or inner % num_heads:
        raise ValueError(f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={num_heads} are inconsistent")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")


def _probe_launch(fns, what, q, k, v, num_heads, scale, mode, denom, exp, unnormalized,
                  kv_tile):
    """Launch K7 (``fns``: the bf16 and f32 C entries of a loop) on CUDA
    operands; returns the output."""
    b, sq, inner = q.shape
    skv, d = k.shape[1], inner // num_heads
    vec = 8 if q.dtype == torch.bfloat16 else 4
    q, k, v = (t if t.stride(2) == 1 and t.stride(1) % vec == 0 and t.stride(0) % vec == 0
               and t.data_ptr() % 16 == 0 else t.contiguous() for t in (q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    if unnormalized:
        out = torch.empty((b, num_heads, sq, d + 8), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty((b, sq, inner), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        err = fns[1](*args, out.data_ptr(), b, num_heads, sq, skv, d, *strides, float(scale),
                     MODES[mode], _build.stream_ptr(q.device))
    else:
        err = fns[0](*args, out.data_ptr(), b, num_heads, sq, skv, d, *strides, float(scale),
                     MODES[mode], _DENOMS[denom], int(exp == "exp2"), int(unnormalized),
                     int(kv_tile), _build.stream_ptr(q.device))
    _build.check(err, f"{what}, {mode}")
    return out


def attention_probe(q, k, v, num_heads: int, scale: float, mode: str = "full",
                    denom: str = "sum", exp: str = "exp2", unnormalized: bool = False,
                    kv_tile=None):
    """K7 wrapper on K1's layout: q [B, Sq, H*D], k and v [B, Skv, H*D]
    (any batch and row strides, unit column stride), head dims 40, 80 and
    160. Returns [B, Sq, H*D] in q's dtype, or with ``unnormalized`` a fresh
    [B, H, Sq, D + 8] f32. bf16: every mode on K1's Hopper loop
    (``kv_tile`` None is K1's key tile); f32: mode ``"scores"`` on K1's fused
    3xTF32 body. CPU tensors run :func:`attention_probe_plain`; CUDA tensors
    launch K7 or raise."""
    _probe_operands(q, k, v, num_heads)
    tile = _check_combo(mode, denom, exp, unnormalized, kv_tile, q.shape[2] // num_heads,
                        q.dtype)
    if not q.is_cuda:
        return _plain(q, k, v, num_heads, scale, mode, denom, exp, unnormalized)
    _build.refuse_grad("attention probe (K7)", q, k, v)
    lib = _build.kernel_library()
    out = _probe_launch((lib.cpd_probe_attention_bf16, lib.cpd_probe_attention_f32),
                        "attention probe (K7)", q, k, v, num_heads, scale, mode, denom, exp,
                        unnormalized, tile)
    attention_probe.launches += 1
    return out


attention_probe.launches = 0


def attention_probe_prior(q, k, v, num_heads: int, scale: float, mode: str = "full",
                          denom: str = "sum", exp: str = "exp2", unnormalized: bool = False,
                          kv_tile: int = 64):
    """K7's replaced loops (``csrc/probe_attention_prior.cu``) on
    :func:`attention_probe`'s operands, with the combinations they were built
    for: bf16 on K1's mma.sync loop (d padded to 48, 80, 160; ablated modes
    at 64 keys; the full mode at 64 or 128), f32 scores on K1's FMA loop
    (d % 4 == 0, d <= 512). Kept so that the two can be timed side by side;
    CPU tensors run the plain twin. ``attention_probe_prior.launches``
    counts its launches (in no registry)."""
    _probe_operands(q, k, v, num_heads)
    _check_combo_prior(mode, denom, exp, unnormalized, kv_tile, q.shape[2] // num_heads,
                       q.dtype)
    if not q.is_cuda:
        return _plain(q, k, v, num_heads, scale, mode, denom, exp, unnormalized)
    _build.refuse_grad("attention probe (K7, replaced loop)", q, k, v)
    lib = _build.kernel_library()
    out = _probe_launch((lib.cpd_probe_attention_prior_bf16, lib.cpd_probe_attention_prior_f32),
                        "attention probe (K7, replaced loop)", q, k, v, num_heads, scale, mode,
                        denom, exp, unnormalized, kv_tile)
    attention_probe_prior.launches += 1
    return out


attention_probe_prior.launches = 0


def attention_dmajor_scores_plain(q, k, v, scale: float, k_canonical: bool = False):
    """Plain twin of K5's scores mode: ``scale * log2(e) * (q . k_0)`` on
    every head-dim row of a [B, H, D, Sq] output in q's dtype."""
    kt = k.transpose(-1, -2) if k_canonical else k  # [B, H, D, Skv]
    s0 = torch.matmul(q.float().transpose(-1, -2), kt[..., :1].float()) * (scale * LOG2E)
    return s0.transpose(-1, -2).expand(-1, -1, q.shape[2], -1).to(q.dtype).contiguous()


def _dmajor_scores(fn, what, d_ok, q, k, v, scale, k_canonical):
    """K5's operands checked and ``fn`` (a C entry in the scores mode)
    launched on them; ``d_ok`` names the head dims the loop takes."""
    b, h, d, sq = q.shape
    skv = v.shape[3]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("K5's scores mode takes bf16 operands")
    if not d_ok(d) or sq % 8 or skv % 8:
        raise ValueError(f"{what} takes d in {_PROBE_D} (the replaced loop: d = 40 .. 160) and "
                         f"S % 8 == 0; got d={d}, Sq={sq}, Skv={skv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3)) or t.data_ptr() % 16:
            raise ValueError(f"K5 needs {name} with unit stride along its last axis and "
                             f"16-byte aligned strides; got strides {t.stride()}")
    out = torch.empty((b, h, d, sq), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             int(k_canonical), float(scale), MODES["scores"], _build.stream_ptr(q.device))
    _build.check(err, f"{what}, scores")
    return out


def _check_dmajor(q, k, v, k_canonical):
    b, h, d, sq = q.shape
    skv = v.shape[3]
    k_want = (b, h, skv, d) if k_canonical else (b, h, d, skv)
    if tuple(v.shape) != (b, h, d, skv) or tuple(k.shape) != k_want:
        raise ValueError(f"attention shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (k_canonical={k_canonical}) are inconsistent")


def attention_dmajor_scores(q, k, v, scale: float, k_canonical: bool = False):
    """K7's launch of K5's Hopper loop in the scores mode, on K5's operands
    (see ``ops.attention.attention_dmajor``; bf16, d = 40, 80, 160). Returns
    a fresh [B, H, D, Sq]. Counts into ``attention_probe.launches``."""
    _check_dmajor(q, k, v, k_canonical)
    if not q.is_cuda:
        return attention_dmajor_scores_plain(q, k, v, scale, k_canonical)
    _build.refuse_grad("attention probe (K7, K5's loop)", q, k, v)
    out = _dmajor_scores(_build.kernel_library().cpd_probe_attention_cm_bf16,
                         "attention probe (K7, K5's loop)", lambda d: d in _PROBE_D, q, k, v,
                         scale, k_canonical)
    attention_probe.launches += 1
    return out


def attention_dmajor_scores_prior(q, k, v, scale: float, k_canonical: bool = False):
    """:func:`attention_dmajor_scores` on K5's replaced mma.sync loop
    (``csrc/probe_attention_prior.cu``; d padded to 48, 80 or 160), kept so
    that the two can be timed side by side. Counts into
    ``attention_probe_prior.launches``."""
    _check_dmajor(q, k, v, k_canonical)
    if not q.is_cuda:
        return attention_dmajor_scores_plain(q, k, v, scale, k_canonical)
    _build.refuse_grad("attention probe (K7, K5's replaced loop)", q, k, v)
    out = _dmajor_scores(_build.kernel_library().cpd_probe_attention_prior_cm_bf16,
                         "attention probe (K7, K5's replaced loop)",
                         lambda d: d % 8 == 0 and (d + 15) // 16 * 16 in _PRIOR_DP, q, k, v,
                         scale, k_canonical)
    attention_probe_prior.launches += 1
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
