"""GroupNorm(+SiLU) over NHWC activations, with the K3 CUDA kernel.

Counterpart of ``complex_prompt_diffusion_tpu/ops/groupnorm.py``. One
dispatch rule, no TPU gates carried over: every CUDA tensor goes through
``csrc/groupnorm_sm90.cu`` (the bf16 UNet sites, the bf16 VAE planes and the
f32 VAE-decode planes alike), in the form :func:`group_norm_plan` picks; CPU
tensors go through the plain twin :func:`group_norm_plain`. Statistics are
f32, with the JAX package's rule by dtype: one pass (E[x^2] - E[x]^2,
clamped at 0) for <= 16-bit inputs, as in ``_gn_xla_mm`` and
``_gn_stats_kernel``; centered (two-pass) for f32, as in
``_gn_stats2_kernel``. The body this replaced (``csrc/groupnorm.cu``) stays
callable as :func:`group_norm_prior`.

:func:`group_norm_silu_cat` is GroupNorm(+SiLU) of ``concat([a, b], -1)``
without the concat (the UNet's up-path ResBlocks, whose input is the hidden
state beside its skip): on CUDA tensors K3's two-source form, its slab
(one launch) or split form as :func:`group_norm_cat_plan` picks, on CPU
tensors :func:`group_norm_silu_cat_plain`; its statistics are one pass in
f32 whatever the dtype, as the JAX function's are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.attention import LaunchCount

__all__ = ["group_norm", "group_norm_silu", "group_norm_nhwc", "group_norm_plain",
           "group_norm_plan", "GnPlan", "slab_groups", "group_norm_prior", "gn_splits",
           "prefers_mm_stats", "group_norm_silu_cat", "group_norm_silu_cat_plain",
           "group_norm_cat_plan", "cat_slab_groups", "cat_box_bytes",
           "group_norm_cat_slab_count"]


def group_norm_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                     silu: bool = False):
    """Plain PyTorch GroupNorm over NHWC with f32 statistics: one-pass for
    <= 16-bit inputs (``_gn_xla_mm`` of the JAX package), two-pass for f32
    (``_gn_xla``)."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    if x.element_size() <= 2:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        ex2 = xf.square().mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
    else:
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * gamma.float() + beta.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


_PRIOR_FNS = {torch.float32: "cpd_group_norm_f32", torch.bfloat16: "cpd_group_norm_bf16"}
_GN_THREADS = 512  # threads of a block of the replaced body
_GN_MIN_SPLIT_ELEMS = 32 * _GN_THREADS  # elements a split block handles at least

# csrc/groupnorm_sm90.cu: the bytes of a sample one block of the slab form
# holds (kTileMax), a slab's widest channels and most TMA boxes (of 256
# pixels), its widest C and G
_TILE_BYTES = 192896
_SLAB_MAX_C = 256
_SLAB_MAX_BOXES = 32
_MAX_C = 4096
_MAX_GROUPS = 256


class GnPlan(NamedTuple):
    """How K3 runs one call, of one input or of two (the two-source form):
    ``form`` "slab" (one launch: a block holds ``tiles`` whole groups of a
    sample) or "split" (a statistics and an apply launch over ``tiles``
    tiles a sample), and the kernels it launches."""

    form: str
    tiles: int
    launches: int


_FORMS = {"split": 0, "slab": 1}  # the C entry's form codes


@functools.lru_cache(maxsize=1024)
def group_norm_plan(n: int, hw: int, c: int, groups: int, dtype, sms: int) -> GnPlan:
    """The form and its blocks K3 runs for ``n`` samples of ``hw`` pixels x
    ``c`` channels in ``groups`` groups (``dtype`` float32 or bfloat16) on a
    card of ``sms`` SMs.

    Slab where whole groups of a sample fit a block: the fewest groups a
    block (the most blocks) whose n x groups / k blocks still run in one
    wave (one block an SM: 544 threads of 96 registers), else the most
    groups a block. Otherwise split, over ``sms // n`` tiles a sample: one
    wave. Pure Python, cached by shape."""
    if n <= 0 or hw <= 0 or c % groups or c % 8 or c > _MAX_C or not 0 < groups <= _MAX_GROUPS:
        raise ValueError(f"K3 takes C % 8 == 0, C <= {_MAX_C}, C % G == 0, G <= {_MAX_GROUPS}; "
                         f"got N={n} HW={hw} C={c} G={groups}")
    slab = slab_groups(hw, c, groups, 2 if dtype == torch.bfloat16 else 4)
    if slab:
        k = next((k for k in slab if n * groups // k <= sms), slab[-1])
        return GnPlan("slab", k, 1)
    return GnPlan("split", max(1, min(sms // n, hw)), 2)


def slab_groups(hw: int, c: int, groups: int, esize: int) -> list:
    """The group counts k a block of the slab form can hold at this shape,
    fewest first: k divides the groups, its k C/G channels are a multiple of
    8 and at most 256, and its HW pixels, in TMA boxes of up to 256 pixels
    (at most 32 of them, each 128-byte aligned), fit a block's shared
    memory."""
    cg = c // groups
    box = min(hw, 256)
    nbox = -(-hw // box)
    return [k for k in range(1, groups + 1)
            if groups % k == 0 and k * cg % 8 == 0 and k * cg <= _SLAB_MAX_C
            and nbox <= _SLAB_MAX_BOXES
            and nbox * -(-box * k * cg * esize // 128) * 128 <= _TILE_BYTES]


def cat_slab_groups(hw: int, ca: int, cb: int, groups: int, esize: int) -> list:
    """The group counts k a block of the two-source slab form can hold, the
    groups of the virtual row [a | b] (Ca + Cb channels), fewest first:
    :func:`slab_groups`'s k whose boxes also fit where a block straddles
    the boundary (Ca % (k C/G) != 0: that block takes each box as a box of
    a and a box of b, each 128-byte aligned; ``csrc/groupnorm_sm90.cuh``
    cat_box_bytes)."""
    c = ca + cb
    box = min(hw, 256)
    return [k for k in slab_groups(hw, c, groups, esize)
            if -(-hw // box) * cat_box_bytes(box, ca, k * (c // groups), esize) <= _TILE_BYTES]


def cat_box_bytes(box_px: int, ca: int, kc: int, esize: int) -> int:
    """Shared-memory bytes of one TMA box of ``box_px`` pixels at the widest
    block of the two-source slab form, ``kc`` channels a block with the
    a/b boundary at ``ca``: the block that straddles it (Ca % kc != 0) lays
    the box out as two 128-byte aligned regions, Ca % kc channels of a and
    the rest of b (``csrc/groupnorm_sm90.cuh`` cat_box_bytes)."""
    def box_bytes(ch):
        return -(-box_px * ch * esize // 128) * 128

    ka = ca % kc
    return box_bytes(ka) + box_bytes(kc - ka) if ka else box_bytes(kc)


def gn_splits(n: int, hw: int, c: int, num_groups: int, sms: int) -> int:
    """HW splits per (sample, group) of the replaced body
    (:func:`group_norm_prior`). 1 (the fused kernel) where the
    n * num_groups blocks keep at least half the SMs busy (the VAE planes
    at batch 4, where splitting measured slower) or the slices are small
    (the UNet planes but level 0 at UNet batch 2); else enough splits for
    two blocks per SM, each with at least 32 elements a thread (4-9 on the
    VAE planes at batch 1)."""
    blocks = n * num_groups
    if 2 * blocks > sms:
        return 1
    most = hw * (c // num_groups) // _GN_MIN_SPLIT_ELEMS
    return max(1, min(-(-2 * sms // blocks), most, hw))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_PARTS = {}  # (device index, stream) -> the split form's partials buffer


def _split_parts(rows: int, device, stream: int):
    """A [>= rows, 2] f32 buffer for the split form's per-(sample, tile,
    group) partials: one a (device, stream), which every split call on that
    stream reuses (its kernels run in stream order), grown when a call needs
    more; a call then allocates nothing but y (the allocation cost 3.5-4.9
    us of host time a call on the H100, PERF.md section 5)."""
    key = (device.index, stream)
    buf = _PARTS.get(key)
    if buf is None or buf.shape[0] < rows:
        buf = torch.empty((rows, 2), dtype=torch.float32, device=device)
        _PARTS[key] = buf
    return buf


def _nhwc_args(x, gamma, beta, c: Optional[int] = None):
    """x contiguous and 16-byte aligned; gamma and beta [C] (x's channels,
    or ``c``) contiguous in x's dtype."""
    c = x.shape[-1] if c is None else c
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError("gamma and beta must have shape [C]")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, gamma.to(x.dtype).contiguous(), beta.to(x.dtype).contiguous()


def group_norm_nhwc(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = False, plan: Optional[GnPlan] = None):
    """K3 wrapper. CPU tensors run :func:`group_norm_plain`; CUDA tensors
    (f32 or bf16, NHWC, C % 8 == 0, C <= 4096, G <= 256) launch
    ``csrc/groupnorm_sm90.cu`` (``_group_norm_sm90``) in the form
    :func:`group_norm_plan` picks (``plan`` runs another: the tests and
    ``tools/gn_plans.py``) or raise. Under grad the backward is the VJP of
    :func:`group_norm_plain` on the saved x, gamma and beta (the JAX rule's
    VJP of ``_gn_xla``). ``group_norm_nhwc.launches`` adds the kernels the
    library reports it launched, ``.planned`` the plan's count and
    ``.calls`` one a call."""
    if x.ndim != 4:
        raise ValueError(f"group norm expects NHWC, got shape {tuple(x.shape)}")
    if x.shape[-1] % num_groups:
        raise ValueError(f"channels {x.shape[-1]} not divisible by {num_groups} groups")
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, num_groups, eps, silu)
    if x.dtype not in _PRIOR_FNS:
        raise TypeError(f"K3 supports float32 and bfloat16, got {x.dtype}")
    return _build.kernel_with_plain_vjp(functools.partial(_group_norm_sm90, plan=plan),
                                        group_norm_plain, (num_groups, eps, silu),
                                        x, gamma, beta)


def _group_norm_sm90(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = False, plan: Optional[GnPlan] = None):
    """K3's Hopper body on CUDA tensors that :func:`group_norm_nhwc` has
    checked: the form ``plan`` (default :func:`group_norm_plan`'s) names.
    Its launches count into ``group_norm_nhwc``'s counters."""
    _build.refuse_grad("group_norm (K3)", x, gamma, beta)
    n, h, w, c = x.shape
    x, gamma, beta = _nhwc_args(x, gamma, beta)
    if plan is None:
        dev = x.device.index
        plan = group_norm_plan(n, h * w, c, num_groups, x.dtype, _sm_count(dev))
    y = torch.empty_like(x)
    stream = _build.stream_ptr(x.device)
    parts = None
    if plan.form == "split":
        parts = _split_parts(n * plan.tiles * num_groups, x.device, stream)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_group_norm_sm90(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if parts is None else parts.data_ptr(), int(x.dtype == torch.float32),
        n, h * w, c, num_groups, float(eps), int(silu), _FORMS[plan.form], plan.tiles,
        ctypes.addressof(launched), stream)
    group_norm_nhwc.launches += launched.value
    group_norm_nhwc.planned += plan.launches
    group_norm_nhwc.calls += 1
    _build.check(err, "group_norm (K3)")
    return y


group_norm_nhwc.launches = 0
group_norm_nhwc.planned = 0
group_norm_nhwc.calls = 0


def group_norm_prior(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                     silu: bool = False):
    """The body K3 ran until the Hopper redesign (``csrc/groupnorm.cu``,
    ``groupnorm.cuh``: one block a (sample, group) slice, or the
    :func:`gn_splits` statistics and apply kernels), kept so that the two
    can be timed and checked side by side; no layer calls it. CPU tensors
    run :func:`group_norm_plain`. ``group_norm_prior.launches`` counts its
    launches."""
    if x.ndim != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"group norm expects NHWC with C % groups == 0, got {tuple(x.shape)}")
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, num_groups, eps, silu)
    n, h, w, c = x.shape
    if x.dtype not in _PRIOR_FNS:
        raise TypeError(f"K3 supports float32 and bfloat16, got {x.dtype}")
    _build.refuse_grad("group_norm (K3, replaced body)", x, gamma, beta)
    x, gamma, beta = _nhwc_args(x, gamma, beta)
    y = torch.empty_like(x)
    splits = gn_splits(n, h * w, c, num_groups, _sm_count(x.device.index))
    part = None  # per-split partial statistics, [n * num_groups * splits, 2] f32
    if splits > 1:
        part = torch.empty((n * num_groups * splits, 2), dtype=torch.float32, device=x.device)
    err = getattr(_build.kernel_library(), _PRIOR_FNS[x.dtype])(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(),
        n, h * w, c, num_groups, splits, float(eps), int(silu), _build.stream_ptr(x.device))
    _build.check(err, "group_norm (K3, replaced body)")
    group_norm_prior.launches += 1 if splits == 1 else 2
    return y


group_norm_prior.launches = 0


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over NHWC (torch GroupNorm32 semantics)."""
    return group_norm_nhwc(x, gamma, beta, num_groups, eps, silu=False)


def group_norm_silu(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """Fused GroupNorm + SiLU (the ResBlock in_layers / out_layers prefix)."""
    return group_norm_nhwc(x, gamma, beta, num_groups, eps, silu=True)


def prefers_mm_stats(x) -> bool:
    """Whether the JAX package's GroupNorm dispatch takes its matmul-stats
    path for ``x`` under its default "auto" (``_use_xla_mm(x, False)``):
    <= 16-bit inputs. The UNet's gate for the two-source form reads it, as
    the JAX package's does."""
    return x.element_size() <= 2


def group_norm_silu_cat_plain(a, b, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                              silu: bool = True):
    """Plain PyTorch twin of :func:`group_norm_silu_cat`, the JAX function's
    arithmetic: per-channel f32 sums and sums of squares of each input (one
    pass, whatever the dtype: f32 inputs too, unlike
    :func:`group_norm_plain`), summed into groups over the virtual channel
    extent (a group may straddle the a/b boundary), var = max(E[x^2] -
    mean^2, 0); each half normalized with its channels' statistics, gamma
    and beta, rounded once to its dtype. Returns ``(ya, yb)``."""
    n, h, w, ca = a.shape
    cb = b.shape[-1]
    c = ca + cb
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    af = a.float().reshape(n, h * w, ca)
    bf = b.float().reshape(n, h * w, cb)
    s1 = torch.cat([af.sum(dim=1), bf.sum(dim=1)], dim=-1)  # [N, C]
    s2 = torch.cat([af.square().sum(dim=1), bf.square().sum(dim=1)], dim=-1)
    cg = c // num_groups
    count = float(h * w * cg)
    mean = s1.reshape(n, num_groups, cg).sum(dim=-1) / count
    ex2 = s2.reshape(n, num_groups, cg).sum(dim=-1) / count
    rstd = torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, None, :]  # [N, 1, 1, C]
    rstd_c = rstd.repeat_interleave(cg, dim=-1)[:, None, None, :]

    def norm(x, lo, hi):
        y = (x.float() - mean_c[..., lo:hi]) * rstd_c[..., lo:hi]
        y = y * gamma[lo:hi].float() + beta[lo:hi].float()
        if silu:
            y = y * torch.sigmoid(y)
        return y.to(x.dtype)

    return norm(a, 0, ca), norm(b, ca, c)


@functools.lru_cache(maxsize=1024)
def group_norm_cat_plan(n: int, hw: int, ca: int, cb: int, groups: int, sms: int,
                        dtype=torch.bfloat16) -> GnPlan:
    """K3's two-source form for ``n`` samples of ``hw`` pixels x ``ca`` +
    ``cb`` channels in ``groups`` groups (``dtype`` float32 or bfloat16) on
    a card of ``sms`` SMs, by :func:`group_norm_plan`'s rule over the
    virtual row: slab (one launch) where whole groups of a sample fit a
    block (:func:`cat_slab_groups`), the fewest groups a block whose blocks
    run in one wave; else split, the statistics and apply launches over
    ``sms // n`` tiles a sample. Raises ValueError where K3 cannot take the
    shape (Ca or Cb not a multiple of 8, C > 4096, C % G, G > 256)."""
    c = ca + cb
    if (n <= 0 or hw <= 0 or ca <= 0 or cb <= 0 or ca % 8 or cb % 8 or c > _MAX_C
            or c % groups or not 0 < groups <= _MAX_GROUPS):
        raise ValueError(f"K3's two-source form takes Ca % 8 == Cb % 8 == 0, Ca + Cb <= "
                         f"{_MAX_C}, C % G == 0, G <= {_MAX_GROUPS}; got N={n} HW={hw} Ca={ca} "
                         f"Cb={cb} G={groups}")
    slab = cat_slab_groups(hw, ca, cb, groups, 2 if dtype == torch.bfloat16 else 4)
    if slab:
        return GnPlan("slab", next((k for k in slab if n * groups // k <= sms), slab[-1]), 1)
    return GnPlan("split", max(1, min(sms // n, hw)), 2)


def group_norm_silu_cat(a, b, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                        silu: bool = True, plan: Optional[GnPlan] = None):
    """GroupNorm(+SiLU) of ``concat([a, b], -1)`` without materializing the
    concat: returns ``(ya, yb)``, the normalized halves (the JAX package's
    ``group_norm_silu_cat``). ``a`` [N, H, W, Ca] and ``b`` [N, H, W, Cb]
    of one dtype; ``gamma``, ``beta`` [Ca + Cb]. CPU tensors run
    :func:`group_norm_silu_cat_plain`; CUDA tensors (f32 or bf16) launch K3's
    two-source form (``csrc/groupnorm_sm90.cu``, ``_group_norm_cat_sm90``)
    in the form :func:`group_norm_cat_plan` picks (``plan`` runs another:
    the tests, and phase 1's replaced body, the split form at every shape), or
    raise: a shape K3 cannot take raises ValueError, with no concat behind
    the caller's back. Under grad the backward is the VJP of the plain twin
    on the saved inputs. Counts: ``group_norm_silu_cat.launches`` and
    ``.calls`` the form's own, ``group_norm_cat_slab_count.launches`` its
    slab launches; its launches, plans and calls also count into
    ``group_norm_nhwc``'s (every K3 kernel)."""
    if a.ndim != 4 or b.ndim != 4 or a.shape[:3] != b.shape[:3]:
        raise ValueError(f"group_norm_silu_cat expects NHWC a and b over one grid, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    c = a.shape[-1] + b.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if a.dtype != b.dtype:
        raise TypeError(f"group_norm_silu_cat takes a and b of one dtype, got {a.dtype} and "
                        f"{b.dtype}")
    if not a.is_cuda:
        return group_norm_silu_cat_plain(a, b, gamma, beta, num_groups, eps, silu)
    if a.dtype not in _PRIOR_FNS:
        raise TypeError(f"K3 supports float32 and bfloat16, got {a.dtype}")
    return _build.kernel_with_plain_vjp(functools.partial(_group_norm_cat_sm90, plan=plan),
                                        group_norm_silu_cat_plain, (num_groups, eps, silu),
                                        a, b, gamma, beta)


def _group_norm_cat_sm90(a, b, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                         silu: bool = True, plan: Optional[GnPlan] = None):
    """K3's two-source form on CUDA tensors that :func:`group_norm_silu_cat`
    has checked, in the form ``plan`` (default :func:`group_norm_cat_plan`'s)
    names."""
    _build.refuse_grad("group_norm_silu_cat (K3)", a, b, gamma, beta)
    n, h, w, ca = a.shape
    cb = b.shape[-1]
    if plan is None:
        plan = group_norm_cat_plan(n, h * w, ca, cb, num_groups, _sm_count(a.device.index),
                                   a.dtype)
    a, gamma, beta = _nhwc_args(a, gamma, beta, ca + cb)
    b = b.contiguous()
    if b.data_ptr() % 16:
        b = b.clone()
    ya, yb = torch.empty_like(a), torch.empty_like(b)
    stream = _build.stream_ptr(a.device)
    parts = (_split_parts(n * plan.tiles * num_groups, a.device, stream)
             if plan.form == "split" else None)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_group_norm_cat_sm90(
        a.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ya.data_ptr(),
        yb.data_ptr(), None if parts is None else parts.data_ptr(),
        int(a.dtype == torch.float32), n, h * w, ca, cb, num_groups, float(eps), int(silu),
        _FORMS[plan.form], plan.tiles, ctypes.addressof(launched), stream)
    for fn in (group_norm_silu_cat, group_norm_nhwc):
        fn.launches += launched.value
        fn.calls += 1
    if plan.form == "slab":
        group_norm_cat_slab_count.launches += launched.value
    group_norm_nhwc.planned += plan.launches
    _build.check(err, "group_norm_silu_cat (K3)")
    return ya, yb


group_norm_silu_cat.launches = 0
group_norm_silu_cat.calls = 0
# the two-source form's slab launches (also in group_norm_silu_cat.launches)
group_norm_cat_slab_count = LaunchCount()
