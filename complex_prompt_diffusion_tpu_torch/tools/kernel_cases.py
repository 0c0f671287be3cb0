"""The kernel cases that ``chip_smoke.py`` (phase 1) and ``tree_ab`` run.

Each case is one kernel call at a shape its paths use (for the Winograd
probe, which no path uses: at shapes K4's cases have), with its plain
PyTorch twin, the one PyTorch call that computes the same function where
there is one (timed beside the kernel as a yardstick, never used by the
port), and the flops and bytes the function needs, from which
:meth:`Case.bound` gives the least time an H100 could take.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["Case", "kernel_cases", "host_us", "PEAK_FLOPS", "HBM_BYTES_PER_S", "B1_UNET_CONVS",
           "B1_UNET_CONV_COUNTS", "GEGLU_ROWS", "GEGLU_B4_CALLS", "GEGLU_B1_ROWS", "GN_UNET_PLANES",
           "GN_B4_CALLS", "GN_DECODE_PLANES"]

_PKG = "complex_prompt_diffusion_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, f32
# outside the tensor cores (the FMA bodies), and f32 products done as three
# TF32 tensor-core products (495e12 / 3: K1's 3xTF32 body); HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12

# (plane side, C, Co) of every distinct 3x3 conv of a batch-1 UNet call (UNet
# batch 2) and how many of the 22 convs a call has that shape
B1_UNET_CONVS = ((32, 320, 640), (32, 640, 640), (32, 960, 640), (32, 1280, 640),
                 (32, 1920, 640), (32, 1280, 1280), (16, 640, 1280), (16, 1280, 1280),
                 (16, 1920, 1280), (16, 2560, 1280))
B1_UNET_CONV_COUNTS = (1, 6, 1, 1, 1, 1, 1, 7, 1, 2)


# (M, C) of K2's calls: the four levels of a b4 CFG step (UNet batch 8; 5,
# 5, 5 and 1 calls a step), then the b1 step's (UNet batch 2) other three
GEGLU_ROWS = ((32768, 320), (8192, 640), (2048, 1280), (512, 1280),
              (8192, 320), (2048, 640), (128, 1280))
GEGLU_B4_CALLS = (5, 5, 5, 1)  # calls a b4 step of each of the first four rows
# the b1 step's four (UNet batch 2), GEGLU_B4_CALLS calls each
GEGLU_B1_ROWS = ((8192, 320), (2048, 640), (512, 1280), (128, 1280))

# (plane side, C) of every distinct GroupNorm of a UNet call (models/unet.py:
# the ResBlocks' in_norm and out_norm, the transformers' norm, the out norm;
# the up path's in_norm takes the input concatenated with its skip, C = 960
# .. 2560), and how many of the 61 calls of a step have that shape: the b4
# step at UNet batch 8 and the b1 step at UNet batch 2 alike
GN_UNET_PLANES = ((64, 320), (64, 640), (64, 960), (32, 320), (32, 640), (32, 960), (32, 1280),
                  (32, 1920), (16, 640), (16, 1280), (16, 1920), (16, 2560), (8, 1280),
                  (8, 2560))
GN_B4_CALLS = (13, 2, 1, 1, 11, 1, 1, 1, 1, 11, 1, 2, 12, 3)
# (plane side, C) of the VAE decoder's planes: the mid-block and the four up
# levels (30 GroupNorms a decode, over these shapes)
GN_DECODE_PLANES = ((64, 512), (128, 512), (256, 256), (512, 256), (512, 128))


class Case(NamedTuple):
    kernel: str  # the name in ops.KERNEL_WRAPPERS
    label: str
    run: Callable  # the kernel's wrapper on this case's tensors
    plain: Callable  # its plain PyTorch twin
    library: Optional[Callable]  # one PyTorch call computing the same, or None
    dtype: str
    flops: float
    nbytes: float  # each input read once, each output written once
    # the body this kernel replaced, where it is still built (the mma.sync
    # bodies of K1 and K4, K1's f32 FMA body, K3's first body, K5's, K6's,
    # K7's, K8's and K9's first bodies), timed beside it; None where there is
    # none
    prior: Optional[Callable] = None
    # the PEAK_FLOPS entry of the units that do the work, where it is not
    # the dtype's
    rate: Optional[str] = None

    def bound(self):
        """(least ms the card could take, "bytes" or "operations")."""
        t_ops = self.flops / PEAK_FLOPS[self.rate or self.dtype] * 1e3
        t_bytes = self.nbytes / HBM_BYTES_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases(dev, kernels=None) -> list:
    """The cases of the kernels named in ``kernels`` (all by default), with
    tensors made on ``dev`` from a seeded generator."""
    # ops/__init__ re-exports the function ``attention``, so the modules are
    # imported by name
    A = importlib.import_module(f"{_PKG}.ops.attention")
    C = importlib.import_module(f"{_PKG}.ops.conv")
    G = importlib.import_module(f"{_PKG}.ops.groupnorm")
    F2 = importlib.import_module(f"{_PKG}.ops.mlp")
    W = importlib.import_module(f"{_PKG}.ops.probes.winograd")
    want = set(kernels) if kernels else {"attention", "attention_sm90",
                                         "attention_f32_sm90", "attention_bf16_wide_sm90",
                                         "geglu_ff", "geglu_ff_f32_sm90",
                                         "group_norm", "conv3x3", "conv3x3_sm90",
                                         "conv3x3_f32_sm90",
                                         "attention_cm", "winograd", "probe_attention",
                                         "probe_groupnorm", "probe_copy"}

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def uniform(*shape, bound, dtype):
        t = torch.empty(shape, device=dev).uniform_(-bound, bound, generator=gen)
        return t.to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = []

    def sdpa(q, k, v, heads):
        def split(t):
            b, s, inner = t.shape
            return t.view(b, s, heads, inner // heads).transpose(1, 2)

        return lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))

    def attn_case(label, q, k, v, heads, dt, kernel="attention", prior=None, rate=None):
        b, sq, inner = q.shape
        skv = k.shape[1]
        nbytes = (2 * b * sq + 2 * b * skv) * inner * q.element_size()
        cases.append(Case(kernel, label,
                          lambda: A.flash_attention(q, k, v, heads),
                          lambda: A.attention_plain(q, k, v, heads), sdpa(q, k, v, heads), dt,
                          4.0 * b * sq * skv * inner, nbytes, prior, rate))

    if "attention_sm90" in want:
        # UNet self-attention at UNet batch 8 (q/k/v are views of one fused
        # qkv projection, as in the UNet), through K1's route (the sm90 body
        # in this tree; tree_ab runs the same case on a parent's route), with
        # the mma.sync body beside it: the full mode of K7's replaced loop,
        # which is that body's code (a parent tree without it: K7's full
        # mode, which was that loop there)
        PA = importlib.import_module(f"{_PKG}.ops.probes.attention")
        mma = getattr(PA, "attention_probe_prior", PA.attention_probe)
        for s_, c in ((4096, 320), (1024, 640), (256, 1280)):
            qkv = randn(8, s_, 3 * c, dtype=bf16)
            q, k, v = qkv.chunk(3, dim=-1)
            d = c // 8
            attn_case(f"bf16 B8 S{s_} H8 d{d}", q, k, v, 8, "bfloat16", "attention_sm90",
                      lambda q=q, k=k, v=v, d=d: mma(q, k, v, 8, d**-0.5))
    if "attention_f32_sm90" in want:
        # the f32 VAE mid-block of the exact b4 decode, through K1's route
        # (the 3xTF32 body in this tree, bound at the TF32 tensor cores' rate
        # for three products), with the FMA body beside it (a parent tree
        # may lack its wrapper)
        fma = getattr(A, "attention_f32_fma", None)
        q, k, v = (randn(4, 4096, 512, dtype=f32) for _ in range(3))
        attn_case("f32 B4 S4096 H1 d512", q, k, v, 1, "float32", "attention_f32_sm90",
                  (lambda q=q, k=k, v=v: fma(q, k, v, 1)) if fma else None, "tf32x3")
    if "attention_bf16_wide_sm90" in want:
        # the bf16 mid-block of the batch-1 and batch-4 bf16 decode (and
        # encode), through K1's route (the wgmma body in this tree), with the
        # mma.sync body beside it (a parent tree may lack its wrapper)
        wide = getattr(A, "attention_bf16_wide_mma", None)
        for b in (1, 4):
            q, k, v = (randn(b, 4096, 512, dtype=bf16) for _ in range(3))
            attn_case(f"bf16 B{b} S4096 H1 d512", q, k, v, 1, "bfloat16",
                      "attention_bf16_wide_sm90",
                      (lambda q=q, k=k, v=v: wide(q, k, v, 1)) if wide else None)
    if "attention" in want:
        # K1 f32 with d <= 160 (the fused 3xTF32 body in this tree, bound at
        # the rate of three TF32 products): an f32 UNet's self-attention at
        # UNet batch 2, level 1, then levels 0 and 2; the FMA body it replaced
        # beside each (a parent tree may lack its wrapper)
        fma = getattr(A, "attention_f32_fma", None)
        for s_, c in ((1024, 640), (4096, 320), (256, 1280)):
            q, k, v = (randn(2, s_, c, dtype=f32) for _ in range(3))
            attn_case(f"f32 B2 S{s_} H8 d{c // 8}", q, k, v, 8, "float32", "attention",
                      (lambda q=q, k=k, v=v: fma(q, k, v, 8)) if fma else None, "tf32x3")
    # every UNet level at UNet batch 8 (the b4 render), then the rows of UNet
    # batch 2 (the b1 render) that batch 8 lacks: bf16 on K2's bf16 body;
    # in f32 (an f32 UNet's) on its 3xTF32 body, bound at the rate of three
    # TF32 products. No single PyTorch call computes the GEGLU FF, so it has
    # no library time
    ff_dtypes = [(bf16, "geglu_ff")] if "geglu_ff" in want else []
    if "geglu_ff_f32_sm90" in want:
        ff_dtypes.append((f32, "geglu_ff_f32_sm90"))
    for dt, kernel in ff_dtypes:
        for m, c in GEGLU_ROWS:
            x = randn(m, c, dtype=dt)
            w1 = uniform(c, 8 * c, bound=c ** -0.5, dtype=dt)
            b1 = uniform(8 * c, bound=c ** -0.5, dtype=dt)
            w2 = uniform(4 * c, c, bound=(4 * c) ** -0.5, dtype=dt)
            b2 = uniform(c, bound=(4 * c) ** -0.5, dtype=dt)
            a = (x, w1, b1, w2, b2)
            cases.append(Case(kernel, f"{'bf16' if dt == bf16 else 'f32'} M{m} C{c} H4 {4 * c}",
                              lambda a=a: F2.geglu_ff(*a), lambda a=a: F2.geglu_ff_plain(*a),
                              None, "bfloat16" if dt == bf16 else "float32", 24.0 * m * c * c,
                              x.element_size() * (2 * m * c + 12 * c * c + 9 * c),
                              rate="tf32x3" if dt == f32 else None))
    if "group_norm" in want:
        # every GroupNorm shape of a UNet call at UNet batch 8 (the b4 step)
        # and 2 (the b1 step), bf16, eps 1e-5; the f32 VAE-decode planes and
        # the bf16 planes of the b4 and the b1 bf16 decode (eps 1e-6). The
        # replaced body beside each (a parent tree may lack its wrapper)
        gn_prior = getattr(G, "group_norm_prior", None)
        shapes = [((b, side, side, c), bf16, 1e-5) for b in (8, 2) for side, c in GN_UNET_PLANES]
        for b, dt in ((4, f32), (4, bf16), (1, bf16)):
            shapes += [((b, side, side, c), dt, 1e-6) for side, c in GN_DECODE_PLANES]
        for shape, dt, eps in shapes:
            x = randn(*shape, dtype=dt, scale=2.0) + 0.5
            gamma = randn(shape[-1], dtype=dt, scale=0.5) + 1.0
            beta = randn(shape[-1], dtype=dt, scale=0.5)
            a = (x, gamma, beta, 32, eps, True)
            cases.append(Case(
                "group_norm",
                f"{'bf16' if dt == bf16 else 'f32'} {'x'.join(map(str, shape))} silu",
                lambda a=a: G.group_norm_nhwc(*a), lambda a=a: G.group_norm_plain(*a),
                lambda a=a: F.silu(F.group_norm(a[0].permute(0, 3, 1, 2), 32, a[1], a[2],
                                                a[4])),
                "bfloat16" if dt == bf16 else "float32", 10.0 * x.numel(),
                (2 * x.numel() + 2 * shape[-1]) * x.element_size(),
                (lambda a=a: gn_prior(*a)) if gn_prior else None))
    shapes = []
    if "conv3x3_sm90" in want:
        # every distinct 3x3 conv of the batch-1 render (UNet batch 2), through
        # K4's route (the sm90 body in this tree), with the mma.sync body beside it
        shapes += [("conv3x3_sm90", 2, hw, c, co, bf16) for hw, c, co in B1_UNET_CONVS]
    if "conv3x3_f32_sm90" in want:
        # the same convs of an f32 UNet, and the exact f32 decode's conv on a
        # 32^2 plane (a 32x32 latent), through K4's route (the 3xTF32 body in
        # this tree, bound at the rate of three TF32 products), with the FMA
        # body it replaced beside each
        shapes += [("conv3x3_f32_sm90", 2, hw, c, co, f32) for hw, c, co in B1_UNET_CONVS]
        shapes += [("conv3x3_f32_sm90", 1, 32, 512, 512, f32)]
    if "conv3x3" in want:
        # the FMA body's own shapes: an f32 UNet's conv_in and out conv on a
        # 16^2 latent (phase 11's UNet eval)
        shapes += [("conv3x3", 2, 16, 4, 320, f32), ("conv3x3", 2, 16, 320, 4, f32)]
    generic = getattr(C, "conv3x3_generic", None)  # a parent tree may lack it
    for kernel, b, hw, c, co, dt in shapes:
        x = randn(b, hw, hw, c, dtype=dt)
        w = uniform(co, c, 3, 3, bound=(9 * c) ** -0.5, dtype=dt).contiguous(
            memory_format=torch.channels_last)
        bias = uniform(co, bound=0.1, dtype=dt)
        a = (x, w, bias)
        m = b * hw * hw
        cases.append(Case(
            kernel, f"{'bf16' if dt == bf16 else 'f32'} B{b} {hw}x{hw} {c}->{co}",
            lambda a=a: C.conv3x3(*a), lambda a=a: C.conv3x3_plain(*a),
            lambda a=a: F.conv2d(a[0].permute(0, 3, 1, 2), a[1], a[2], padding=1),
            "bfloat16" if dt == bf16 else "float32", 2.0 * m * co * 9 * c,
            x.element_size() * (m * c + 9 * c * co + m * co + co),
            (lambda a=a: generic(*a)) if kernel != "conv3x3" and generic else None,
            "tf32x3" if kernel == "conv3x3_f32_sm90" else None))
    if "attention_cm" in want:
        # K5, hdbs mode: the cm block's [H, D, B, S] slices of one [3C, B, S]
        # projection at the levels the gate admits (UNet batch 8, and 2 for
        # batch 1). The library call is SDPA on canonical copies; the prior
        # is the body the Hopper ones replaced (a parent tree may lack it).
        # f32 is bound at the rate of three TF32 products (its Hopper body's).
        cm_prior = getattr(A, "attention_dmajor_prior", None)

        def sdpa4(q, k, v, k_canonical):
            qc, vc = (t.transpose(-1, -2).contiguous() for t in (q, v))
            kc = k.contiguous() if k_canonical else k.transpose(-1, -2).contiguous()
            return lambda: F.scaled_dot_product_attention(qc, kc, vc)

        def cm_case(label, q, k, v, k_canonical, dt, **kw):
            b, h, d, sq = q.shape
            skv = v.shape[3]
            scale = d**-0.5
            cases.append(Case(
                "attention_cm", label,
                lambda: A.attention_dmajor(q, k, v, scale, k_canonical=k_canonical, **kw),
                lambda: A.attention_dmajor_plain(q, k, v, scale, k_canonical),
                sdpa4(q, k, v, k_canonical), dt, 4.0 * b * h * sq * skv * d,
                2.0 * b * h * (sq + skv) * d * q.element_size(),
                ((lambda: cm_prior(q, k, v, scale, k_canonical=k_canonical, **kw)) if cm_prior
                 else None),
                "tf32x3" if dt == "float32" else None))

        def hdbs(b, s_, c, dt):
            qkv = randn(3, 8, c // 8, b, s_, dtype=dt)
            return tuple(qkv[i].permute(2, 0, 1, 3) for i in range(3))

        def kcanon(b, sq, skv, c, dt):
            # q and v as the route's d-major copies, k a view of the fused
            # [B, S, 3C] projection
            d = c // 8
            q, v = (randn(b, 8, d, s_, dtype=dt) for s_ in (sq, skv))
            k = randn(b, skv, 3 * c, dtype=dt)[..., c:2 * c]
            return q, k.reshape(b, skv, 8, d).permute(0, 2, 1, 3), v

        for b in (8, 2):
            for s_, c in ((1024, 640), (256, 1280)):
                cm_case(f"hdbs bf16 B{b} S{s_} H8 d{c // 8}", *hdbs(b, s_, c, bf16), False,
                        "bfloat16", out_hdbs=True)
        cm_case("hdbs f32 B2 S256 H8 d160", *hdbs(2, 256, 1280, f32), False, "float32",
                out_hdbs=True)
        # kcanon mode: every self-attention level (UNet batch 8), and at UNet
        # batch 2 (phase 8's b1 render) every level too
        for b, s_, c in ((8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (2, 4096, 320),
                         (2, 1024, 640), (2, 256, 1280)):
            cm_case(f"kcanon bf16 B{b} S{s_} H8 d{c // 8}", *kcanon(b, s_, s_, c, bf16), True,
                    "bfloat16")
        cm_case("kcanon f32 B2 S1024 H8 d80", *kcanon(2, 1024, 1024, 640, f32), True, "float32")
        cm_case("kcanon bf16 B2 Sq1000 Skv1336 H8 d40 (ragged)",
                *kcanon(2, 1000, 1336, 320, bf16), True, "bfloat16")
    if "winograd" in want:
        # K6 at the batch-1 render's square convs (UNet batch 2), two with C
        # != Co, one batch-8 shape and an f32 one; U is made once, outside
        # the timed call, as a caller with fixed weights would. The library
        # call is the direct conv (cuDNN); K4's cases above time the same
        # shapes. Each case runs the Hopper body of its dtype (the f32 one
        # bound at the rate of three TF32 products) with the first body
        # beside it. (A parent tree may lack the Hopper bodies and their
        # wrappers; the labels are the parent's, so that tree_ab compares the
        # same cases.)
        wino_prior = getattr(W, "wino3x3_prior", None)
        k6_body = getattr(W, "k6_body", None)
        shapes = [(2, 32, 640, 640, bf16), (2, 32, 1280, 1280, bf16), (2, 16, 1280, 1280, bf16),
                  (8, 32, 640, 640, bf16), (2, 32, 960, 640, bf16), (2, 16, 2560, 1280, bf16),
                  (1, 32, 512, 512, f32)]
        for b, hw, c, co, dt in shapes:
            x = randn(b, hw, hw, c, dtype=dt)
            k = uniform(3, 3, c, co, bound=(9 * c) ** -0.5, dtype=dt)
            bias = uniform(co, bound=0.1, dtype=dt)
            u = W.winograd_weights(k).to(dt)
            w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            a = (x, k, bias, u)
            m = b * hw * hw
            f32_sm90 = k6_body is not None and k6_body(dt, c, co) == "f32_sm90"
            # a parent tree without k6_body routes by its sm90_takes (bf16 only)
            sm90 = wino_prior is not None and (k6_body(dt, c, co) != "prior" if k6_body
                                               else W.sm90_takes(dt, c, co))
            cases.append(Case(
                "winograd", f"{'bf16' if dt == bf16 else 'f32'} B{b} {hw}x{hw} {c}->{co}",
                lambda a=a: W.wino3x3(*a), lambda a=a: W.wino3x3_plain(a[0], a[3], a[2]),
                lambda x=x, w=w_oihw, bias=bias: F.conv2d(x.permute(0, 3, 1, 2), w, bias,
                                                          padding=1),
                "bfloat16" if dt == bf16 else "float32", 2.0 * m * co * 4 * c,
                x.element_size() * (m * c + 16 * c * co + m * co) + 4 * co,
                (lambda a=a: wino_prior(*a[:3], u=a[3])) if sm90 else None,
                "tf32x3" if f32_sm90 else None))
    # the probes (imported here: a source tree without them runs the cases
    # above); each at a shape of its TPU script, the tools/probe_*.py rows
    # time every variant
    if "probe_attention" in want:
        PA = importlib.import_module(f"{_PKG}.ops.probes.attention")
        # the replaced loops beside K7 (a parent tree may lack them), with the
        # same flags at their 64-key tiles unless the case asks for 128
        probe_prior = getattr(PA, "attention_probe_prior", None)
        # the scores mode (perf_attn10 A, and F on K1's fused f32 body, bound
        # at the rate of three TF32 products) has no library call
        for s_, c, kw, lib, dt in ((4096, 320, dict(denom="ones"), True, bf16),
                                   (1024, 640, dict(kv_tile=128), True, bf16),
                                   (4096, 320, dict(mode="scores"), False, bf16),
                                   (4096, 320, dict(mode="scores"), False, f32)):
            q, k, v = (randn(8, s_, c, dtype=dt) for _ in range(3))
            flops = 4.0 * 8 * s_ * s_ * c / (1 if lib else 2)
            tag = " ".join(f"{key}={val}" for key, val in kw.items())
            name = "bf16" if dt == bf16 else "f32"
            cases.append(Case(
                "probe_attention", f"{name} B8 S{s_} H8 d{c // 8} {tag}",
                lambda q=q, k=k, v=v, kw=kw, d=c // 8: PA.attention_probe(q, k, v, 8, d**-0.5,
                                                                          **kw),
                lambda q=q, k=k, v=v, kw=kw, d=c // 8: PA.attention_probe_plain(
                    q, k, v, 8, d**-0.5, **kw),
                sdpa(q, k, v, 8) if lib else None, "bfloat16" if dt == bf16 else "float32",
                flops, 4.0 * 8 * s_ * c * q.element_size(),
                (lambda q=q, k=k, v=v, kw=kw, d=c // 8: probe_prior(q, k, v, 8, d**-0.5, **kw))
                if probe_prior else None, "tf32x3" if dt == f32 else None))
    if "probe_groupnorm" in want:
        # K8 with its replaced body beside it (a parent tree may lack it)
        PG = importlib.import_module(f"{_PKG}.ops.probes.groupnorm")
        k8_prior = getattr(PG, "group_norm_probe_prior", None)
        for shape, kw in (((8, 64, 64, 320), dict(mma=True)), ((8, 64, 64, 320), dict(splits=16)),
                          ((8, 32, 32, 1280), dict(mode="bf16sig"))):
            x = randn(*shape, dtype=bf16, scale=2.0) + 0.5
            gamma = randn(shape[-1], dtype=bf16, scale=0.5) + 1.0
            beta = randn(shape[-1], dtype=bf16, scale=0.5)
            a = (x, gamma, beta)
            tag = " ".join(f"{key}={val}" for key, val in kw.items())
            cases.append(Case(
                "probe_groupnorm", f"bf16 {'x'.join(map(str, shape))} {tag}",
                lambda a=a, kw=kw: PG.group_norm_probe(*a, **kw),
                lambda a=a, kw=kw: PG.group_norm_probe_plain(*a, **kw),
                lambda a=a: F.silu(F.group_norm(a[0].permute(0, 3, 1, 2), 32, a[1], a[2])),
                "bfloat16", 10.0 * x.numel(), (2 * x.numel() + 2 * shape[-1]) * 2,
                (lambda a=a, kw=kw: k8_prior(*a, **kw)) if k8_prior else None))
    if "probe_copy" in want:
        # K9 at the three COPY_SHAPES of tools/probe_groupnorm.py, each in a
        # 64-row 4-stage mode and a whole-plane f32 mode, the replaced body
        # beside it (a parent tree may lack it)
        PS = importlib.import_module(f"{_PKG}.ops.probes.stream")
        copy_prior = getattr(PS, "stream_copy_prior", None)
        for hw, c in ((4096, 320), (4096, 640), (1024, 1280)):
            x = randn(8, hw, c, dtype=bf16)
            y = torch.empty_like(x)
            for rows, convert, stages in ((64, False, 4), (hw, True, 1)):
                a = (x, rows, convert, stages)
                cases.append(Case(
                    "probe_copy",
                    f"bf16 [8,{hw},{c}] rows={rows} convert={convert} stages={stages}",
                    lambda a=a: PS.stream_copy(*a), lambda a=a: PS.stream_copy_plain(*a),
                    lambda x=x, y=y: y.copy_(x), "bfloat16", 0.0, 2.0 * x.numel() * 2,
                    (lambda a=a: copy_prior(*a)) if copy_prior else None))
    return cases


def host_us(dev, calls: int = 500) -> dict:
    """Microseconds a call of K2's, K3's, K4's, K1's and K5's wrappers (K3,
    K4, K1 and K5 both bodies each, where the tree has them) take over ``calls`` eager
    calls at shapes where the card's work is a few microseconds, so the loop
    runs at the host's pace: the cost that sets the batch-1 step, which
    waits on the host. Then K3's route at a split-form shape of the b4 step
    and the allocation of that form's partials, by the host clock alone."""
    C = importlib.import_module(f"{_PKG}.ops.conv")
    A = importlib.import_module(f"{_PKG}.ops.attention")
    F2 = importlib.import_module(f"{_PKG}.ops.mlp")
    PA = importlib.import_module(f"{_PKG}.ops.probes.attention")
    x = torch.randn((1, 8, 8, 64), device=dev).to(torch.bfloat16)
    w = torch.randn((64, 64, 3, 3), device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    q = torch.randn((1, 256, 40), device=dev).to(torch.bfloat16)
    qd = q.reshape(1, 1, 40, 256)  # K5's d-major form of the same 256 x 40
    ff = [torch.randn(shape, device=dev).to(torch.bfloat16) * 0.05
          for shape in ((1, 64, 320), (320, 2560), (2560,), (1280, 320), (320,))]
    G = importlib.import_module(f"{_PKG}.ops.groupnorm")
    gx = torch.randn((2, 8, 8, 640), device=dev).to(torch.bfloat16)
    gg = torch.ones(640, device=dev, dtype=torch.bfloat16)
    ff32 = [t.float() for t in ff]
    xf, wf, bf = x.float(), w.float(), b.float()
    fns = {"geglu_ff (K2)": lambda: F2.geglu_ff(*ff),
           "geglu_ff (K2 f32 body)": lambda: F2.geglu_ff(*ff32),
           "group_norm_nhwc (K3 route)": lambda: G.group_norm_nhwc(gx, gg, gg, 32, 1e-5, True),
           "conv3x3 route (sm90 body)": lambda: C.conv3x3(x, w, b),
           "conv3x3_generic (mma.sync body)": lambda: C.conv3x3_generic(x, w, b),
           "conv3x3 route (f32 body)": lambda: C.conv3x3(xf, wf, bf),
           "flash_attention route (sm90 body)": lambda: A.flash_attention(q, q, q, 1),
           "attention_probe full (K7)": lambda: PA.attention_probe(q, q, q, 1, 0.158),
           "attention_dmajor route (K5)": lambda: A.attention_dmajor(qd, qd, qd, 0.158)}
    if hasattr(A, "attention_dmajor_prior"):  # a parent tree lacks it
        fns["attention_dmajor_prior (K5's replaced body)"] = (
            lambda: A.attention_dmajor_prior(qd, qd, qd, 0.158))
    if hasattr(G, "group_norm_prior"):  # a parent tree lacks it
        fns["group_norm_prior (K3's replaced body)"] = (
            lambda: G.group_norm_prior(gx, gg, gg, 32, 1e-5, True))
    out = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name] = 1e6 * (time.perf_counter() - t0) / calls
        # a b4 step's 64^2 x 320 GroupNorm, where K3 plans its split form (two
        # launches and a partials buffer): the card's work outlasts the
        # host's, so the host clock is read before the sync, over few enough
        # calls that the launch queue never fills; and the allocation of the
        # split form's partials alone
        sx = torch.randn((8, 64, 64, 320), device=dev).to(torch.bfloat16)
        sg = torch.ones(320, device=dev, dtype=torch.bfloat16)
        host_only = {
            "group_norm_nhwc (K3 route) 8x64x64x320, before the sync":
                lambda: G.group_norm_nhwc(sx, sg, sg, 32, 1e-5, True),
            "torch.empty of the split form's partials (8 x 16 x 32 float2)":
                lambda: torch.empty((8 * 16 * 32, 2), dtype=torch.float32, device=dev)}
        for name, fn in host_only.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            out[name] = 1e6 * (time.perf_counter() - t0) / 100
            torch.cuda.synchronize()
    return out
