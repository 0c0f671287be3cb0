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
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["Case", "kernel_cases", "PEAK_FLOPS", "HBM_BYTES_PER_S"]

_PKG = "complex_prompt_diffusion_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, f32
# outside the tensor cores (K1's exact f32 path uses no TF32), HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class Case(NamedTuple):
    kernel: str  # the name in ops.KERNEL_WRAPPERS
    label: str
    run: Callable  # the kernel's wrapper on this case's tensors
    plain: Callable  # its plain PyTorch twin
    library: Optional[Callable]  # one PyTorch call computing the same, or None
    dtype: str
    flops: float
    nbytes: float  # each input read once, each output written once

    def bound(self):
        """(least ms the card could take, "bytes" or "operations")."""
        t_ops = self.flops / PEAK_FLOPS[self.dtype] * 1e3
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
    want = set(kernels) if kernels else {"attention", "geglu_ff", "group_norm", "conv3x3",
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

    def attn_case(label, q, k, v, heads, dt):
        b, sq, inner = q.shape
        skv = k.shape[1]
        nbytes = (2 * b * sq + 2 * b * skv) * inner * q.element_size()
        cases.append(Case("attention", label,
                          lambda: A.flash_attention(q, k, v, heads),
                          lambda: A.attention_plain(q, k, v, heads), sdpa(q, k, v, heads), dt,
                          4.0 * b * sq * skv * inner, nbytes))

    if "attention" in want:
        # UNet self-attention at UNet batch 8 (q/k/v are views of one fused
        # qkv projection, as in the UNet), the f32 VAE mid-block, and the
        # bf16 mid-block of the batch-1 and batch-4 bf16 decode (and encode)
        for s_, c in ((4096, 320), (1024, 640), (256, 1280)):
            qkv = randn(8, s_, 3 * c, dtype=bf16)
            q, k, v = qkv.chunk(3, dim=-1)
            attn_case(f"bf16 B8 S{s_} H8 d{c // 8}", q, k, v, 8, "bfloat16")
        q, k, v = (randn(4, 4096, 512, dtype=f32) for _ in range(3))
        attn_case("f32 B4 S4096 H1 d512", q, k, v, 1, "float32")
        for b in (1, 4):
            q, k, v = (randn(b, 4096, 512, dtype=bf16) for _ in range(3))
            attn_case(f"bf16 B{b} S4096 H1 d512", q, k, v, 1, "bfloat16")
    if "geglu_ff" in want:
        # every UNet level at UNet batch 8; no single PyTorch call computes
        # the GEGLU FF, so it has no library time
        for m, c in ((32768, 320), (8192, 640), (2048, 1280), (512, 1280)):
            x = randn(m, c, dtype=bf16)
            w1 = uniform(c, 8 * c, bound=c ** -0.5, dtype=bf16)
            b1 = uniform(8 * c, bound=c ** -0.5, dtype=bf16)
            w2 = uniform(4 * c, c, bound=(4 * c) ** -0.5, dtype=bf16)
            b2 = uniform(c, bound=(4 * c) ** -0.5, dtype=bf16)
            a = (x, w1, b1, w2, b2)
            cases.append(Case("geglu_ff", f"bf16 M{m} C{c} H4 {4 * c}",
                              lambda a=a: F2.geglu_ff(*a), lambda a=a: F2.geglu_ff_plain(*a),
                              None, "bfloat16", 24.0 * m * c * c,
                              2.0 * (2 * m * c + 12 * c * c + 9 * c)))
    if "group_norm" in want:
        # bf16 UNet sites (eps 1e-5), the f32 VAE-decode planes and the bf16
        # planes of the b4 and the b1 bf16 decode (eps 1e-6)
        shapes = [((8, 64, 64, 320), bf16, 1e-5), ((8, 32, 32, 640), bf16, 1e-5),
                  ((8, 16, 16, 1280), bf16, 1e-5), ((8, 8, 8, 1280), bf16, 1e-5)]
        for b, dt in ((4, f32), (4, bf16), (1, bf16)):
            shapes += [((b, 64, 64, 512), dt, 1e-6), ((b, 128, 128, 512), dt, 1e-6),
                       ((b, 256, 256, 256), dt, 1e-6), ((b, 512, 512, 256), dt, 1e-6),
                       ((b, 512, 512, 128), dt, 1e-6)]
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
                (2 * x.numel() + 2 * shape[-1]) * x.element_size()))
    if "conv3x3" in want:
        # every distinct 3x3 conv of the batch-1 render (UNet batch 2), and
        # the exact f32 decode's conv on a 32^2 plane (a 32x32 latent)
        shapes = [(2, hw, c, co, bf16) for hw, c, co in (
            (32, 320, 640), (32, 640, 640), (32, 960, 640), (32, 1280, 640), (32, 1920, 640),
            (32, 1280, 1280), (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280),
            (16, 2560, 1280))] + [(1, 32, 512, 512, f32)]
        for b, hw, c, co, dt in shapes:
            x = randn(b, hw, hw, c, dtype=dt)
            w = uniform(co, c, 3, 3, bound=(9 * c) ** -0.5, dtype=dt).contiguous(
                memory_format=torch.channels_last)
            bias = uniform(co, bound=0.1, dtype=dt)
            a = (x, w, bias)
            m = b * hw * hw
            cases.append(Case(
                "conv3x3", f"{'bf16' if dt == bf16 else 'f32'} B{b} {hw}x{hw} {c}->{co}",
                lambda a=a: C.conv3x3(*a), lambda a=a: C.conv3x3_plain(*a),
                lambda a=a: F.conv2d(a[0].permute(0, 3, 1, 2), a[1], a[2], padding=1),
                "bfloat16" if dt == bf16 else "float32", 2.0 * m * co * 9 * c,
                x.element_size() * (m * c + 9 * c * co + m * co + co)))
    if "attention_cm" in want:
        # K5, hdbs mode: the cm block's [H, D, B, S] slices of one [3C, B, S]
        # projection at the levels the gate admits (UNet batch 8, and 2 for
        # batch 1). The library call is SDPA on canonical copies.
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
                2.0 * b * h * (sq + skv) * d * q.element_size()))

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
        # kcanon mode: every self-attention level (UNet batch 8; level 0 at 2)
        for b, s_, c in ((8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (2, 4096, 320)):
            cm_case(f"kcanon bf16 B{b} S{s_} H8 d{c // 8}", *kcanon(b, s_, s_, c, bf16), True,
                    "bfloat16")
        cm_case("kcanon f32 B2 S1024 H8 d80", *kcanon(2, 1024, 1024, 640, f32), True, "float32")
        cm_case("kcanon bf16 B2 Sq1000 Skv1336 H8 d40 (ragged)",
                *kcanon(2, 1000, 1336, 320, bf16), True, "bfloat16")
    if "winograd" in want:
        # K6 at the batch-1 render's square convs (UNet batch 2), one
        # batch-8 shape and an f32 one; U is made once, outside the timed
        # call, as a caller with fixed weights would. The library call is the
        # direct conv (cuDNN); K4's cases above time the same shapes.
        shapes = [(2, 32, 640, 640, bf16), (2, 32, 1280, 1280, bf16), (2, 16, 1280, 1280, bf16),
                  (8, 32, 640, 640, bf16), (1, 32, 512, 512, f32)]
        for b, hw, c, co, dt in shapes:
            x = randn(b, hw, hw, c, dtype=dt)
            k = uniform(3, 3, c, co, bound=(9 * c) ** -0.5, dtype=dt)
            bias = uniform(co, bound=0.1, dtype=dt)
            u = W.winograd_weights(k).to(dt)
            w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            a = (x, k, bias, u)
            m = b * hw * hw
            cases.append(Case(
                "winograd", f"{'bf16' if dt == bf16 else 'f32'} B{b} {hw}x{hw} {c}->{co}",
                lambda a=a: W.wino3x3(*a), lambda a=a: W.wino3x3_plain(a[0], a[3], a[2]),
                lambda x=x, w=w_oihw, bias=bias: F.conv2d(x.permute(0, 3, 1, 2), w, bias,
                                                          padding=1),
                "bfloat16" if dt == bf16 else "float32", 2.0 * m * co * 4 * c,
                x.element_size() * (m * c + 16 * c * co + m * co) + 4 * co))
    # the probes (imported here: a source tree without them runs the cases
    # above); each at a shape of its TPU script, the tools/probe_*.py rows
    # time every variant
    if "probe_attention" in want:
        PA = importlib.import_module(f"{_PKG}.ops.probes.attention")
        # the scores mode (perf_attn10 A, and F on K1's f32 loop) has no
        # library call
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
                flops, 4.0 * 8 * s_ * c * q.element_size()))
    if "probe_groupnorm" in want:
        PG = importlib.import_module(f"{_PKG}.ops.probes.groupnorm")
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
                "bfloat16", 10.0 * x.numel(), (2 * x.numel() + 2 * shape[-1]) * 2))
    if "probe_copy" in want:
        PS = importlib.import_module(f"{_PKG}.ops.probes.stream")
        x = randn(8, 4096, 320, dtype=bf16)
        y = torch.empty_like(x)
        for rows, convert, stages in ((64, False, 4), (4096, True, 1)):
            a = (x, rows, convert, stages)
            cases.append(Case(
                "probe_copy", f"bf16 [8,4096,320] rows={rows} convert={convert} stages={stages}",
                lambda a=a: PS.stream_copy(*a), lambda a=a: PS.stream_copy_plain(*a),
                lambda: y.copy_(x), "bfloat16", 0.0, 2.0 * x.numel() * 2))
    return cases
