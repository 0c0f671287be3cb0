"""The kernel cases that ``chip_smoke.py`` (phase 1) and ``tree_ab`` run.

Each case is one kernel call at a shape its paths use (for the Winograd
probe, which no path uses: at shapes K4's cases have), with its plain
PyTorch twin, the one PyTorch call that computes the same function where
there is one (timed beside the kernel as a yardstick, never used by the
port), and the flops and bytes the function needs, from which
:meth:`Case.bound` gives the least time an H100 could take.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["Case", "kernel_cases", "host_us", "unet_sites", "unet_batch_shapes", "PEAK_FLOPS",
           "HBM_BYTES_PER_S", "B1_UNET_CONVS", "B1_UNET_CONV_COUNTS", "GEGLU_ROWS",
           "GEGLU_B4_CALLS", "GEGLU_B1_ROWS", "GN_UNET_PLANES", "GN_B4_CALLS", "GN_DECODE_PLANES",
           "GN_CAT_PLANES", "GN_CAT_CALLS", "SD21_LATENT", "unet_call_groups", "unet_shape_keys",
           "held_unet_shapes", "LDM_VQ4_UNET", "ldm_vq4_config", "LDM_VQ4_WINO_CONVS"]

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
# (plane side, Ca, Cb) of the two-source GroupNorms of a fused UNet call (the
# up path's hidden state beside its skip: models/unet.py skip_cat_fused, UNet
# batch <= 4 in bf16), and how many of its 12 have that shape; they replace
# the 12 concat planes of GN_UNET_PLANES (C = 960 .. 2560 and the up path's
# 640 and 1280 ones)
GN_CAT_PLANES = ((8, 1280, 1280), (16, 1280, 1280), (16, 1280, 640), (32, 1280, 640),
                 (32, 640, 640), (32, 640, 320), (64, 640, 320), (64, 320, 320))
GN_CAT_CALLS = (3, 2, 1, 1, 1, 1, 1, 2)
# (plane side, C) of the VAE decoder's planes: the mid-block and the four up
# levels (30 GroupNorms a decode, over these shapes)
GN_DECODE_PLANES = ((64, 512), (128, 512), (256, 256), (512, 256), (512, 128))

SD21_LATENT = 96  # latent side of SD 2.1's 768x768 renders

# The UNet params of CompVis latent-diffusion's
# configs/latent-diffusion/celebahq-ldm-vq-4.yaml (ffhq-ldm-vq-4.yaml and
# lsun_bedrooms-ldm-vq-4.yaml set the same): model.params.unet_config.params.
# Widths 224 / 448 / 672 / 896, up-path concats 672 .. 1792; 224, 672, 1120
# and 1568 are 32 mod 64. A 64x64 latent of 3 channels, no context.
LDM_VQ4_UNET = {"image_size": 64, "in_channels": 3, "out_channels": 3, "model_channels": 224,
                "attention_resolutions": [8, 4, 2], "num_res_blocks": 2,
                "channel_mult": [1, 2, 3, 4], "num_head_channels": 32}
# K6's phase-1 cases at those widths, (plane side, C, Co) at UNet batch 2:
# ResBlock convs of the 32^2 and 16^2 planes
LDM_VQ4_WINO_CONVS = ((32, 672, 448), (16, 448, 672), (16, 672, 672))


def ldm_vq4_config(dtype: str = "bfloat16"):
    """The port's UNetConfig of :data:`LDM_VQ4_UNET` (``config.
    unet_config_from_yaml``) in ``dtype``."""
    from complex_prompt_diffusion_tpu_torch import config

    return dataclasses.replace(config.unet_config_from_yaml(LDM_VQ4_UNET), dtype=dtype)


def unet_sites(cfg, latent: int, deep_at=None, model: int = 1, fused: bool = False) -> dict:
    """The kernel sites of one UNet call of config ``cfg`` on a ``latent`` x
    ``latent`` input, walking ``models.unet.build_plan`` as ``unet_apply``
    does: "attn", (plane side, channels, heads, head dim) of every
    transformer (its self-attention at S = side^2; its cross-attention over
    the 77 context tokens); "self_attn", (Sq, Skv, heads, head dim) of each
    transformer's self-attention after the config's token reduction (ToDo:
    Skv = S / (tome_sx * tome_sy); ToMe: Sq = Skv = S - r); "ff_rows", (rows
    a sample, channels) of each GEGLU FF (S - r under ToMe's ``tome_mlp``);
    "conv", (plane side, C, Co) of every stride-1 3x3 conv (conv_in, a
    ResBlock's two, the up convs after their 2x upsample unless
    ``layers.subpixel_up_wanted`` takes them, the out conv; the down convs
    have stride 2); "gn_planes", (plane side, C) of every GroupNorm (a
    ResBlock's in_norm over its input and out_norm over its output, a
    transformer's norm, the out norm); "gn", the count of K3 calls.
    ``fused``: the up path's ResBlocks with a skip conv take the (h, skip)
    pair (``models.unet.skip_cat_fused``): "gn_cat", (plane side, Ca, Cb) of
    their in_norms on K3's two-source form (one call each, in "gn"), and
    their in_conv as two convs (side, Ca, Co) and (side, Cb, Co).
    ``deep_at``: the DeepCache shallow pass resumed at that output block
    (the input blocks whose skips it pops, no middle block, the output
    blocks from ``deep_at`` on). ``model``: a rank's sites under tensor
    parallelism over that many ranks (``ops.sharding.local_heads``: the
    heads of "attn" and "self_attn"; "ff_rows" gain the rank's hidden width
    H4, ``local_hidden``, as a third element)."""
    from complex_prompt_diffusion_tpu_torch.models.unet import _tome_sites, build_plan
    from complex_prompt_diffusion_tpu_torch.ops.sharding import local_heads, local_hidden

    from complex_prompt_diffusion_tpu_torch.models.layers import subpixel_up_wanted

    input_plan, middle_plan, output_plan = build_plan(cfg)
    sites = {"attn": [], "self_attn": [], "ff_rows": [], "conv": [], "gn_planes": [],
             "gn_cat": []}
    side = latent
    keep_in = len(input_plan) - deep_at if deep_at is not None else len(input_plan)
    start_out = deep_at if deep_at is not None else 0
    skip_chans = []  # the channels each input block leaves for its output block
    ch = cfg.model_channels
    for block in input_plan:
        ch = next((d[2] for d in reversed(block) if d[0] == "res"), ch)
        skip_chans.append(ch)

    def walk(block, run: bool, skip: int = 0):
        nonlocal side
        for j, desc in enumerate(block):
            kind = desc[0]
            if kind == "down":
                side //= 2
            elif kind == "up":
                side *= 2
            if not run:
                continue
            if kind == "conv_in":
                sites["conv"].append((side, cfg.in_channels, cfg.model_channels))
            elif kind == "res" and fused and j == 0 and skip and desc[1] != desc[2]:
                ca, co = desc[1] - skip, desc[2]
                sites["conv"] += [(side, ca, co), (side, skip, co), (side, co, co)]
                sites["gn_cat"].append((side, ca, skip))
                sites["gn_planes"].append((side, co))
            elif kind == "res":
                sites["conv"] += [(side, desc[1], desc[2]), (side, desc[2], desc[2])]
                sites["gn_planes"] += [(side, desc[1]), (side, desc[2])]
            elif kind == "attn":
                s, (heads, d) = side * side, desc[2:4]
                inner, heads = heads * d, local_heads(heads, model)
                on, r = _tome_sites(cfg, side, side)
                sq = skv = s - r
                if on and cfg.tome_mode == "downsample":
                    skv = s // (cfg.tome_sx * cfg.tome_sy)
                sites["attn"].append((side, desc[1], heads, d))
                sites["self_attn"].append((sq, skv, heads, d))
                ff = (s - r if cfg.tome_mlp else s, desc[1])
                sites["ff_rows"].append(ff + (local_hidden(4 * inner, model),) if model > 1
                                        else ff)
                sites["gn_planes"].append((side, desc[1]))
            elif kind == "up" and not subpixel_up_wanted((desc[1], desc[1], 3, 3)):
                sites["conv"].append((side, desc[1], desc[1]))

    for i, block in enumerate(input_plan):
        walk(block, i < keep_in)
    walk(middle_plan, deep_at is None)
    for i, block in enumerate(output_plan):
        walk(block, i >= start_out, skip_chans[len(input_plan) - 1 - i])
    sites["conv"].append((side, cfg.model_channels, cfg.out_channels))
    sites["gn_planes"].append((side, cfg.model_channels))
    sites["gn"] = len(sites["gn_planes"]) + len(sites["gn_cat"])
    return sites


def unet_batch_shapes(cfg, latent: int, ub: int, deep_at=None, model: int = 1,
                      fused=None) -> dict:
    """Every distinct shape one bf16 UNet call of ``cfg`` on a ``latent`` x
    ``latent`` input at UNet batch ``ub`` gives K1-K4, from its sites
    (:func:`unet_sites`, ``deep_at`` for a shallow pass, ``fused`` the up
    path's form: by default ``models.unet.skip_cat_fused``): "attn", (S,
    heads, head dim) of the self-attention sites K1 takes (above
    ``SHORT_KV`` keys) with Sq = Skv; "attn_kv", (Sq, Skv, heads, head dim)
    of those with Sq != Skv (ToDo's pooled K/V); "ff", (M, C) of the GEGLU
    FFs (K2; (M, C, H4) with the rank's hidden width under ``model`` > 1
    tensor-parallel ranks, whose heads "attn" gives); "gn", (N, side, side,
    C) of the GroupNorms (K3); "gn_cat", (N, side, side, Ca, Cb) of the
    two-source ones (K3's two-source form); "conv", (side, C, Co) of the
    convs K4's gate admits at this batch."""
    from complex_prompt_diffusion_tpu_torch.models.layers import conv3x3_wanted
    from complex_prompt_diffusion_tpu_torch.models.unet import skip_cat_fused
    from complex_prompt_diffusion_tpu_torch.ops.attention import SHORT_KV

    if fused is None:
        fused = skip_cat_fused(ub, torch.bfloat16)
    sites = unet_sites(cfg, latent, deep_at, model, fused)
    distinct = dict.fromkeys  # first-seen order, no repeats
    k1 = [site for site in sites["self_attn"] if site[1] > SHORT_KV]
    return {
        "attn": list(distinct((sq, heads, d) for sq, skv, heads, d in k1 if sq == skv)),
        "attn_kv": list(distinct(site for site in k1 if site[0] != site[1])),
        "ff": list(distinct((ub * ff[0],) + ff[1:] for ff in sites["ff_rows"])),
        "gn": list(distinct((ub, side, side, c) for side, c in sites["gn_planes"])),
        "gn_cat": list(distinct((ub, side, side, ca, cb) for side, ca, cb in sites["gn_cat"])),
        "conv": list(distinct(
            (side, c, co) for side, c, co in sites["conv"]
            if conv3x3_wanted(torch.empty((ub, side, side, c), device="meta"), (co, c, 3, 3)))),
    }


def unet_call_groups() -> dict:
    """The full-width bf16 UNet calls whose every distinct K1-K4 shape phase
    1 holds to its plain twin, by ``kernel_cases`` group: lists of (config,
    latent side, UNet batch). SD-1.5 on the 64x64 latent of a 512x512 render
    at UNet batch 1 (attention guidance's unconditional call), 2 (a b1 CFG
    step), 3 and 4 (a 2- and a 3-factor prompt at b1; a chunk of 2 tiles),
    8 (b4) and 16 (a 3-factor prompt at b4); SD 2.1 on its 96x96 latent and
    SD-2's 512^2 UNet at 8 and 2; ToDo (0.75) at 8 and 2; ToMe merge (0.75
    and 0.3, with tome_mlp) at 2; "tp2" and "tp4", a rank of SD-1.5
    tensor-parallel over 2 and 4 ranks at UNet batch 2 (a fourth element:
    the model size; K1 at 4 and 2 heads, K2 at a half and a quarter of the
    hidden width; their K1 and K2 cases in f32 too, the shapes of the f32
    tensor-parallel eval); "ldm_vq4", a UNet at CompVis LDM-VQ-4's widths
    (:data:`LDM_VQ4_UNET`, no context) on its 64x64 latent at UNet batch 2
    and 4. ``chip_smoke.py`` fails a path
    whose UNet calls bring a shape none of these has
    (:func:`held_unet_shapes`)."""
    from complex_prompt_diffusion_tpu_torch.models import UNetConfig

    sd15 = UNetConfig.sd15()
    todo = dataclasses.replace(sd15, tome_ratio=0.75, tome_mode="downsample")
    groups = {f"ub{ub}": [(sd15, 64, ub)] for ub in (1, 2, 3, 4, 8, 16)}
    groups["sd21"] = [(UNetConfig.sd21(), SD21_LATENT, ub) for ub in (8, 2)]
    groups["sd2_512"] = [(UNetConfig.sd2_depth(), 64, ub) for ub in (2, 8)]
    groups["todo"] = [(todo, 64, ub) for ub in (8, 2)]
    groups["tome"] = [(dataclasses.replace(sd15, tome_ratio=ratio, tome_mode="merge",
                                           tome_mlp=True), 64, 2) for ratio in (0.75, 0.3)]
    for model in (2, 4):
        groups[f"tp{model}"] = [(sd15, 64, 2, model)]
    groups["ldm_vq4"] = [(ldm_vq4_config(), 64, ub) for ub in (2, 4)]
    return groups


def unet_shape_keys(cfg, latent: int, ub: int, deep_at=None, model: int = 1,
                    fused=None) -> set:
    """The K1-K4 shapes of one bf16 UNet call (:func:`unet_batch_shapes`;
    a rank's under ``model`` tensor-parallel ranks; the up path's form by
    ``fused``) as keys: ("k1", UNet batch, Sq, Skv, heads, head dim), ("k2",
    M, C) (("k2", M, C, H4) for a rank's hidden shard), ("k3", N, side,
    side, C), ("k3cat", N, side, side, Ca, Cb), ("k4", UNet batch, side, C,
    Co)."""
    shapes = unet_batch_shapes(cfg, latent, ub, deep_at, model, fused)
    return ({("k1", ub, s, s, heads, d) for s, heads, d in shapes["attn"]}
            | {("k1", ub) + site for site in shapes["attn_kv"]}
            | {("k2",) + ff for ff in shapes["ff"]}
            | {("k3",) + gn for gn in shapes["gn"]}
            | {("k3cat",) + gn for gn in shapes["gn_cat"]}
            | {("k4", ub) + conv for conv in shapes["conv"]})


@functools.lru_cache(maxsize=None)
def held_unet_shapes() -> frozenset:
    """The keys (:func:`unet_shape_keys`) of every UNet call of
    :func:`unet_call_groups`, with the up path materialized and, at the UNet
    batches the fused gate admits, fused: the shapes phase 1 holds."""
    return frozenset().union(*(unet_shape_keys(cfg, latent, ub, model=rest[0] if rest else 1,
                                               fused=fused)
                               for calls in unet_call_groups().values()
                               for cfg, latent, ub, *rest in calls
                               for fused in _up_forms(ub)))


def _up_forms(ub: int) -> tuple:
    """The up path's forms a bf16 UNet call at UNet batch ``ub`` can take:
    materialized, and fused where the gate's batch bound admits it (with
    ``CPD_TPU_FUSE_SKIP_CAT`` on or off)."""
    return (False, True) if ub <= 4 else (False,)


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
    # K3's two-source form: the materialized port path it replaces (torch.cat,
    # then K3 on the concat), timed beside it; None elsewhere
    materialized: Optional[Callable] = None

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
    want = set(kernels) if kernels else ({"attention", "attention_sm90", "attention_f32_sm90",
                                          "attention_bf16_wide_sm90", "geglu_ff",
                                          "geglu_ff_f32_sm90", "group_norm", "conv3x3",
                                          "conv3x3_sm90", "conv3x3_f32_sm90", "attention_cm",
                                          "winograd", "probe_attention", "probe_groupnorm",
                                          "probe_copy", "sd21", "vae1024"}
                                         | set(unet_call_groups()))

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
    def tag(dt):
        return "bf16" if dt == bf16 else "f32"

    def ff_case(kernel, m, c, dt, h4=None):
        h4 = h4 or 4 * c  # a tensor-parallel rank's hidden shard is narrower
        x = randn(m, c, dtype=dt)
        w1 = uniform(c, 2 * h4, bound=c ** -0.5, dtype=dt)
        b1 = uniform(2 * h4, bound=c ** -0.5, dtype=dt)
        w2 = uniform(h4, c, bound=h4 ** -0.5, dtype=dt)
        b2 = uniform(c, bound=h4 ** -0.5, dtype=dt)
        a = (x, w1, b1, w2, b2)
        cases.append(Case(kernel, f"{tag(dt)} M{m} C{c} H4 {h4}",
                          lambda a=a: F2.geglu_ff(*a), lambda a=a: F2.geglu_ff_plain(*a),
                          None, "bfloat16" if dt == bf16 else "float32", 6.0 * m * c * h4,
                          x.element_size() * (2 * m * c + 3 * c * h4 + 2 * h4 + c),
                          rate="tf32x3" if dt == f32 else None))

    # the replaced body beside each GroupNorm (a parent tree may lack its wrapper)
    gn_prior = getattr(G, "group_norm_prior", None)

    def gn_case(shape, dt, eps):
        x = randn(*shape, dtype=dt, scale=2.0) + 0.5
        gamma = randn(shape[-1], dtype=dt, scale=0.5) + 1.0
        beta = randn(shape[-1], dtype=dt, scale=0.5)
        a = (x, gamma, beta, 32, eps, True)
        cases.append(Case(
            "group_norm", f"{tag(dt)} {'x'.join(map(str, shape))} silu",
            lambda a=a: G.group_norm_nhwc(*a), lambda a=a: G.group_norm_plain(*a),
            lambda a=a: F.silu(F.group_norm(a[0].permute(0, 3, 1, 2), 32, a[1], a[2], a[4])),
            "bfloat16" if dt == bf16 else "float32", 10.0 * x.numel(),
            (2 * x.numel() + 2 * shape[-1]) * x.element_size(),
            (lambda a=a: gn_prior(*a)) if gn_prior else None))

    # K4's replaced mma.sync / FMA body beside its Hopper and narrow bodies
    # (a parent tree may lack it)
    generic = getattr(C, "conv3x3_generic", None)

    def k4_case_kernel(dt, c, co):
        # a case's kernel name: the body K4's route takes (a parent tree
        # without the narrow bodies routes those widths to "generic")
        return {"bf16_sm90": "conv3x3_sm90", "f32_sm90": "conv3x3_f32_sm90",
                "narrow": "conv3x3_narrow"}.get(C.k4_body(dt, c, co), "conv3x3")

    def conv_case(kernel, b, hw, c, co, dt):
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

    def wino_cases(shapes):
        # K6 at (b, plane side, C, Co, dtype), U made once, outside the timed
        # call, as a caller with fixed weights would; the library call is the
        # direct conv (cuDNN). Each case runs the Hopper body of its dtype (the
        # f32 one bound at the rate of three TF32 products) with the first
        # body beside it. (A parent tree may lack the Hopper bodies and their
        # wrappers; the labels are the parent's, so that tree_ab compares the
        # same cases.)
        wino_prior = getattr(W, "wino3x3_prior", None)
        k6_body = getattr(W, "k6_body", None)
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

    ff_dtypes = [(bf16, "geglu_ff")] if "geglu_ff" in want else []
    if "geglu_ff_f32_sm90" in want:
        ff_dtypes.append((f32, "geglu_ff_f32_sm90"))
    for dt, kernel in ff_dtypes:
        for m, c in GEGLU_ROWS:
            ff_case(kernel, m, c, dt)
    if "group_norm" in want:
        # every GroupNorm shape of a UNet call at UNet batch 8 (the b4 step)
        # and 2 (the b1 step), bf16, eps 1e-5; the f32 VAE-decode planes and
        # the bf16 planes of the b4 and the b1 bf16 decode (eps 1e-6)
        shapes = [((b, side, side, c), bf16, 1e-5) for b in (8, 2) for side, c in GN_UNET_PLANES]
        for b, dt in ((4, f32), (4, bf16), (1, bf16)):
            shapes += [((b, side, side, c), dt, 1e-6) for side, c in GN_DECODE_PLANES]
        for shape, dt, eps in shapes:
            gn_case(shape, dt, eps)
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
        # K4's narrow bodies at the shapes the paths launch them at, each with
        # the body they replaced there (csrc/conv3x3.cu) beside it: the
        # UNet's conv_in and out conv on a 16^2 latent at UNet batch 2 (phases
        # 3, 11, 15, 17 and 18) and 1 (phase 21), and on a 32^2 one (a 256^2
        # render); the concat UNets' conv_in on a 16^2 latent (phase 15); the
        # VAE decoder's conv_in and the encoder's conv_out on a 16^2 latent
        # (phases 3 and 11) and a 32^2 one; the default (tiny) bundle's
        # conv_in and out conv (phase 11). Then the tiny bundle's 32 -> 32 and
        # 96 -> 32 (phase 11), which the f32 Hopper body takes (Co a quarter of
        # its n-tile) with the generic body beside them
        for dt in (bf16, f32):
            for b, hw in ((2, 16), (2, 32), (1, 16)):
                shapes += [("conv3x3_narrow", b, hw, 4, 320, dt),
                           ("conv3x3_narrow", b, hw, 320, 4, dt)]
            shapes += [("conv3x3_narrow", 2, 16, c, 320, dt) for c in (9, 5)]
            for hw in (16, 32):
                shapes += [("conv3x3_narrow", 1, hw, 4, 512, dt),
                           ("conv3x3_narrow", 1, hw, 512, 8, dt)]
        shapes += [("conv3x3_narrow", 4, 16, 4, 32, f32), ("conv3x3_narrow", 4, 16, 32, 4, f32)]
        shapes += [(k4_case_kernel(f32, c, 32), 4, 16, c, 32, f32) for c in (32, 96)]
    for shape in shapes:
        conv_case(*shape)
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
        # != Co, one batch-8 shape and an f32 one; K4's cases above time the
        # same shapes
        wino_cases([(2, 32, 640, 640, bf16), (2, 32, 1280, 1280, bf16),
                    (2, 16, 1280, 1280, bf16), (8, 32, 640, 640, bf16), (2, 32, 960, 640, bf16),
                    (2, 16, 2560, 1280, bf16), (1, 32, 512, 512, f32)])
    if "sd21" in want:
        # SD 2.1 at 768x768 (a 96x96 latent), beside its UNet calls (the
        # group's entry in unet_call_groups, below): the VAE mid-block at S =
        # 9216 (the b1 bf16 decode on the wide body, the b4 exact decode on
        # the 3xTF32 one) and the decodes' largest GroupNorm planes (their
        # replaced body beside them)
        q, k, v = (randn(1, 9216, 512, dtype=bf16) for _ in range(3))
        attn_case("bf16 B1 S9216 H1 d512", q, k, v, 1, "bfloat16", "attention_bf16_wide_sm90")
        q, k, v = (randn(4, 9216, 512, dtype=f32) for _ in range(3))
        attn_case("f32 B4 S9216 H1 d512", q, k, v, 1, "float32", "attention_f32_sm90",
                  rate="tf32x3")
        for shape, dt in (((4, 768, 768, 128), f32), ((1, 768, 768, 256), bf16)):
            gn_case(shape, dt, 1e-6)
    if "vae1024" in want:
        # the untiled bf16 decode of a 1024x1024 canvas (a 128x128 latent:
        # chip_smoke's phase 19(d), against the tiled one): the mid-block at
        # S = 16384 and its decoder's GroupNorm planes that the 512x512
        # decode's cases above do not hold (its 128^2 x 512 and 512^2 x 256
        # planes are theirs)
        q, k, v = (randn(1, 16384, 512, dtype=bf16) for _ in range(3))
        attn_case("bf16 B1 S16384 H1 d512", q, k, v, 1, "bfloat16", "attention_bf16_wide_sm90")
        held = {(2 * side, c) for side, c in GN_DECODE_PLANES} & set(GN_DECODE_PLANES)
        for side, c in GN_DECODE_PLANES:
            if (2 * side, c) not in held:
                gn_case((1, 2 * side, 2 * side, c), bf16, 1e-6)
    # every distinct K1-K4 shape of the UNet calls of each group of
    # unet_call_groups, with the up path materialized and, at the UNet
    # batches the fused gate admits, fused, that no case before it has: K1's
    # sm90 body at each self-attention site K1 takes (views of one qkv
    # projection; where ToDo pools the K/V, q beside views of one kv
    # projection), K2 at each FF's M (ToMe's merged rows under tome_mlp), K3
    # on every GroupNorm plane (its replaced body beside it) and its
    # two-source form on every (Ca | Cb) pair, K4 on the convs its gate admits (the
    # mma.sync body beside its sm90 body). The "sd2_512" group adds K1 at
    # the middle block's 64 tokens (in a UNet call the short path takes
    # them: S <= SHORT_KV), then K4's narrow-C body on the concat UNets'
    # conv_in at a 256x256 render (a 32x32 latent, UNet batch 2): 9 -> 320
    # (inpaint) and 5 -> 320 (depth), bf16 and f32
    have = {(c.kernel, c.label) for c in cases}

    def new(kernel, label):
        fresh = (kernel, label) not in have
        have.add((kernel, label))
        return fresh

    def gn_cat_case(n, side, ca, cb):
        # K3's two-source form (the port's fused up-path ResBlock) in the form
        # its plan picks (the slab form's cases are "group_norm_cat_slab"),
        # with the body it replaced (the split form, which the plan runs where no
        # slab fits) beside a slab case, and the materialized port path
        # beside every case (torch.cat, then K3)
        x = randn(n, side, side, ca + cb, dtype=bf16, scale=2.0) + 0.5
        xa, xb = x[..., :ca].contiguous(), x[..., ca:].contiguous()
        gamma = randn(ca + cb, dtype=bf16, scale=0.5) + 1.0
        beta = randn(ca + cb, dtype=bf16, scale=0.5)
        a = (xa, xb, gamma, beta, 32, 1e-5, True)
        slab = G.group_norm_cat_plan(n, side * side, ca, cb, 32, 132).form == "slab"
        split = (G.GnPlan("split", max(1, min(G._sm_count(x.device.index or 0) // n,
                                              side * side)), 2)
                 if slab and x.is_cuda else None)
        cases.append(Case(
            "group_norm_cat_slab" if slab else "group_norm_cat",
            f"bf16 {n}x{side}x{side}x{ca}|{cb} silu",
            lambda a=a: G.group_norm_silu_cat(*a), lambda a=a: G.group_norm_silu_cat_plain(*a),
            lambda a=a: F.silu(F.group_norm(torch.cat(a[:2], dim=-1).permute(0, 3, 1, 2), 32,
                                            a[2], a[3], a[5])),
            "bfloat16", 10.0 * x.numel(), (2 * x.numel() + 2 * (ca + cb)) * 2,
            (lambda a=a: G.group_norm_silu_cat(*a, plan=split)) if split else None,
            materialized=lambda a=a: G.group_norm_nhwc(torch.cat(a[:2], dim=-1), *a[2:])))

    for group, calls in unet_call_groups().items():
        if group not in want:
            continue
        for (cfg, latent, ub, *rest), fused in ((call, fused) for call in calls
                                                 for fused in _up_forms(call[2])):
            shapes = unet_batch_shapes(cfg, latent, ub, model=rest[0] if rest else 1,
                                       fused=fused)
            extra = [(64, 20, 64)] if group == "sd2_512" else []
            for s_, heads, d in shapes["attn"] + extra:
                label = f"bf16 B{ub} S{s_} H{heads} d{d}"
                if new("attention_sm90", label):
                    q, k, v = randn(ub, s_, 3 * heads * d, dtype=bf16).chunk(3, dim=-1)
                    attn_case(label, q, k, v, heads, "bfloat16", "attention_sm90")
            for sq, skv, heads, d in shapes.get("attn_kv", ()):
                label = f"bf16 B{ub} Sq{sq} Skv{skv} H{heads} d{d}"
                if new("attention_sm90", label):
                    q = randn(ub, sq, heads * d, dtype=bf16)
                    k, v = randn(ub, skv, 2 * heads * d, dtype=bf16).chunk(2, dim=-1)
                    attn_case(label, q, k, v, heads, "bfloat16", "attention_sm90")
            for m, c, *h4 in shapes["ff"]:
                h4 = h4[0] if h4 else 4 * c
                if new("geglu_ff", f"bf16 M{m} C{c} H4 {h4}"):
                    ff_case("geglu_ff", m, c, bf16, h4)
            if rest:  # a tensor-parallel rank's K1 and K2 in f32 (the 3xTF32 bodies)
                for s_, heads, d in shapes["attn"]:
                    label = f"f32 B{ub} S{s_} H{heads} d{d}"
                    if new("attention", label):
                        q, k, v = randn(ub, s_, 3 * heads * d, dtype=f32).chunk(3, dim=-1)
                        attn_case(label, q, k, v, heads, "float32", "attention", None, "tf32x3")
                for sq, skv, heads, d in shapes.get("attn_kv", ()):
                    label = f"f32 B{ub} Sq{sq} Skv{skv} H{heads} d{d}"
                    if new("attention", label):
                        q = randn(ub, sq, heads * d, dtype=f32)
                        k, v = randn(ub, skv, 2 * heads * d, dtype=f32).chunk(2, dim=-1)
                        attn_case(label, q, k, v, heads, "float32", "attention", None, "tf32x3")
                for m, c, h4 in shapes["ff"]:
                    if new("geglu_ff_f32_sm90", f"f32 M{m} C{c} H4 {h4}"):
                        ff_case("geglu_ff_f32_sm90", m, c, f32, h4)
            for shape in shapes["gn"]:
                if new("group_norm", f"bf16 {'x'.join(map(str, shape))} silu"):
                    gn_case(shape, bf16, 1e-5)
            for n, side, _, ca, cb in shapes.get("gn_cat", ()):
                if new("group_norm_cat", f"bf16 {n}x{side}x{side}x{ca}|{cb} silu"):
                    gn_cat_case(n, side, ca, cb)
            for side, c, co in shapes["conv"]:
                kernel = k4_case_kernel(bf16, c, co)
                if new(kernel, f"bf16 B{ub} {side}x{side} {c}->{co}"):
                    conv_case(kernel, ub, side, c, co, bf16)
        if group == "sd2_512":
            for c in (9, 5):
                for dt in (bf16, f32):
                    conv_case(k4_case_kernel(dt, c, 320), 2, 32, c, 320, dt)
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
    # the cases added last (so that the ones above draw the inputs they drew
    # before, and tree_ab compares their bits with a parent's)
    if "conv3x3" in want:
        # K4's generic body at widths only it takes: bf16 C = 20 (phase 17's
        # grad case), f32 C = 18
        conv_case(k4_case_kernel(bf16, 20, 320), 2, 16, 20, 320, bf16)
        conv_case(k4_case_kernel(f32, 18, 320), 2, 16, 18, 320, f32)
    if "conv3x3_f32_sm90" in want:
        # an f32 UNet call at CompVis LDM-VQ-4's widths (224 .. 1568 channels,
        # C or Co off the 32- and 128-channel tiles) at UNet batch 1 and 2
        ldm32 = ldm_vq4_config("float32")
        for ub in (1, 2):
            for hw, c, co in unet_batch_shapes(ldm32, 64, ub, fused=False)["conv"]:
                conv_case("conv3x3_f32_sm90", ub, hw, c, co, f32)
    if "winograd" in want and "ldm_vq4" in want:
        # K6 at CompVis LDM-VQ-4's ResBlock widths (UNet batch 2, both
        # dtypes; C = 672 and Co = 672 off its 64-channel chunk and
        # 128-channel block), after K4's cases at the same shapes
        wino_cases([(2, hw, c, co, dt) for dt in (bf16, f32)
                    for hw, c, co in LDM_VQ4_WINO_CONVS])
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
