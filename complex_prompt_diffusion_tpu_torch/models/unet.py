"""Stable Diffusion UNet as plain functions on tensors.

Counterpart of ``complex_prompt_diffusion_tpu/models/unet.py``: the same
static plan (:func:`build_plan`), the same parameter tree, NHWC activations,
compute in ``cfg.dtype`` with f32 norm statistics. Self-attention, the GEGLU
MLP and every GroupNorm go through the port's kernels (``ops``); with
``UNetConfig.attn_route == "cm"`` the self-attention sites the JAX gate
admits run the fused channel-major block (K5).

:func:`unet_apply` takes every option of the JAX function: the skip and
decoder-feature interfaces (``return_skips`` / ``inject_skips``,
``return_feats`` / ``inject_feats``), cross-attention probability maps for
DAAM (``collect_attn_maps``: an explicit softmax at the cross-attention
sites, whose 77 keys take the plain path anyway), and DeepCache
(``return_deep_at``; ``deep_feature`` + ``deep_at``: the shallow pass, the
identical subgraph of the full pass; :func:`make_deepcache_unets`). Token
reduction (``UNetConfig.tome_*``, ``ops/tome.py``) shrinks the large
self-attention sites: ToDo pools their K/V (K1 with Sq != Skv), ToMe merges
the sequence (K1 on the merged tokens; K2 too with ``tome_mlp``).

Hypernetworks (``models/params.attach_hypernetwork``: "hyper_k" /
"hyper_v" at an attention site) transform the context before the site's k
or v projection, in the step and in :func:`precompute_cross_kv` alike, so
the hoisted k/v equal the in-step projections.

Tensor parallelism (``unet_apply(..., shard=)``, a ``ops.sharding.ShardCtx``
with the weights ``parallel.tp.shard_bundle`` split): an attention site
whose heads divide by the model size runs K1 on the rank's heads (its
q/k/v column shards, the hoisted k/v too) and its ``to_out`` row shard,
then one all-reduce over the model group with the bias added once; a GEGLU
FF whose hidden width divides runs K2 on the rank's hidden shard (value and
gate columns in matching pairs) and one all-reduce with ``b2`` added once.
Each split site's input passes ``ShardCtx.enter`` (its gradient summed over
the model group) and its output ``ShardCtx.all_reduce``: Megatron's pair.
Sites that do not divide keep their weights whole and run every head. The
convs and GroupNorms stay replicated, unless ``conv_split`` (probe mode)
splits the convs' input channels (one all-reduce a conv, bias once). Under
a shard context the self-attention sites take the "bsc" route, as the JAX
package's ``ShardCtx`` replaces ``use_pallas="cm"``.

The up-path skip concat is virtual where the JAX package's gate admits it:
each output block that starts with a ResBlock gets the pair (h, skip), and
:func:`_apply_res` takes it without ``torch.cat`` where
``CPD_TPU_FUSE_SKIP_CAT`` (read at import, "0" turns it off) holds, the
ResBlock has a ``skip`` conv, the UNet batch is <= 4, the activations are
<= 16-bit (``ops.groupnorm.prefers_mm_stats``) and the two dtypes agree:
GroupNorm+SiLU through K3's two-source form, the in_conv and the 1x1 skip
conv as two convs over the channel-split weights, summed
(:func:`_apply_res_cat`). Elsewhere the pair is concatenated. Under a shard
context the pair takes the same gate, as the JAX package's ``shard_bundle``
UNet runs the same ``_apply_res`` under GSPMD: the two-source GroupNorm
replicated, the split convs replicated, or under ``conv_split`` each rank's
share of the virtual concat's input channels and one all-reduce a conv.
The 3x3 conv after a nearest 2x upsample ("up") takes the exact subpixel
form where ``layers.subpixel_up_wanted`` says.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.utils.weak

from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.ops import attention as mha
from complex_prompt_diffusion_tpu_torch.ops import geglu_ff, self_attention_cm, tome
from complex_prompt_diffusion_tpu_torch.ops import groupnorm as GN

# import-time flag, as the JAX package's: "0" concatenates every up-path
# skip; otherwise _apply_res takes the (h, skip) pair where its gate admits
_FUSE_SKIP_CAT = os.environ.get("CPD_TPU_FUSE_SKIP_CAT", "1") != "0"

__all__ = [
    "UNetConfig", "build_plan", "init_unet", "unet_apply", "precompute_cross_kv",
    "deepcache_default_block", "make_deepcache_unets", "skip_cat_fused",
]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: Any = 2  # int or per-level tuple
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    num_head_channels: int = -1
    transformer_depth: int = 1
    context_dim: Optional[int] = 768
    use_linear_in_transformer: bool = False
    use_scale_shift_norm: bool = False
    num_classes: Optional[int] = None
    dtype: str = "bfloat16"
    # Route of the self-attention sites: "bsc" (default) splits one fused
    # qkv projection in the [B, S, C] layout and calls ops.attention; "cm"
    # mirrors the JAX package's ``UNetConfig.use_pallas="cm"``: sites with
    # S > 128, S % 128 == 0 and C % 128 == 0 run the fused channel-major
    # block ``ops.self_attention_cm`` (K5), the others stay on "bsc".
    attn_route: str = "bsc"
    # Token reduction (ops/tome.py) at the self-attention sites with
    # S >= tome_min_seq (SD-1.5 512x512: level 0): "downsample" (ToDo: K/V
    # pooled over tome_sx x tome_sy, Q full; tome_ratio > 0 only switches it
    # on) or "merge" (ToMe-SD: tome_ratio * S tokens merged before the
    # attention, unmerged after; tome_mlp / tome_crossattn reuse the block's
    # plan for the FF and the cross-attention's queries)
    tome_ratio: float = 0.0
    tome_mode: str = "downsample"
    tome_min_seq: int = 4096
    tome_sx: int = 2
    tome_sy: int = 2
    tome_mlp: bool = False
    tome_crossattn: bool = False

    def __post_init__(self):
        if self.attn_route not in ("bsc", "cm"):
            raise ValueError(f"unknown attn_route {self.attn_route!r} (bsc|cm)")

    @staticmethod
    def sd15() -> "UNetConfig":
        """config-1.49.yaml (SD 1.4/1.5)."""
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        """v2-inference.yaml (SD 2.x): 64-channel heads, 1024-wide context,
        linear proj_in / proj_out."""
        return UNetConfig(
            num_heads=-1,
            num_head_channels=64,
            context_dim=1024,
            use_linear_in_transformer=True,
        )

    @staticmethod
    def sd_upscaler() -> "UNetConfig":
        """LatentUpscaleDiffusion (the x4 upscaler's config): 7-channel input
        (4 latent, the 3-channel low-resolution image), the noise level as
        a class label (``num_classes`` 1000), as the JAX package's preset.
        ``pipeline.upscale_latents`` passes no label, so on this preset the
        UNet raises, as the JAX package's does."""
        return dataclasses.replace(UNetConfig.sd21(), in_channels=7, num_classes=1000)

    @staticmethod
    def sd2_depth() -> "UNetConfig":
        """v2-midas-inference.yaml: depth2img, 5-channel latent input (the
        depth map concatenated; ``pipeline.depth2img``)."""
        return dataclasses.replace(UNetConfig.sd21(), in_channels=5)

    @staticmethod
    def sd_inpaint() -> "UNetConfig":
        """LatentInpaintDiffusion: 9-channel input (4 noisy latents, the
        mask, 4 masked-image latents; ``pipeline.inpaint``)."""
        return UNetConfig(in_channels=9)

    @staticmethod
    def tiny(context_dim: int = 32) -> "UNetConfig":
        """Small config for tests."""
        return UNetConfig(
            model_channels=32,
            num_res_blocks=1,
            attention_resolutions=(2, 1),
            channel_mult=(1, 2),
            num_heads=2,
            context_dim=context_dim,
        )

    @property
    def res_blocks_per_level(self) -> Tuple[int, ...]:
        if isinstance(self.num_res_blocks, int):
            return tuple([self.num_res_blocks] * len(self.channel_mult))
        return tuple(self.num_res_blocks)

    def heads_for(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head), reference unet.py legacy=False rule."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def build_plan(cfg: UNetConfig):
    """Static layer plan (a copy of the JAX package's ``build_plan``).

    Returns (input_blocks, middle_block, output_blocks); each block is a
    tuple of descriptors:
      ("conv_in",) | ("res", cin, cout, "none"|"up"|"down")
      | ("attn", ch, heads, dim_head, depth) | ("down", ch) | ("up", ch)
    """
    nrb = cfg.res_blocks_per_level
    input_blocks = [(("conv_in",),)]
    skip_chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(nrb[level]):
            block = [("res", ch, mult * cfg.model_channels, "none")]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                heads, dim_head = cfg.heads_for(ch)
                block.append(("attn", ch, heads, dim_head, cfg.transformer_depth))
            input_blocks.append(tuple(block))
            skip_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append((("down", ch),))
            skip_chans.append(ch)
            ds *= 2

    heads, dim_head = cfg.heads_for(ch)
    middle_block = (
        ("res", ch, ch, "none"),
        ("attn", ch, heads, dim_head, cfg.transformer_depth),
        ("res", ch, ch, "none"),
    )

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(nrb[level] + 1):
            ich = skip_chans.pop()
            block = [("res", ch + ich, cfg.model_channels * mult, "none")]
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                heads, dim_head = cfg.heads_for(ch)
                block.append(("attn", ch, heads, dim_head, cfg.transformer_depth))
            if level and i == nrb[level]:
                block.append(("up", ch))
                ds //= 2
            output_blocks.append(tuple(block))
    return tuple(input_blocks), middle_block, tuple(output_blocks)


# --------------------------------------------------------------------------
# init (JAX-package layout and distributions; convert.py makes it runnable)
# --------------------------------------------------------------------------


def _init_res(gen, cfg: UNetConfig, cin: int, cout: int, device):
    emb_dim = cfg.model_channels * 4
    emb_out = 2 * cout if cfg.use_scale_shift_norm else cout
    p = {
        "in_norm": L.init_group_norm(cin, device),
        "in_conv": L.init_conv(gen, cin, cout, 3, device=device),
        "emb": L.init_linear(gen, emb_dim, emb_out, device=device),
        "out_norm": L.init_group_norm(cout, device),
        "out_conv": L.init_conv(gen, cout, cout, 3, zero=True, device=device),
    }
    if cin != cout:
        p["skip"] = L.init_conv(gen, cin, cout, 1, device=device)
    return p


def _init_attn(gen, cfg: UNetConfig, ch, heads, dim_head, depth, device):
    inner = heads * dim_head
    ctx = cfg.context_dim if cfg.context_dim is not None else inner
    if cfg.use_linear_in_transformer:
        proj_in = L.init_linear(gen, ch, inner, device=device)
        proj_out = L.init_linear(gen, inner, ch, zero=True, device=device)
    else:
        proj_in = L.init_conv(gen, ch, inner, 1, device=device)
        proj_out = L.init_conv(gen, inner, ch, 1, zero=True, device=device)

    def lin(i, o, bias=True):
        return L.init_linear(gen, i, o, bias=bias, device=device)

    blocks = []
    for _ in range(depth):
        blocks.append(
            {
                "norm1": L.init_layer_norm(inner, device),
                "attn1": {
                    "to_q": lin(inner, inner, False),
                    "to_k": lin(inner, inner, False),
                    "to_v": lin(inner, inner, False),
                    "to_out": lin(inner, inner),
                },
                "norm2": L.init_layer_norm(inner, device),
                "attn2": {
                    "to_q": lin(inner, inner, False),
                    "to_k": lin(ctx, inner, False),
                    "to_v": lin(ctx, inner, False),
                    "to_out": lin(inner, inner),
                },
                "norm3": L.init_layer_norm(inner, device),
                "ff": {
                    "proj": lin(inner, inner * 4 * 2),
                    "out": lin(inner * 4, inner),
                },
            }
        )
    return {"norm": L.init_group_norm(ch, device), "proj_in": proj_in,
            "proj_out": proj_out, "blocks": blocks}


def _init_sublayer(gen, cfg: UNetConfig, desc, device):
    kind = desc[0]
    if kind == "conv_in":
        return L.init_conv(gen, cfg.in_channels, cfg.model_channels, 3, device=device)
    if kind == "res":
        return _init_res(gen, cfg, desc[1], desc[2], device)
    if kind == "attn":
        return _init_attn(gen, cfg, desc[1], desc[2], desc[3], desc[4], device)
    if kind in ("down", "up"):
        return L.init_conv(gen, desc[1], desc[1], 3, device=device)
    raise ValueError(kind)


def init_unet(gen, cfg: UNetConfig, device="cpu"):
    """Random UNet params in the JAX package's layout (f32). Zero-init
    output layers stay zero here, as in ``init_unet`` of the JAX package."""
    input_plan, middle_plan, output_plan = build_plan(cfg)
    emb_dim = cfg.model_channels * 4
    params = {
        "time_embed": {
            "lin1": L.init_linear(gen, cfg.model_channels, emb_dim, device=device),
            "lin2": L.init_linear(gen, emb_dim, emb_dim, device=device),
        },
        "input_blocks": [
            [_init_sublayer(gen, cfg, d, device) for d in block] for block in input_plan
        ],
        "middle_block": [_init_sublayer(gen, cfg, d, device) for d in middle_plan],
        "output_blocks": [
            [_init_sublayer(gen, cfg, d, device) for d in block] for block in output_plan
        ],
        "out": {
            "norm": L.init_group_norm(cfg.model_channels, device),
            "conv": L.init_conv(gen, cfg.model_channels, cfg.out_channels, 3,
                                zero=True, device=device),
        },
    }
    if cfg.num_classes:
        params["label_emb"] = {
            "embedding": torch.randn((cfg.num_classes, emb_dim), generator=gen,
                                     device=device)
        }
    return params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def skip_cat_fused(batch: int, dtype) -> bool:
    """Whether the up-path ResBlocks of a UNet call at UNet batch ``batch``
    in ``dtype`` take the (h, skip) pair without the concat: the flag, the
    batch and the dtype of :func:`_apply_res`'s gate (every up-path
    ResBlock of the configs has a skip conv and mode "none"). The launch
    counts of ``tools/kernel_cases`` read it."""
    return (_FUSE_SKIP_CAT and batch <= 4
            and GN.prefers_mm_stats(torch.empty((), dtype=dtype, device="meta")))


def _conv_one(p, x, stride: int = 1, up: bool = False):
    """``layers.conv2d`` of x, or with ``up`` of its nearest 2x upsample:
    the exact subpixel form where ``layers.subpixel_up_wanted`` says."""
    if not up:
        return L.conv2d(p, x, stride=stride)
    if L.subpixel_up_wanted(p["weight"].shape):
        return L.conv3x3_after_upsample2x(p, x)
    return L.conv2d(p, L.upsample_nearest2x(x))


def _conv(p, x, shard=None, stride: int = 1, up: bool = False):
    """:func:`_conv_one`, or under ``shard.conv_split`` with a weight that
    holds a Cin shard (narrower than x): the conv of this rank's channels of
    x, summed over the model group with the bias once."""
    w = p["weight"]
    if shard is None or not shard.conv_split or w.shape[1] == x.shape[-1]:
        return _conv_one(p, x, stride, up)
    cin = w.shape[1]
    r = shard.axis_rank(shard.model_axis)
    part = _conv_one({"weight": w, "bias": torch.zeros_like(p["bias"])},
                     shard.enter(x)[..., r * cin:(r + 1) * cin], stride, up)
    return shard.all_reduce(part, bias=p["bias"])


def _split_weight(p, ca: int):
    """The weight of conv params ``p`` cut at input channel ``ca`` (views:
    K4's Hopper bodies read them in place, cuDNN copies them into its
    operand layout at each call), and a zero bias."""
    w = p["weight"]
    return w[:, :ca], w[:, ca:], torch.zeros_like(p["bias"])


def _conv_split(p, a, b, shard=None):
    """conv(concat([a, b], -1)) as two convs over the weight split along its
    input channels, summed in the activations' dtype, the bias on a's: the
    concat never materializes (the JAX package's ``_conv_split``). Each goes
    through :func:`_conv` (K4 inside its gate, cuDNN outside). Under
    ``shard.conv_split`` with a weight that holds a Cin shard of the virtual
    concat: this rank's channels of a and of b by their columns of the
    shard, summed, one all-reduce with the bias once."""
    w = p["weight"]
    ca = a.shape[-1]
    if shard is not None and shard.conv_split and w.shape[1] != ca + b.shape[-1]:
        lo = shard.axis_rank(shard.model_axis) * w.shape[1]
        hi = lo + w.shape[1]
        zero = {"bias": torch.zeros_like(p["bias"])}
        part = None
        if lo < ca:
            part = L.conv2d({"weight": w[:, :min(hi, ca) - lo], **zero},
                            shard.enter(a)[..., lo:min(hi, ca)])
        if hi > ca:
            yb = L.conv2d({"weight": w[:, max(lo, ca) - lo:], **zero},
                          shard.enter(b)[..., max(lo, ca) - ca:hi - ca])
            part = yb if part is None else part + yb
        return shard.all_reduce(part, bias=p["bias"])
    wa, wb, zero = _split_weight(p, ca)
    return (_conv({"weight": wa, "bias": p["bias"]}, a, shard)
            + _conv({"weight": wb, "bias": zero}, b, shard))


def _apply_res(p, cfg: UNetConfig, h, emb, mode: str, shard=None):
    if isinstance(h, tuple):
        # the up path's (h, skip) pair: without the concat under the JAX
        # package's gate, letter for letter (its matmul-stats GN regime,
        # UNet batch <= 4)
        a, b = h
        if (mode == "none" and "skip" in p and a.dtype == b.dtype
                and skip_cat_fused(a.shape[0], a.dtype)):
            return _apply_res_cat(p, cfg, a, b, emb, shard)
        h = torch.cat([a, b], dim=-1)
    x = h
    hh = L.group_norm_silu_p(p["in_norm"], h)
    if mode == "up":
        hh = L.upsample_nearest2x(hh)
        x = L.upsample_nearest2x(x)
    elif mode == "down":
        hh = L.avg_pool2x(hh)
        x = L.avg_pool2x(x)
    hh = _conv(p["in_conv"], hh, shard)
    hh = _res_out(p, cfg, hh, emb, shard)
    if "skip" in p:
        x = _conv(p["skip"], x, shard)
    return x + hh


def _apply_res_cat(p, cfg: UNetConfig, a, b, emb, shard=None):
    """A ResBlock over the virtual ``concat([a, b], -1)`` (the up path's
    hidden state and skip) without the concat: GroupNorm+SiLU through K3's
    two-source form, the in_conv and the 1x1 skip conv split along their
    input channels (the JAX package's ``_apply_res_cat``)."""
    ya, yb = GN.group_norm_silu_cat(a, b, p["in_norm"]["scale"], p["in_norm"]["bias"])
    hh = _res_out(p, cfg, _conv_split(p["in_conv"], ya, yb, shard), emb, shard)
    return _conv_split(p["skip"], a, b, shard) + hh


def _res_out(p, cfg: UNetConfig, hh, emb, shard=None):
    """A ResBlock after its in_conv: the timestep embedding, the out norm
    (scale-shift or added), SiLU and the out conv."""
    emb_out = L.linear(p["emb"], L.silu(emb))[:, None, None, :]
    if cfg.use_scale_shift_norm:
        scale, shift = emb_out.chunk(2, dim=-1)
        hh = L.group_norm_p(p["out_norm"], hh) * (1 + scale) + shift
        hh = L.silu(hh)
    else:
        hh = hh + emb_out
        hh = L.group_norm_silu_p(p["out_norm"], hh)
    return _conv(p["out_conv"], hh, shard)


def _hyper(hp, z):
    """A hypernetwork module's residual MLP: z + linear2(linear1(z)) *
    multiplier."""
    out = L.linear(hp["linear2"], L.linear(hp["linear1"], z))
    return z + out * hp.get("multiplier", 1.0)


def _cross_kv(p, ctx):
    """Context k/v projections of one attention site, its hypernetwork
    transforms included (shared by the in-step path and
    precompute_cross_kv, so the hoisted cache equals the in-step
    projections): one fused [D, 2C] product where k and v share the
    context, else one product each."""
    ctx_k = _hyper(p["hyper_k"], ctx) if "hyper_k" in p else ctx
    ctx_v = _hyper(p["hyper_v"], ctx) if "hyper_v" in p else ctx
    if ctx_k is not ctx_v:
        return L.linear(p["to_k"], ctx_k), L.linear(p["to_v"], ctx_v)
    w = torch.cat([p["to_k"]["kernel"], p["to_v"]["kernel"]], dim=1)
    kv = L.linear({"kernel": w}, ctx)
    k, v = kv.chunk(2, dim=-1)
    return k, v


def precompute_cross_kv(cfg: UNetConfig, params, context):
    """Cross-attention k/v projections of every site, computed once per
    render (the prompt context is loop-invariant across steps). Returns a
    tuple of (k, v) pairs in plan order; pass it as ``cross_kv=``."""
    if context is None:
        raise ValueError("precompute_cross_kv requires a context")
    input_plan, middle_plan, output_plan = build_plan(cfg)
    ctx = context.to(cfg.compute_dtype)
    cache = []

    def walk(block_plan, block_params):
        for desc, p in zip(block_plan, block_params):
            if desc[0] == "attn":
                for blk in p["blocks"]:
                    cache.append(_cross_kv(blk["attn2"], ctx))

    for bp, pp in zip(input_plan, params["input_blocks"]):
        walk(bp, pp)
    walk(middle_plan, params["middle_block"])
    for bp, pp in zip(output_plan, params["output_blocks"]):
        walk(bp, pp)
    return tuple(cache)


def deepcache_default_block(cfg: UNetConfig) -> int:
    """Default DeepCache split: the first output block of the shallowest
    level (the last ``nrb[0] + 1`` output blocks run at full resolution), so
    a shallow pass keeps only the level-0 encoder and decoder blocks."""
    _, _, output_plan = build_plan(cfg)
    return len(output_plan) - (cfg.res_blocks_per_level[0] + 1)


def make_deepcache_unets(cfg: UNetConfig, params, block, *, cross_kv=None,
                         batch_chunk: int = -1, shard=None):
    """The DeepCache pair of UNet calls (the JAX package's, one source for
    both sampler families):

      * ``unet_full(x, t, ctx) -> (raw_out, deep)``: the full pass, with the
        feature entering output block ``block``;
      * ``unet_shallow(x, t, ctx, deep) -> raw_out``: only the blocks after
        the split, resumed from the carried feature.

    ``block=None`` is :func:`deepcache_default_block`; an index out of range
    raises ValueError here. ``cross_kv``: the full hoisted tuple (the
    shallow pass picks its sites). ``batch_chunk`` > 0 splits a wider batch
    into calls of at most that many (x, t, ctx, cross_kv and the deep
    feature sliced alike); <= 0 is one wide call. The output is the raw model output: a v-model's
    conversion stays with the caller. ``shard``: the tensor-parallel
    context of sharded ``params`` (:func:`unet_apply`)."""
    n_out = len(build_plan(cfg)[2])
    j0 = deepcache_default_block(cfg) if block is None else int(block)
    if not 0 <= j0 < n_out:
        raise ValueError(f"deepcache_block={j0} out of range (0..{n_out - 1})")

    def _kv_slice(sl):
        return None if cross_kv is None else tuple((k[sl], v[sl]) for k, v in cross_kv)

    def _slices(b):
        return [slice(lo, min(lo + batch_chunk, b)) for lo in range(0, b, batch_chunk)]

    def unet_full(x, t, ctx):
        b = x.shape[0]
        if batch_chunk > 0 and b > batch_chunk:
            outs, deeps = [], []
            for sl in _slices(b):
                o, d = unet_apply(cfg, params, x[sl], t[sl], ctx[sl], cross_kv=_kv_slice(sl),
                                  return_deep_at=j0, shard=shard)
                outs.append(o)
                deeps.append(d)
            return torch.cat(outs, dim=0), torch.cat(deeps, dim=0)
        return unet_apply(cfg, params, x, t, ctx, cross_kv=cross_kv, return_deep_at=j0,
                          shard=shard)

    def unet_shallow(x, t, ctx, deep):
        b = x.shape[0]
        if batch_chunk > 0 and b > batch_chunk:
            return torch.cat([
                unet_apply(cfg, params, x[sl], t[sl], ctx[sl], cross_kv=_kv_slice(sl),
                           deep_feature=deep[sl], deep_at=j0, shard=shard)
                for sl in _slices(b)], dim=0)
        return unet_apply(cfg, params, x, t, ctx, cross_kv=cross_kv, deep_feature=deep,
                          deep_at=j0, shard=shard)

    return unet_full, unet_shallow


def _kv_counts(cfg: UNetConfig):
    """Cross-attention k/v entries of each plan segment: (input blocks,
    middle, output blocks), to align a full ``precompute_cross_kv`` tuple
    with a shallow pass."""

    def n(block_plan):
        return sum(d[4] for d in block_plan if d[0] == "attn")

    input_plan, middle_plan, output_plan = build_plan(cfg)
    return [n(b) for b in input_plan], n(middle_plan), [n(b) for b in output_plan]


def _shallow_cross_kv(cfg: UNetConfig, cross_kv, deep_at: int):
    """The entries of a full cross_kv tuple a shallow pass reads: the
    executed input prefix and the executed output suffix."""
    kv_in, kv_mid, kv_out = _kv_counts(cfg)
    keep_in = len(kv_in) - deep_at
    a = sum(kv_in[:keep_in])
    b = sum(kv_in) + kv_mid + sum(kv_out[:deep_at])
    return tuple(cross_kv[:a]) + tuple(cross_kv[b:])


def _cross_attention(p, x, context, heads: int, kv=None, attn_route: str = "bsc",
                     collector=None, self_kv=None, shard=None):
    tp = shard is not None and shard.splits_heads(heads)
    if tp:
        # this rank's heads: its q/k/v column shards and to_out row shard
        heads //= shard.model_size
        x, context, self_kv = (None if a is None else shard.enter(a)
                               for a in (x, context, self_kv))
        if collector is not None:
            raise ValueError("collect_attn_maps needs every head's probabilities: a "
                             "tensor-parallel UNet holds a share of them")
    if shard is not None:
        attn_route = "bsc"  # the JAX ShardCtx replaces use_pallas="cm"
    if kv is not None and context is not None:
        q = L.linear(p["to_q"], x)
        k, v = kv
    elif context is None and self_kv is not None:
        # ToDo: Q from the full sequence, K/V from the pooled one (K1 with
        # Sq != Skv)
        q = L.linear(p["to_q"], x)
        k, v = _cross_kv(p, self_kv)
    elif context is None and "hyper_k" not in p and "hyper_v" not in p:
        s_len, c_dim = x.shape[1], x.shape[2]
        if attn_route == "cm" and s_len > 128 and s_len % 128 == 0 and c_dim % 128 == 0:
            # fused channel-major block: the qkv projection writes K5's
            # [3C, B, S] layout and the out-projection reads it back
            return self_attention_cm(
                x,
                p["to_q"]["kernel"], p["to_k"]["kernel"], p["to_v"]["kernel"],
                p["to_out"]["kernel"], p["to_out"]["bias"],
                heads,
            )
        # self-attention: one fused [C, 3C] projection; q/k/v stay strided
        # views of it (the attention kernel reads row strides)
        w = torch.cat(
            [p["to_q"]["kernel"], p["to_k"]["kernel"], p["to_v"]["kernel"]], dim=1
        )
        q, k, v = L.linear({"kernel": w}, x).chunk(3, dim=-1)
    else:
        # cross-attention, or self-attention with a hypernetwork on its k/v
        q = L.linear(p["to_q"], x)
        k, v = _cross_kv(p, x if context is None else context)
    if collector is not None and context is not None:
        # DAAM capture: the explicit softmax, so the per-token maps exist;
        # f32 [B, heads, HW, L] probabilities, the output through them
        b, sq, inner = q.shape
        d = inner // heads

        def split(z):
            return z.reshape(b, z.shape[1], heads, d).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        probs = torch.softmax(torch.matmul(qh.float(), kh.float().transpose(-1, -2))
                              * (d ** -0.5), dim=-1)
        collector.append(probs)
        out = torch.matmul(probs.to(vh.dtype), vh).transpose(1, 2).reshape(b, sq, inner)
    else:
        out = mha(q, k, v, heads)
    if tp:  # row-parallel: the local product, one all-reduce, the bias once
        return shard.all_reduce(torch.matmul(out, p["to_out"]["kernel"].to(out.dtype)),
                                bias=p["to_out"]["bias"])
    return L.linear(p["to_out"], out)


def _ff(ff, y, shard=None):
    """The GEGLU FF through K2; with a shard context whose model size
    divides the hidden width (4 C), K2 on this rank's hidden shard (its
    value and gate columns, the matching rows of ``out``), then one
    all-reduce with ``b2`` added once."""
    w1, b1, w2, b2 = (ff["proj"]["kernel"], ff["proj"]["bias"], ff["out"]["kernel"],
                      ff["out"]["bias"])
    if shard is None or not shard.splits_hidden(4 * y.shape[-1]):
        return geglu_ff(y, w1, b1, w2, b2)
    return shard.all_reduce(geglu_ff(shard.enter(y), w1, b1, w2, torch.zeros_like(b2)),
                            bias=b2)


def _tome_sites(cfg: UNetConfig, hh: int, ww: int):
    """(token reduction on at this site, ToMe's r): on where tome_ratio > 0,
    S >= tome_min_seq and the grid divides by the pool; r > 0 in merge
    mode only."""
    on = (cfg.tome_ratio > 0.0 and hh * ww >= cfg.tome_min_seq
          and hh % cfg.tome_sy == 0 and ww % cfg.tome_sx == 0)
    if on and cfg.tome_mode not in ("downsample", "merge"):
        raise ValueError(f"unknown tome_mode {cfg.tome_mode!r} (downsample|merge)")
    r = 0
    if on and cfg.tome_mode == "merge":
        n_dst = (hh // cfg.tome_sy) * (ww // cfg.tome_sx)
        r = min(int(cfg.tome_ratio * hh * ww), hh * ww - n_dst)
    return on, r


def _apply_attn(p, cfg: UNetConfig, h, context, heads, dim_head, kv_iter=None, collector=None,
                shard=None):
    n, hh_, ww_, c = h.shape
    inner = heads * dim_head
    x = L.group_norm_p(p["norm"], h, eps=1e-6)
    if cfg.use_linear_in_transformer:
        x = L.linear(p["proj_in"], x.reshape(n, hh_ * ww_, c))
    else:
        x = _conv(p["proj_in"], x, shard).reshape(n, hh_ * ww_, inner)
    tome_on, tome_r = _tome_sites(cfg, hh_, ww_)
    route = cfg.attn_route
    for blk in p["blocks"]:
        xa = L.layer_norm(blk["norm1"], x)
        plan = None
        if tome_on and cfg.tome_mode == "downsample":
            xkv = tome.downsample_kv(xa, hh_, ww_, cfg.tome_sx, cfg.tome_sy)
            x = x + _cross_attention(blk["attn1"], xa, None, heads, attn_route=route,
                                     self_kv=xkv, shard=shard)
        elif tome_r > 0:
            # one plan a block, from the block's input (ToMe-SD), reused by
            # the FF and cross-attention merges below
            plan = tome.build_merge(x, hh_, ww_, tome_r, cfg.tome_sx, cfg.tome_sy)
            out = _cross_attention(blk["attn1"], tome.tome_merge(plan, xa), None, heads,
                                   attn_route=route, shard=shard)
            x = x + tome.tome_unmerge(plan, out)
        else:
            x = x + _cross_attention(blk["attn1"], xa, None, heads, attn_route=route,
                                     shard=shard)
        kv = next(kv_iter) if (kv_iter is not None and context is not None) else None
        xc = L.layer_norm(blk["norm2"], x)
        if plan is not None and cfg.tome_crossattn and collector is None:
            out = _cross_attention(blk["attn2"], tome.tome_merge(plan, xc), context, heads,
                                   kv=kv, shard=shard)
            x = x + tome.tome_unmerge(plan, out)
        else:
            x = x + _cross_attention(blk["attn2"], xc, context, heads, kv=kv,
                                     collector=collector, shard=shard)
        y = L.layer_norm(blk["norm3"], x)
        if plan is not None and cfg.tome_mlp:
            x = x + tome.tome_unmerge(plan, _ff(blk["ff"], tome.tome_merge(plan, y), shard))
        else:
            x = x + _ff(blk["ff"], y, shard)
    if cfg.use_linear_in_transformer:
        x = L.linear(p["proj_out"], x).reshape(n, hh_, ww_, c)
    else:
        x = _conv(p["proj_out"], x.reshape(n, hh_, ww_, inner), shard)
    return x + h


def _apply_block(block_plan, block_params, cfg, h, emb, context, kv_iter=None, collector=None,
                 shard=None):
    for desc, p in zip(block_plan, block_params):
        kind = desc[0]
        if kind == "conv_in":
            h = _conv(p, h, shard)
        elif kind == "res":
            h = _apply_res(p, cfg, h, emb, desc[3], shard)
        elif kind == "attn":
            h = _apply_attn(p, cfg, h, context, desc[2], desc[3], kv_iter, collector, shard)
        elif kind == "down":
            h = _conv(p, h, shard, stride=2)
        elif kind == "up":
            h = _conv(p, h, shard, up=True)
        else:
            raise ValueError(kind)
    return h


def unet_apply(
    cfg: UNetConfig,
    params,
    x,
    timesteps,
    context,
    y=None,
    *,
    return_skips: bool = False,
    inject_skips=None,
    inject_skips_stop: int = 10,
    return_feats: bool = False,
    inject_feats=None,
    inject_feats_stop: int = 10,
    collect_attn_maps: bool = False,
    cross_kv=None,
    return_deep_at: Optional[int] = None,
    deep_feature=None,
    deep_at: Optional[int] = None,
    shard=None,
):
    """Predict eps (or v) for latents ``x`` [N,H,W,C] at ``timesteps`` [N]
    with ``context`` [N, L, D]; returns f32 [N,H,W,out_channels], followed
    by the extras asked for, in the JAX package's order:

      * ``return_skips``: the encoder skip tensor each output block pops, a
        tuple in output-block order; ``inject_skips`` replaces the skip of
        output block i < ``inject_skips_stop``;
      * ``return_feats``: each output block's output (the decoder hidden
        states), a tuple; ``inject_feats`` replaces the hidden state
        entering output block i < ``inject_feats_stop``;
      * ``collect_attn_maps``: the f32 cross-attention probabilities
        [B, heads, HW, L] of every cross-attention site (encoder, middle,
        decoder order), computed by an explicit softmax;
      * ``return_deep_at=j``: the hidden state entering output block j (the
        DeepCache feature).

    ``deep_feature=h, deep_at=j``: the DeepCache shallow pass: only the
    input blocks whose skips feed output blocks j.., no middle block, the
    output blocks from j on resumed from ``h``; fed the same call's deep
    feature it equals the full pass bit for bit. ``cross_kv``: the output
    of :func:`precompute_cross_kv` for this ``context`` (the full tuple,
    also for a shallow pass). The JAX package's ValueErrors: ``deep_feature``
    without ``deep_at``, ``deep_at`` out of range, the shallow pass with an
    aux interface, ``return_deep_at`` out of range.

    ``shard``: the ``ops.sharding.ShardCtx`` of ``params`` sharded by
    ``parallel.tp.shard_bundle`` (the module docstring says which sites
    split); every rank of the model group calls with the same inputs and
    gets the same output. Under it ``collect_attn_maps`` raises ValueError.
    """
    input_plan, middle_plan, output_plan = build_plan(cfg)
    dtype = cfg.compute_dtype
    shallow = deep_feature is not None
    if shallow:
        if deep_at is None:
            raise ValueError("deep_feature requires deep_at")
        if not 0 <= deep_at < len(output_plan):
            raise ValueError(f"deep_at={deep_at} out of range (0..{len(output_plan) - 1})")
        if (return_skips or return_feats or collect_attn_maps or inject_skips is not None
                or inject_feats is not None or return_deep_at is not None):
            raise ValueError("DeepCache shallow pass is incompatible with the aux "
                             "skip/feature/attn-map interfaces")
        if cross_kv is not None:
            cross_kv = _shallow_cross_kv(cfg, cross_kv, deep_at)

    t_emb = L.timestep_embedding(timesteps, cfg.model_channels)
    emb = L.linear(params["time_embed"]["lin1"], t_emb)
    emb = L.linear(params["time_embed"]["lin2"], L.silu(emb))
    if cfg.num_classes:
        if y is None:
            raise ValueError("class-conditional model requires y")
        emb = emb + params["label_emb"]["embedding"][y].float()
    emb = emb.to(dtype)

    h = x.to(dtype)
    if context is not None:
        context = context.to(dtype)
    collector = [] if collect_attn_maps else None
    kv_iter = iter(cross_kv) if cross_kv is not None else None

    keep_in = len(input_plan) - deep_at if shallow else len(input_plan)
    hs = []
    for block_plan, block_params in zip(input_plan[:keep_in], params["input_blocks"][:keep_in]):
        h = _apply_block(block_plan, block_params, cfg, h, emb, context, kv_iter, collector,
                         shard)
        hs.append(h)
    if shallow:
        h = deep_feature
        out_start = deep_at
    else:
        h = _apply_block(middle_plan, params["middle_block"], cfg, h, emb, context, kv_iter,
                         collector, shard)
        out_start = 0

    deep_out = None
    skips_out, feats_out = [], []
    for i in range(out_start, len(output_plan)):
        if return_deep_at is not None and i == return_deep_at:
            deep_out = h
        skip = hs.pop()
        if return_skips:
            skips_out.append(skip)
        if inject_skips is not None and i < inject_skips_stop:
            skip = inject_skips[i]
        if inject_feats is not None and i < inject_feats_stop:
            h = inject_feats[i]
        if output_plan[i][0][0] == "res":
            # the (h, skip) pair: _apply_res's gate decides between the
            # fused and the materialized concat
            h = (h, skip)
        else:
            h = torch.cat([h, skip], dim=-1)
        h = _apply_block(output_plan[i], params["output_blocks"][i], cfg, h, emb, context,
                         kv_iter, collector, shard)
        if return_feats:
            feats_out.append(h)

    h = L.group_norm_silu_p(params["out"]["norm"], h)
    out = _conv(params["out"]["conv"], h, shard).float()

    extras = []
    if return_skips:
        extras.append(tuple(skips_out))
    if return_feats:
        extras.append(tuple(feats_out))
    if collect_attn_maps:
        extras.append(tuple(collector))
    if return_deep_at is not None:
        if deep_out is None:
            raise ValueError(f"return_deep_at={return_deep_at} out of range "
                             f"(0..{len(output_plan) - 1})")
        extras.append(deep_out)
    if extras:
        return (out, *extras)
    return out
