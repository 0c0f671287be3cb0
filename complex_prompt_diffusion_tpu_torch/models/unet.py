"""Stable Diffusion UNet as plain functions on tensors (exact path).

Counterpart of ``complex_prompt_diffusion_tpu/models/unet.py``: the same
static plan (:func:`build_plan`), the same parameter tree, NHWC activations,
compute in ``cfg.dtype`` with f32 norm statistics. Self-attention, the GEGLU
MLP and every GroupNorm go through the port's kernels (``ops``); with
``UNetConfig.attn_route == "cm"`` the self-attention sites the JAX gate
admits run the fused channel-major block (K5).

The up-path skip concat is a plain ``torch.cat``: the JAX package's split
GroupNorm+conv over a virtual concat is gated to its TPU matmul-stats GN
regime. ToMe, DeepCache, hypernetworks, attention-map collection and
skip/feature injection are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.ops import attention as mha
from complex_prompt_diffusion_tpu_torch.ops import geglu_ff, self_attention_cm

__all__ = ["UNetConfig", "build_plan", "init_unet", "unet_apply", "precompute_cross_kv"]


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


def _apply_res(p, cfg: UNetConfig, h, emb, mode: str):
    x = h
    hh = L.group_norm_silu_p(p["in_norm"], h)
    if mode == "up":
        hh = L.upsample_nearest2x(hh)
        x = L.upsample_nearest2x(x)
    elif mode == "down":
        hh = L.avg_pool2x(hh)
        x = L.avg_pool2x(x)
    hh = L.conv2d(p["in_conv"], hh)
    emb_out = L.linear(p["emb"], L.silu(emb))[:, None, None, :]
    if cfg.use_scale_shift_norm:
        scale, shift = emb_out.chunk(2, dim=-1)
        hh = L.group_norm_p(p["out_norm"], hh) * (1 + scale) + shift
        hh = L.silu(hh)
    else:
        hh = hh + emb_out
        hh = L.group_norm_silu_p(p["out_norm"], hh)
    hh = L.conv2d(p["out_conv"], hh)
    if "skip" in p:
        x = L.conv2d(p["skip"], x)
    return x + hh


def _cross_kv(p, ctx):
    """Context k/v projections of one cross-attention site as one fused
    [D, 2C] product (shared by the in-step path and precompute_cross_kv)."""
    if "hyper_k" in p or "hyper_v" in p:
        raise NotImplementedError("hypernetworks are not ported yet")
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


def _cross_attention(p, x, context, heads: int, kv=None, attn_route: str = "bsc"):
    if kv is not None and context is not None:
        q = L.linear(p["to_q"], x)
        k, v = kv
    elif context is None:
        if "hyper_k" in p or "hyper_v" in p:
            raise NotImplementedError("hypernetworks are not ported yet")
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
        q = L.linear(p["to_q"], x)
        k, v = _cross_kv(p, context)
    return L.linear(p["to_out"], mha(q, k, v, heads))


def _apply_attn(p, cfg: UNetConfig, h, context, heads, dim_head, kv_iter=None):
    n, hh_, ww_, c = h.shape
    inner = heads * dim_head
    x = L.group_norm_p(p["norm"], h, eps=1e-6)
    if cfg.use_linear_in_transformer:
        x = L.linear(p["proj_in"], x.reshape(n, hh_ * ww_, c))
    else:
        x = L.conv2d(p["proj_in"], x).reshape(n, hh_ * ww_, inner)
    for blk in p["blocks"]:
        xa = L.layer_norm(blk["norm1"], x)
        x = x + _cross_attention(blk["attn1"], xa, None, heads, attn_route=cfg.attn_route)
        kv = next(kv_iter) if (kv_iter is not None and context is not None) else None
        xc = L.layer_norm(blk["norm2"], x)
        x = x + _cross_attention(blk["attn2"], xc, context, heads, kv=kv)
        y = L.layer_norm(blk["norm3"], x)
        ff = blk["ff"]
        x = x + geglu_ff(
            y, ff["proj"]["kernel"], ff["proj"]["bias"],
            ff["out"]["kernel"], ff["out"]["bias"],
        )
    if cfg.use_linear_in_transformer:
        x = L.linear(p["proj_out"], x).reshape(n, hh_, ww_, c)
    else:
        x = L.conv2d(p["proj_out"], x.reshape(n, hh_, ww_, inner))
    return x + h


def _apply_block(block_plan, block_params, cfg, h, emb, context, kv_iter=None):
    for desc, p in zip(block_plan, block_params):
        kind = desc[0]
        if kind == "conv_in":
            h = L.conv2d(p, h)
        elif kind == "res":
            h = _apply_res(p, cfg, h, emb, desc[3])
        elif kind == "attn":
            h = _apply_attn(p, cfg, h, context, desc[2], desc[3], kv_iter)
        elif kind == "down":
            h = L.conv2d(p, h, stride=2)
        elif kind == "up":
            h = L.conv2d(p, L.upsample_nearest2x(h))
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
    cross_kv=None,
    return_skips: bool = False,
    inject_skips=None,
    return_feats: bool = False,
    inject_feats=None,
    collect_attn_maps: bool = False,
    return_deep_at: Optional[int] = None,
    deep_feature=None,
):
    """Predict eps (or v) for latents ``x`` [N,H,W,C] at ``timesteps`` [N]
    with ``context`` [N, L, D]; returns f32 [N,H,W,out_channels].

    ``cross_kv``: optional output of :func:`precompute_cross_kv` for this
    ``context``; the cross-attention k/v are then read from it. The
    skip/feature/attention-map interfaces and DeepCache are not ported yet.
    """
    unported = {
        "return_skips": return_skips, "inject_skips": inject_skips is not None,
        "return_feats": return_feats, "inject_feats": inject_feats is not None,
        "collect_attn_maps": collect_attn_maps,
        "return_deep_at": return_deep_at is not None,
        "deep_feature": deep_feature is not None,
    }
    used = [k for k, on in unported.items() if on]
    if used:
        raise NotImplementedError(f"unet_apply options not ported yet: {used}")
    input_plan, middle_plan, output_plan = build_plan(cfg)
    dtype = cfg.compute_dtype

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
    kv_iter = iter(cross_kv) if cross_kv is not None else None

    hs = []
    for block_plan, block_params in zip(input_plan, params["input_blocks"]):
        h = _apply_block(block_plan, block_params, cfg, h, emb, context, kv_iter)
        hs.append(h)
    h = _apply_block(middle_plan, params["middle_block"], cfg, h, emb, context, kv_iter)
    for block_plan, block_params in zip(output_plan, params["output_blocks"]):
        h = torch.cat([h, hs.pop()], dim=-1)
        h = _apply_block(block_plan, block_params, cfg, h, emb, context, kv_iter)

    h = L.group_norm_silu_p(params["out"]["norm"], h)
    return L.conv2d(params["out"]["conv"], h).float()
