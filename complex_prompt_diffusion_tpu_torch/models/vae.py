"""AutoencoderKL (the SD first stage), the VQ first stage and tiled
encode / decode, as plain functions on tensors.

Counterpart of ``complex_prompt_diffusion_tpu/models/vae.py``: the same
config, parameter tree, ``DiagonalGaussian``, ``vae_encode`` and
``vae_decode``. GroupNorm(32, eps=1e-6) everywhere, downsample = zero pad
(0,1,0,1) + stride-2 3x3 conv, upsample = nearest 2x + 3x3 conv, mid block =
ResnetBlock, single-head AttnBlock (through the K1 kernel at S = 4096 for
512^2 images), ResnetBlock. Both run in ``cfg.dtype`` (f32, or bf16 after
``ModelBundle.cast_vae``) and return f32.

The VQ first stage (``init_vq_model``, ``vq_encode``, ``vq_quantize``,
``vq_decode``) is the same encoder and decoder with ``double_z`` off and a
codebook between them (nearest code by |z|^2 - 2 z.e + |e|^2 in f32,
straight-through gradients). ``vae_decode_tiled`` / ``vae_encode_tiled``
run the decoder / encoder on overlapping tiles blended with a triangular
window, bounding activation memory on large canvases.

The 0.18215 latent scale factor is applied by callers, not here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.models import layers as L
from complex_prompt_diffusion_tpu_torch.ops import attention as mha

__all__ = ["VAEConfig", "DiagonalGaussian", "init_vae", "vae_encode", "vae_decode",
           "init_vq_quantizer", "vq_quantize", "init_vq_model", "vq_encode", "vq_decode",
           "vae_decode_tiled", "vae_encode_tiled"]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig from config-1.49.yaml (same for SD 1.x and 2.x)."""

    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    resolution: int = 512
    dtype: str = "float32"

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass
class DiagonalGaussian:
    """The encoder's posterior: moments are [mean | logvar] along channels,
    logvar clamped to [-30, 20]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @staticmethod
    def from_moments(moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return DiagonalGaussian(mean, torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` (same shape) is drawn from
        ``generator`` unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL divergence to the standard normal, summed over the three
        non-batch axes (H, W, C of the channels-last posterior): [B]."""
        return 0.5 * torch.sum(self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2, 3))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """Negative log-likelihood of ``sample`` under the posterior,
        summed over the three non-batch axes: [B]."""
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(
            logtwopi + self.logvar + (sample - self.mean) ** 2 / torch.exp(self.logvar),
            dim=(1, 2, 3))


def _init_resnet(gen, cin, cout, device):
    p = {
        "norm1": L.init_group_norm(cin, device),
        "conv1": L.init_conv(gen, cin, cout, 3, device=device),
        "norm2": L.init_group_norm(cout, device),
        "conv2": L.init_conv(gen, cout, cout, 3, device=device),
    }
    if cin != cout:
        p["nin_shortcut"] = L.init_conv(gen, cin, cout, 1, device=device)
    return p


def _init_attn(gen, ch, device):
    return {
        "norm": L.init_group_norm(ch, device),
        "q": L.init_conv(gen, ch, ch, 1, device=device),
        "k": L.init_conv(gen, ch, ch, 1, device=device),
        "v": L.init_conv(gen, ch, ch, 1, device=device),
        "proj_out": L.init_conv(gen, ch, ch, 1, device=device),
    }


def init_vae(gen, cfg: VAEConfig, device="cpu"):
    """Random params (encoder, decoder, quant_conv, post_quant_conv) in the
    JAX package's layout and distributions."""
    enc = {"conv_in": L.init_conv(gen, cfg.in_channels, cfg.ch, 3, device=device), "down": []}
    ch = cfg.ch
    res = cfg.resolution
    for level, mult in enumerate(cfg.ch_mult):
        blocks, attns = [], []
        cout = cfg.ch * mult
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resnet(gen, ch, cout, device))
            ch = cout
            if res in cfg.attn_resolutions:
                attns.append(_init_attn(gen, ch, device))
        down = {"block": blocks, "attn": attns}
        if level != len(cfg.ch_mult) - 1:
            down["downsample"] = L.init_conv(gen, ch, ch, 3, device=device)
            res //= 2
        enc["down"].append(down)
    enc["mid"] = {
        "block_1": _init_resnet(gen, ch, ch, device),
        "attn_1": _init_attn(gen, ch, device),
        "block_2": _init_resnet(gen, ch, ch, device),
    }
    z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    enc["norm_out"] = L.init_group_norm(ch, device)
    enc["conv_out"] = L.init_conv(gen, ch, z_out, 3, device=device)

    dec = {"conv_in": L.init_conv(gen, cfg.z_channels, ch, 3, device=device)}
    dec["mid"] = {
        "block_1": _init_resnet(gen, ch, ch, device),
        "attn_1": _init_attn(gen, ch, device),
        "block_2": _init_resnet(gen, ch, ch, device),
    }
    dec["up"] = []
    for level, mult in reversed(list(enumerate(cfg.ch_mult))):
        blocks, attns = [], []
        cout = cfg.ch * mult
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_init_resnet(gen, ch, cout, device))
            ch = cout
            if res in cfg.attn_resolutions:
                attns.append(_init_attn(gen, ch, device))
        up = {"block": blocks, "attn": attns}
        if level != 0:
            up["upsample"] = L.init_conv(gen, ch, ch, 3, device=device)
            res *= 2
        dec["up"].insert(0, up)  # stored in ascending order like the torch code
    dec["norm_out"] = L.init_group_norm(ch, device)
    dec["conv_out"] = L.init_conv(gen, ch, cfg.out_channels, 3, device=device)
    moments = 2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": L.init_conv(gen, z_out, moments, 1, device=device),
        "post_quant_conv": L.init_conv(gen, cfg.embed_dim, cfg.z_channels, 1,
                                       device=device),
    }


def _resnet(p, x):
    h = L.group_norm_silu_p(p["norm1"], x, eps=1e-6)
    h = L.conv2d(p["conv1"], h)
    h = L.group_norm_silu_p(p["norm2"], h, eps=1e-6)
    h = L.conv2d(p["conv2"], h)
    if "nin_shortcut" in p:
        x = L.conv2d(p["nin_shortcut"], x)
    return x + h


def _attn_block(p, x):
    n, h, w, c = x.shape
    y = L.group_norm_p(p["norm"], x, eps=1e-6)
    q = L.conv2d(p["q"], y).reshape(n, h * w, c)
    k = L.conv2d(p["k"], y).reshape(n, h * w, c)
    v = L.conv2d(p["v"], y).reshape(n, h * w, c)
    out = mha(q, k, v, 1)  # single head
    out = L.conv2d(p["proj_out"], out.reshape(n, h, w, c))
    return x + out


def _downsample(p, x):
    x = F.pad(x, (0, 0, 0, 1, 0, 1))  # torch pad (0,1,0,1) on H and W
    return L.conv2d(p, x, stride=2, padding=0)


def _encoder(cfg: VAEConfig, params, x):
    """The encoder trunk and quant_conv: image [N,H,W,3] -> f32 [N,H/8,W/8,
    moments]."""
    x = x.to(cfg.compute_dtype)
    p = params["encoder"]
    h = L.conv2d(p["conv_in"], x)
    for down in p["down"]:
        for i, blk in enumerate(down["block"]):
            h = _resnet(blk, h)
            if down["attn"]:
                h = _attn_block(down["attn"][i], h)
        if "downsample" in down:
            h = _downsample(down["downsample"], h)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    h = L.group_norm_silu_p(p["norm_out"], h, eps=1e-6)
    h = L.conv2d(p["conv_out"], h)
    return L.conv2d(params["quant_conv"], h).float()


def vae_encode(cfg: VAEConfig, params, x) -> DiagonalGaussian:
    """Image [N,H,W,3] in [-1,1] -> posterior over latents [N,H/8,W/8,z]
    (f32 moments)."""
    return DiagonalGaussian.from_moments(_encoder(cfg, params, x))


def vae_decode(cfg: VAEConfig, params, z):
    """Latents [N,h,w,z] (unscaled) -> f32 image [N,8h,8w,3] in [-1,1]."""
    z = z.to(cfg.compute_dtype)
    z = L.conv2d(params["post_quant_conv"], z)
    p = params["decoder"]
    h = L.conv2d(p["conv_in"], z)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    for level in reversed(range(len(p["up"]))):
        up = p["up"][level]
        for i, blk in enumerate(up["block"]):
            h = _resnet(blk, h)
            if up["attn"]:
                h = _attn_block(up["attn"][i], h)
        if "upsample" in up:
            if L.subpixel_up_wanted(up["upsample"]["weight"].shape):
                # the exact subpixel form, 2.25x fewer flops (models/layers.py)
                h = L.conv3x3_after_upsample2x(up["upsample"], h)
            else:
                h = L.conv2d(up["upsample"], L.upsample_nearest2x(h))
    h = L.group_norm_silu_p(p["norm_out"], h, eps=1e-6)
    return L.conv2d(p["conv_out"], h).float()


# ---------------------------------------------------------------------------
# VQModel (the VQ first stage)
# ---------------------------------------------------------------------------


def init_vq_quantizer(gen, n_embed: int, embed_dim: int, device="cpu"):
    """The codebook {"embedding": [n_embed, embed_dim]}, uniform(-1/n, 1/n)
    f32."""
    bound = 1.0 / n_embed
    emb = torch.empty((n_embed, embed_dim), dtype=torch.float32, device=device)
    return {"embedding": emb.uniform_(-bound, bound, generator=gen)}


def vq_quantize(params, z, beta: float = 0.25):
    """Nearest-codebook quantization with straight-through gradients:
    z [N, h, w, C] -> (z_q, loss, indices [N, h, w]). The distance is
    |z|^2 - 2 z e^T + |e|^2 in f32 (the first code wins a tie); loss = beta
    mean((sg(z_q) - z)^2) + mean((z_q - sg(z))^2); z_q = z + sg(z_q - z)."""
    emb = params["embedding"].float()
    z = z.float()
    flat = z.reshape(-1, z.shape[-1])
    d = ((flat**2).sum(dim=1, keepdim=True) - 2.0 * (flat @ emb.T)
         + (emb**2).sum(dim=1)[None])
    idx = torch.argmin(d, dim=1)
    z_q = emb[idx].reshape(z.shape)
    loss = beta * torch.mean((z_q.detach() - z) ** 2) + torch.mean((z_q - z.detach()) ** 2)
    z_q = z + (z_q - z).detach()
    return z_q, loss, idx.reshape(z.shape[:-1])


def init_vq_model(gen, cfg: VAEConfig, n_embed: int = 16384, device="cpu"):
    """Random VQModel params in the JAX package's layout: the autoencoder of
    ``cfg`` with ``double_z`` off, quant_conv z_channels -> embed_dim,
    post_quant_conv back, and the codebook ``quantize``."""
    params = init_vae(gen, dataclasses.replace(cfg, double_z=False), device)
    params["quant_conv"] = L.init_conv(gen, cfg.z_channels, cfg.embed_dim, 1, device=device)
    params["post_quant_conv"] = L.init_conv(gen, cfg.embed_dim, cfg.z_channels, 1, device=device)
    params["quantize"] = init_vq_quantizer(gen, n_embed, cfg.embed_dim, device)
    return params


def vq_encode(cfg: VAEConfig, params, x, quantize: bool = True):
    """Encoder -> quant_conv (f32), then :func:`vq_quantize` with the
    params' codebook: (z_q, loss, indices); the pre-quantization latents
    when ``quantize`` is False."""
    h = _encoder(cfg, params, x)
    return vq_quantize(params["quantize"], h) if quantize else h


def vq_decode(cfg: VAEConfig, params, z_q):
    """The decoder on quantized latents (:func:`vae_decode`)."""
    return vae_decode(cfg, params, z_q)


# ---------------------------------------------------------------------------
# Tiled encode / decode for large canvases
# ---------------------------------------------------------------------------


def _tile_weights(th: int, tw: int, device="cpu") -> torch.Tensor:
    """The blending window [1, th, tw, 1] f32: the outer product of 0..1..0
    triangles over the tile, clipped to [0.01, 0.5]."""
    def ramp(n):
        x = (np.arange(n) + 0.5) / n
        return np.minimum(x, 1.0 - x) * 2.0

    w = np.clip(np.outer(ramp(th), ramp(tw)), 0.01, 0.5)
    return torch.as_tensor(w[None, :, :, None], dtype=torch.float32, device=device)


def _tile_starts(n: int, tile: int, stride: int) -> list:
    return sorted({min(y, max(n - tile, 0)) for y in range(0, n, stride)})


def vae_decode_tiled(cfg: VAEConfig, params, z, tile: int = 64, overlap: int = 16):
    """:func:`vae_decode` of latents [N, h, w, z] on ``tile`` x ``tile``
    latent tiles every ``tile - overlap`` (the last tile flush with the
    edge), each decoded on its own and blended by :func:`_tile_weights`
    (weighted sum over the weights' sum). Latents no larger than a tile are
    decoded whole. f32 [N, 8h, 8w, 3]."""
    n, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return vae_decode(cfg, params, z)
    up = 2 ** (len(cfg.ch_mult) - 1)
    stride = tile - overlap
    out = torch.zeros((n, h * up, w * up, cfg.out_channels), dtype=torch.float32,
                      device=z.device)
    acc = torch.zeros((n, h * up, w * up, 1), dtype=torch.float32, device=z.device)
    for y0 in _tile_starts(h, tile, stride):
        for x0 in _tile_starts(w, tile, stride):
            th, tw = min(tile, h - y0), min(tile, w - x0)
            dec = vae_decode(cfg, params, z[:, y0:y0 + th, x0:x0 + tw])
            wgt = _tile_weights(th * up, tw * up, z.device)
            rows, cols = slice(y0 * up, (y0 + th) * up), slice(x0 * up, (x0 + tw) * up)
            out[:, rows, cols] += dec * wgt
            acc[:, rows, cols] += wgt
    return out / torch.clamp(acc, min=1e-8)


def vae_encode_tiled(cfg: VAEConfig, params, x, tile: int = 512, overlap: int = 128):
    """:func:`vae_encode` on ``tile`` x ``tile`` image tiles every ``tile -
    overlap``, the posterior means blended as :func:`vae_decode_tiled`
    blends; returns ``DiagonalGaussian(mean, logvar = -30)`` (blending the
    tiles' draws would decorrelate their noise). An image no larger than a
    tile is encoded whole."""
    n, h, w, _ = x.shape
    if h <= tile and w <= tile:
        return vae_encode(cfg, params, x)
    down = 2 ** (len(cfg.ch_mult) - 1)
    stride = tile - overlap
    out = torch.zeros((n, h // down, w // down, cfg.embed_dim), dtype=torch.float32,
                      device=x.device)
    acc = torch.zeros((n, h // down, w // down, 1), dtype=torch.float32, device=x.device)
    for y0 in _tile_starts(h, tile, stride):
        for x0 in _tile_starts(w, tile, stride):
            th, tw = min(tile, h - y0), min(tile, w - x0)
            mean = vae_encode(cfg, params, x[:, y0:y0 + th, x0:x0 + tw]).mean
            ly, lx, lh, lw = y0 // down, x0 // down, th // down, tw // down
            wgt = _tile_weights(lh, lw, x.device)
            out[:, ly:ly + lh, lx:lx + lw] += mean * wgt
            acc[:, ly:ly + lh, lx:lx + lw] += wgt
    mean = out / torch.clamp(acc, min=1e-8)
    return DiagonalGaussian(mean, torch.full_like(mean, -30.0))
