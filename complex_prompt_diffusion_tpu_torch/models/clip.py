"""CLIP towers: the text transformers (the SD-1.x and SD-2.x conditioning
encoders, the guide CLIP's text head) and the guide CLIP's vision tower.

Counterpart of ``complex_prompt_diffusion_tpu/models/clip.py``:
``clip_text_apply`` with the causal bias and every layer the JAX package
has: "last" (SD 1.x), "penultimate" (SD 2.x), "hidden" (a raw hidden
state, no final LN) and "pooled" (the EOT row through ``text_projection``,
L2-normalised); ``clip_vision_apply`` is the ViT image encoder that CLIP
guidance differentiates through (``guidance/clip_guidance.py``). Sequences
are short (77 tokens, 50 or 257 patches), so attention in both towers is a
plain matmul chain, as the JAX package's einsums are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.models import layers as L

__all__ = [
    "CLIPTextConfig",
    "init_clip_text",
    "clip_text_apply",
    "CLIPVisionConfig",
    "init_clip_vision",
    "clip_vision_apply",
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
]

# CLIP's image preprocessing constants
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    mlp_ratio: int = 4
    activation: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP-H)
    projection_dim: Optional[int] = None  # text_projection of the guide CLIP
    dtype: str = "float32"

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """CLIP ViT-L/14 text tower (openai/clip-vit-large-patch14)."""
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        """OpenCLIP ViT-H/14 text tower (laion2b_s32b_b79k), SD 2.x."""
        return CLIPTextConfig(
            hidden_size=1024, num_layers=24, num_heads=16, activation="gelu"
        )

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4
        )

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _init_layers(gen, d: int, mlp_ratio: int, n: int, device):
    return [
        {
            "ln1": L.init_layer_norm(d, device),
            "q": L.init_linear(gen, d, d, device=device),
            "k": L.init_linear(gen, d, d, device=device),
            "v": L.init_linear(gen, d, d, device=device),
            "out": L.init_linear(gen, d, d, device=device),
            "ln2": L.init_layer_norm(d, device),
            "fc1": L.init_linear(gen, d, d * mlp_ratio, device=device),
            "fc2": L.init_linear(gen, d * mlp_ratio, d, device=device),
        }
        for _ in range(n)
    ]


def init_clip_text(gen, cfg: CLIPTextConfig, device="cpu"):
    """Random CLIP text params (JAX-package layout and distributions), with
    ``text_projection`` when ``cfg.projection_dim`` is set."""
    d = cfg.hidden_size

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    params = {
        "token_embedding": normal((cfg.vocab_size, d), 0.02),
        "position_embedding": normal((cfg.max_length, d), 0.01),
        "layers": _init_layers(gen, d, cfg.mlp_ratio, cfg.num_layers, device),
        "final_ln": L.init_layer_norm(d, device),
    }
    if cfg.projection_dim:
        params["text_projection"] = L.init_linear(gen, d, cfg.projection_dim, bias=False,
                                                  device=device)
    return params


def _act(cfg, x):
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return L.gelu(x)


def _attn(p, x, heads: int, bias):
    n, s, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(n, s, heads, dh).transpose(1, 2)

    q = split(L.linear(p["q"], x))
    k = split(L.linear(p["k"], x))
    v = split(L.linear(p["v"], x))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh**-0.5)
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.matmul(w, v)
    out = out.transpose(1, 2).reshape(n, s, d)
    return L.linear(p["out"], out)


def _encoder(cfg, x, bias, layers):
    """The pre-LN transformer layers ``layers`` over x [N, S, D]."""
    for p in layers:
        x = x + _attn(p, L.layer_norm(p["ln1"], x), cfg.num_heads, bias)
        h = L.linear(p["fc1"], L.layer_norm(p["ln2"], x))
        x = x + L.linear(p["fc2"], _act(cfg, h))
    return x


def clip_text_apply(
    cfg: CLIPTextConfig,
    params,
    tokens: torch.Tensor,
    *,
    layer: str = "last",
    layer_idx: Optional[int] = None,
):
    """Encode token ids [N, 77].

    ``layer``:
      * "last"        -- final_ln(hidden_last), f32 [N, 77, D];
      * "penultimate" -- final_ln(hidden_{L-1}) (SD 2.x);
      * "hidden"      -- the raw hidden_{layer_idx}, no final LN (HF's
                         hidden_states); without ``layer_idx`` ValueError;
      * "pooled"      -- the EOT row (the argmax of the ids), through
                         ``text_projection`` when the params have it,
                         L2-normalised: [N, P] (the guide CLIP's text head).
    Any other name encodes as "last", as in the JAX package.
    """
    n, s = tokens.shape
    dtype = cfg.compute_dtype
    tokens = tokens.long()
    x = params["token_embedding"][tokens].to(dtype)
    x = x + params["position_embedding"][None, :s].to(dtype)

    causal_bias = torch.triu(
        torch.full((s, s), float("-inf"), device=x.device), diagonal=1
    )[None, None]

    if layer == "penultimate":
        stop = cfg.num_layers - 1
    elif layer == "hidden":
        if layer_idx is None:
            raise ValueError("layer='hidden' requires layer_idx")
        stop = layer_idx
    else:
        stop = cfg.num_layers
    x = _encoder(cfg, x, causal_bias, params["layers"][:stop])
    if layer != "hidden":  # HF's hidden states are taken before the final LN
        x = L.layer_norm(params["final_ln"], x)
    if layer == "pooled":
        eot = torch.argmax(tokens, dim=-1)  # EOT has the highest token id
        pooled = x[torch.arange(n, device=x.device), eot]
        if "text_projection" in params:
            pooled = L.linear(params["text_projection"], pooled)
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return x.float()


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 512
    activation: str = "quick_gelu"
    dtype: str = "float32"

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        """openai/clip-vit-base-patch32: the 512-dim guide CLIP."""
        return CLIPVisionConfig()

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14: 768-dim, SD-1.5's text width."""
        return CLIPVisionConfig(
            patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
            projection_dim=768,
        )

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, projection_dim=32,
        )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_clip_vision(gen, cfg: CLIPVisionConfig, device="cpu"):
    """Random vision-tower params in the JAX package's layout (the patch
    embedding an HWIO kernel [p, p, 3, D]) and distributions;
    ``convert.clip_vision_params`` gives the port's layout."""
    d = cfg.hidden_size

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    return {
        "class_embedding": normal((d,), 0.02),
        "patch_embedding": normal((cfg.patch_size, cfg.patch_size, 3, d), 0.02),
        "position_embedding": normal((cfg.num_patches + 1, d), 0.01),
        "pre_ln": L.init_layer_norm(d, device),
        "layers": _init_layers(gen, d, cfg.mlp_ratio, cfg.num_layers, device),
        "post_ln": L.init_layer_norm(d, device),
        "visual_projection": L.init_linear(gen, d, cfg.projection_dim, bias=False,
                                           device=device),
    }


def clip_vision_apply(cfg: CLIPVisionConfig, params, images: torch.Tensor, *,
                      project: bool = True) -> torch.Tensor:
    """Encode images [N, H, W, 3] (normalised with CLIP_IMAGE_MEAN / STD)
    into pooled embeddings [N, projection_dim] (``post_ln`` of the class
    token, through ``visual_projection`` when ``project`` and the params
    have it; else [N, D]). The patch embedding is a stride-``patch_size``
    conv with the port's [D, 3, p, p] weight. Differentiable: CLIP guidance
    takes its gradient with respect to the images."""
    n = images.shape[0]
    dtype = cfg.compute_dtype
    d = cfg.hidden_size
    x = F.conv2d(images.to(dtype).permute(0, 3, 1, 2), params["patch_embedding"].to(dtype),
                 stride=cfg.patch_size)
    x = x.flatten(2).transpose(1, 2)  # [N, patches, D], row-major over the grid
    cls = params["class_embedding"].to(dtype).expand(n, 1, d)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"][None].to(dtype)
    x = L.layer_norm(params["pre_ln"], x)
    x = _encoder(cfg, x, 0.0, params["layers"])
    pooled = L.layer_norm(params["post_ln"], x[:, 0])
    if project and "visual_projection" in params:
        pooled = L.linear(params["visual_projection"], pooled)
    return pooled
