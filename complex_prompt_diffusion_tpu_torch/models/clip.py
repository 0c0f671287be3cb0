"""CLIP text transformers (the SD-1.x and SD-2.x conditioning encoders).

Counterpart of ``complex_prompt_diffusion_tpu/models/clip.py``:
``clip_text_apply`` with the causal bias, layers "last" (SD 1.x) and
"penultimate" (SD 2.x). Sequence length is 77, so attention is a plain
matmul chain. The "hidden" and "pooled" outputs and the vision tower wait
for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from complex_prompt_diffusion_tpu_torch.models import layers as L

__all__ = ["CLIPTextConfig", "init_clip_text", "clip_text_apply"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    mlp_ratio: int = 4
    activation: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP-H)
    projection_dim: Optional[int] = None
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


def init_clip_text(gen, cfg: CLIPTextConfig, device="cpu"):
    """Random CLIP text params (JAX-package layout and distributions)."""
    d = cfg.hidden_size

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    params = {
        "token_embedding": normal((cfg.vocab_size, d), 0.02),
        "position_embedding": normal((cfg.max_length, d), 0.01),
        "layers": [],
        "final_ln": L.init_layer_norm(d, device),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "ln1": L.init_layer_norm(d, device),
                "q": L.init_linear(gen, d, d, device=device),
                "k": L.init_linear(gen, d, d, device=device),
                "v": L.init_linear(gen, d, d, device=device),
                "out": L.init_linear(gen, d, d, device=device),
                "ln2": L.init_layer_norm(d, device),
                "fc1": L.init_linear(gen, d, d * cfg.mlp_ratio, device=device),
                "fc2": L.init_linear(gen, d * cfg.mlp_ratio, d, device=device),
            }
        )
    return params


def _act(cfg: CLIPTextConfig, x):
    if cfg.activation == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return L.gelu(x)


def _attn(p, x, heads: int, causal_bias):
    n, s, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(n, s, heads, dh).transpose(1, 2)

    q = split(L.linear(p["q"], x))
    k = split(L.linear(p["k"], x))
    v = split(L.linear(p["v"], x))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh**-0.5)
    w = torch.softmax(scores + causal_bias, dim=-1).to(v.dtype)
    out = torch.matmul(w, v)
    out = out.transpose(1, 2).reshape(n, s, d)
    return L.linear(p["out"], out)


def clip_text_apply(
    cfg: CLIPTextConfig,
    params,
    tokens: torch.Tensor,
    *,
    layer: str = "last",
):
    """Encode token ids [N, 77] -> f32 [N, 77, D].

    ``layer``: "last" = final_ln(hidden_last); "penultimate" =
    final_ln(hidden_{L-1}).
    """
    if layer not in ("last", "penultimate"):
        raise NotImplementedError(f"clip layer {layer!r} is not ported yet")
    n, s = tokens.shape
    dtype = cfg.compute_dtype
    tokens = tokens.long()
    x = params["token_embedding"][tokens].to(dtype)
    x = x + params["position_embedding"][None, :s].to(dtype)

    causal_bias = torch.triu(
        torch.full((s, s), float("-inf"), device=x.device), diagonal=1
    )[None, None]

    stop = cfg.num_layers - 1 if layer == "penultimate" else cfg.num_layers
    for p in params["layers"][:stop]:
        x = x + _attn(p, L.layer_norm(p["ln1"], x), cfg.num_heads, causal_bias)
        h = L.linear(p["fc1"], L.layer_norm(p["ln2"], x))
        x = x + L.linear(p["fc2"], _act(cfg, h))
    return L.layer_norm(params["final_ln"], x).float()
