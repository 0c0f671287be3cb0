"""Further text encoders: the T5 v1.1 encoder and a generic transformer.

Counterpart of ``complex_prompt_diffusion_tpu/models/embedders.py``, plain
PyTorch on tensors (the JAX package runs them on no Pallas kernel):

  * T5 (:class:`T5Config`, :func:`t5_encode`): RMSNorm, attention with no
    1/sqrt(d) scaling and a relative-position bias that layer 0's table
    gives every layer, a gated-GELU MLP, no absolute positions. Its
    attention is the JAX package's einsum, not the attention kernel: the
    bias and the missing scale do not fit K1's signature, and the sequence
    is short.
  * :class:`TransformerTextConfig` / :func:`transformer_text_apply`: the
    BERT-style encoder (learned positions, pre-LN blocks, GELU MLP) with
    every opt-in flag of the JAX config (causal mask, talking heads, RMS-
    or ScaleNorm, the bucketed relative bias, macaron, sandwich, GRU-gated
    residuals, ReZero).
  * :func:`clip_t5_encode`: both encodings of a CLIP + T5 pair.

Parameter trees have the JAX package's layout (linears ``{kernel: [in,
out]}``; norms ``{scale, bias}`` or a bare ``[d]`` scale for T5; a GRU gate
in torch's ``GRUCell`` layout); ``convert.embedder_params`` brings a JAX
tree across, :func:`convert_t5_hf` reads an HF ``T5EncoderModel`` state dict.
No entry point of either package calls these encoders.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.models import layers as L

__all__ = [
    "T5Config",
    "init_t5_encoder",
    "t5_encode",
    "convert_t5_hf",
    "relative_position_bucket",
    "TransformerTextConfig",
    "init_transformer_text",
    "transformer_text_apply",
    "clip_t5_encode",
]


# --------------------------------------------------------------------------
# T5 v1.1 encoder
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    num_heads: int = 16
    d_ff: int = 2816
    num_layers: int = 24
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"

    @staticmethod
    def v1_1_large() -> "T5Config":
        """google/t5-v1_1-large."""
        return T5Config()

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=1000, d_model=64, d_kv=16, num_heads=4, d_ff=128,
                        num_layers=2)


def _rms_norm(scale, x, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def relative_position_bucket(relative_position, num_buckets: int = 32, max_distance: int = 128,
                             bidirectional: bool = True) -> np.ndarray:
    """T5's relative position buckets of the integer array
    ``relative_position`` (memory - query), on the host in numpy."""
    relative_position = np.asarray(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = (relative_position > 0).astype(np.int64) * num_buckets
        n = np.abs(relative_position)
    else:
        ret = np.zeros_like(relative_position, dtype=np.int64)
        n = np.maximum(-relative_position, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n / max_exact + 1e-9) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, device=device) * std


def init_t5_encoder(gen, cfg: T5Config, device="cpu"):
    """Random T5 encoder params (the JAX package's layout and
    distributions) from the ``torch.Generator`` ``gen``."""
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

    def lin(i, o):
        return L.init_linear(gen, i, o, bias=False, device=device)

    return {
        "token_embedding": _normal(gen, (cfg.vocab_size, d), 1.0, device),
        "relative_bias": _normal(gen, (cfg.relative_buckets, cfg.num_heads), 0.1, device),
        "layers": [
            {"ln1": torch.ones(d, device=device), "q": lin(d, inner), "k": lin(d, inner),
             "v": lin(d, inner), "o": lin(inner, d), "ln2": torch.ones(d, device=device),
             "wi_0": lin(d, cfg.d_ff), "wi_1": lin(d, cfg.d_ff), "wo": lin(cfg.d_ff, d)}
            for _ in range(cfg.num_layers)
        ],
        "final_ln": torch.ones(d, device=device),
    }


def _split_heads(z, heads):
    n, s, inner = z.shape
    return z.reshape(n, s, heads, inner // heads).transpose(1, 2)


def _merge_heads(z):
    n, h, s, d = z.shape
    return z.transpose(1, 2).reshape(n, s, h * d)


def t5_encode(cfg: T5Config, params, tokens: torch.Tensor) -> torch.Tensor:
    """Encode token ids [N, L] -> f32 [N, L, d_model] (the last hidden
    state after the final RMSNorm)."""
    n, s = tokens.shape
    dtype = getattr(torch, cfg.dtype)
    table = params["token_embedding"]
    x = table[tokens.long().to(table.device)].to(dtype)
    pos = np.arange(s)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None], cfg.relative_buckets,
                                       cfg.relative_max_distance)
    bias = params["relative_bias"][torch.from_numpy(buckets).to(x.device)]  # [L, L, H]
    bias = bias.permute(2, 0, 1)[None].float()  # [1, H, L, L]
    eps = cfg.layer_norm_eps
    for p in params["layers"]:
        y = _rms_norm(p["ln1"], x, eps)
        q, k, v = (_split_heads(L.linear(p[name], y), cfg.num_heads) for name in "qkv")
        # T5: no 1/sqrt(d) scaling
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + bias
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        att = _merge_heads(torch.einsum("bhqk,bhkd->bhqd", w, v))
        x = x + L.linear(p["o"], att)
        y = _rms_norm(p["ln2"], x, eps)
        x = x + L.linear(p["wo"], L.gelu(L.linear(p["wi_0"], y)) * L.linear(p["wi_1"], y))
    return _rms_norm(params["final_ln"], x, eps).float()


def convert_t5_hf(cfg: T5Config, sd, prefix: str = "encoder.") -> dict:
    """An HF ``T5EncoderModel`` state dict (numpy arrays or tensors) as the
    T5 tree: the linears' ``[out, in]`` weights transposed to kernels, the
    token table from ``shared.weight`` (else ``{prefix}embed_tokens``)."""
    token = sd["shared.weight"] if "shared.weight" in sd else sd[f"{prefix}embed_tokens.weight"]
    params = {
        "token_embedding": token,
        "relative_bias": sd[f"{prefix}block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "layers": [],
        "final_ln": sd[f"{prefix}final_layer_norm.weight"],
    }
    for i in range(cfg.num_layers):
        b = f"{prefix}block.{i}.layer"
        layer = {"ln1": sd[f"{b}.0.layer_norm.weight"], "ln2": sd[f"{b}.1.layer_norm.weight"]}
        for n in ("q", "k", "v", "o"):
            layer[n] = {"kernel": sd[f"{b}.0.SelfAttention.{n}.weight"].T}
        for n in ("wi_0", "wi_1", "wo"):
            layer[n] = {"kernel": sd[f"{b}.1.DenseReluDense.{n}.weight"].T}
        params["layers"].append(layer)
    return params


# --------------------------------------------------------------------------
# Generic transformer text encoder (BERTEmbedder / x-transformers slot)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformerTextConfig:
    """BERTEmbedder's defaults (n_embed 1280, 32 layers, vocab 30522, 77
    tokens) and the opt-in flags of the JAX config: ``causal``,
    ``talking_heads`` (head mixing before and after the softmax),
    ``use_rmsnorm`` / ``use_scalenorm``, ``rel_pos_bias`` (T5-style
    buckets), ``macaron`` (a Scale(0.5) FF before each block),
    ``sandwich_coef`` (attention layers first, FF layers last),
    ``gate_residual`` (a GRUCell gate for the residual) and ``use_rezero``
    (no per-layer norms; each attention branch times a zero-init scalar)."""

    vocab_size: int = 30522
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 8
    max_length: int = 77
    mlp_ratio: int = 4
    dtype: str = "float32"
    causal: bool = False
    talking_heads: bool = False
    use_rmsnorm: bool = False
    use_scalenorm: bool = False
    rel_pos_bias: bool = False
    rel_pos_num_buckets: int = 32
    rel_pos_max_distance: int = 128
    macaron: bool = False
    sandwich_coef: int = 0
    gate_residual: bool = False
    use_rezero: bool = False

    @staticmethod
    def tiny(**kw) -> "TransformerTextConfig":
        return TransformerTextConfig(vocab_size=1000, hidden_size=64, num_layers=2,
                                     num_heads=4, **kw)

    @property
    def layer_types(self):
        """The ('a' | 'f', ...) execution plan."""
        default = ("f", "a", "f") if self.macaron else ("a", "f")
        sc = self.sandwich_coef
        if sc:
            if not 0 < sc <= self.num_layers:
                raise ValueError("sandwich coefficient should be less than the depth")
            return ("a",) * sc + default * (self.num_layers - sc) + ("f",) * sc
        return default * self.num_layers


def _init_norm(cfg, d, device):
    if cfg.use_scalenorm:
        return {"g": torch.ones(1, device=device)}
    return L.init_layer_norm(d, device)  # RMSNorm reads only "scale"


def _apply_norm(cfg, p, x, eps=1e-5):
    if cfg.use_scalenorm:
        xf = x.float()
        n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        return (xf / torch.clamp(n, min=eps) * p["g"]).to(x.dtype) * (x.shape[-1] ** 0.5)
    if cfg.use_rmsnorm:
        return _rms_norm(p["scale"], x, eps)
    return L.layer_norm(p, x)


def _init_gru_gate(gen, d, device):
    """GRUCell params in torch's layout: ``w_ih`` / ``w_hh`` [3d, d] and
    their biases, gates stacked (r, z, n)."""
    bound = 1.0 / math.sqrt(d)

    def u(shape):
        return torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)

    return {"w_ih": u((3 * d, d)), "w_hh": u((3 * d, d)), "b_ih": u((3 * d,)),
            "b_hh": u((3 * d,))}


def init_transformer_text(gen, cfg: TransformerTextConfig, device="cpu"):
    """Random encoder params (the JAX package's layout and distributions)
    from the ``torch.Generator`` ``gen``: one layer dict a
    ``cfg.layer_types`` entry."""
    d, h = cfg.hidden_size, cfg.num_heads

    def lin(i, o, bias=True):
        return L.init_linear(gen, i, o, bias=bias, device=device)

    params = {
        "token_embedding": _normal(gen, (cfg.vocab_size, d), 0.02, device),
        "position_embedding": _normal(gen, (cfg.max_length, d), 0.01, device),
        "layers": [],
        "final_ln": _init_norm(cfg, d, device),
    }
    if cfg.rel_pos_bias:
        params["rel_pos_embedding"] = _normal(gen, (cfg.rel_pos_num_buckets, h), 0.02, device)
    for kind in cfg.layer_types:
        if kind == "a":
            layer = {"ln": _init_norm(cfg, d, device), "q": lin(d, d, False),
                     "k": lin(d, d, False), "v": lin(d, d, False), "out": lin(d, d)}
            if cfg.talking_heads:
                for name in ("pre_softmax_proj", "post_softmax_proj"):
                    layer[name] = torch.eye(h, device=device) + _normal(gen, (h, h), 0.01,
                                                                          device)
            if cfg.use_rezero:
                layer["rezero_g"] = torch.zeros(1, device=device)
        else:
            layer = {"ln": _init_norm(cfg, d, device), "fc1": lin(d, d * cfg.mlp_ratio),
                     "fc2": lin(d * cfg.mlp_ratio, d)}
        if cfg.gate_residual:
            layer["gru"] = _init_gru_gate(gen, d, device)
        params["layers"].append(layer)
    return params


def transformer_text_apply(cfg: TransformerTextConfig, params, tokens: torch.Tensor):
    """Encode token ids [N, L] -> f32 [N, L, hidden_size] (the embeddings
    after the final norm)."""
    n, s = tokens.shape
    dtype = getattr(torch, cfg.dtype)
    table = params["token_embedding"]
    x = table[tokens.long().to(table.device)].to(dtype)
    x = x + params["position_embedding"][None, :s].to(dtype)
    dh = cfg.hidden_size // cfg.num_heads

    rel_bias = None
    if cfg.rel_pos_bias:
        pos = np.arange(s)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], num_buckets=cfg.rel_pos_num_buckets,
            max_distance=cfg.rel_pos_max_distance, bidirectional=not cfg.causal)
        rel_bias = params["rel_pos_embedding"][torch.from_numpy(buckets).to(x.device)]
        rel_bias = rel_bias.permute(2, 0, 1)  # [h, s, s]
    causal_mask = (torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
                   if cfg.causal else None)

    def attn_branch(p, y):
        q, k, v = (_split_heads(L.linear(p[name], y), cfg.num_heads) for name in "qkv")
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (dh ** -0.5)
        if "pre_softmax_proj" in p:  # talking heads: mix the logits across heads
            scores = torch.einsum("bhqk,hg->bgqk", scores, p["pre_softmax_proj"])
        if rel_bias is not None:
            scores = scores + rel_bias[None]
        if causal_mask is not None:
            scores = torch.where(causal_mask[None, None], scores, scores.new_tensor(-1e9))
        w = torch.softmax(scores, dim=-1)
        if "post_softmax_proj" in p:  # ...and the probabilities after it
            w = torch.einsum("bhqk,hg->bgqk", w, p["post_softmax_proj"])
        att = _merge_heads(torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v))
        return L.linear(p["out"], att)

    def ff_branch(p, y):
        out = L.linear(p["fc2"], L.gelu(L.linear(p["fc1"], y)))
        return out * 0.5 if cfg.macaron else out  # macaron FF layers are Scale(0.5)

    def residual_join(p, out, residual):
        if "gru" in p:  # GRUCell(input=out, hidden=residual), gates (r, z, n)
            g = p["gru"]
            i_r, i_z, i_n = (torch.matmul(out, g["w_ih"].T) + g["b_ih"]).chunk(3, dim=-1)
            h_r, h_z, h_n = (torch.matmul(residual, g["w_hh"].T) + g["b_hh"]).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            return (1.0 - z) * torch.tanh(i_n + r * h_n) + z * residual
        return out + residual

    for kind, p in zip(cfg.layer_types, params["layers"]):
        # ReZero replaces the per-layer norms with the identity
        y = x if cfg.use_rezero else _apply_norm(cfg, p["ln"], x)
        if kind == "a":
            out = attn_branch(p, y)
            if "rezero_g" in p:
                out = out * p["rezero_g"]
        else:
            out = ff_branch(p, y)
        x = residual_join(p, out, x)
    # the wrapper's final LayerNorm is unconditional: ReZero blanks only the
    # per-layer norms
    if cfg.use_rezero:
        return L.layer_norm(params["final_ln"], x).float()
    return _apply_norm(cfg, params["final_ln"], x).float()


def clip_t5_encode(clip_fn, t5_fn, text_tokens_clip, text_tokens_t5):
    """FrozenCLIPT5Encoder: both encodings, as a list [CLIP, T5]."""
    return [clip_fn(text_tokens_clip), t5_fn(text_tokens_t5)]
