"""Compute ops of the port, each with a hand-written CUDA kernel for Hopper
and a plain PyTorch twin:

  * :func:`attention` — softmax attention; KV > 128 goes through K1
    (``csrc/attention.cu``).
  * :func:`geglu_ff` — the transformer GEGLU MLP through K2
    (``csrc/geglu_ff.cu``).
  * :func:`group_norm` / :func:`group_norm_silu` — NHWC GroupNorm(+SiLU)
    through K3 (``csrc/groupnorm.cu``).
  * :func:`conv3x3` — the 3x3 stride-1 conv through K4
    (``csrc/conv3x3.cu``), for the convs ``models/layers.conv2d`` routes to it.
  * :func:`self_attention_cm` and the kcanon route of :func:`attention` —
    attention over operands whose sequence axis is contiguous, through K5
    (``csrc/attention_cm.cu``, wrapper :func:`attention_dmajor`).
  * ``probes.winograd.wino3x3`` — the Winograd F(2x2,3x3) conv through K6
    (``csrc/winograd.cu``), an opt-in probe that no layer dispatches.

A wrapper runs the plain twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises.
"""

from complex_prompt_diffusion_tpu_torch.ops.attention import (
    attention,
    attention_dmajor,
    flash_attention,
    self_attention_cm,
)
from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    group_norm,
    group_norm_nhwc,
    group_norm_silu,
)
from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_ff
from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import wino3x3

# the wrapper of each kernel, whose ``launches`` attribute counts launches
KERNEL_WRAPPERS = {
    "attention": flash_attention,
    "geglu_ff": geglu_ff,
    "group_norm": group_norm_nhwc,
    "conv3x3": conv3x3,
    "attention_cm": attention_dmajor,
    "winograd": wino3x3,
}

__all__ = [
    "attention",
    "flash_attention",
    "attention_dmajor",
    "self_attention_cm",
    "wino3x3",
    "conv3x3",
    "geglu_ff",
    "group_norm",
    "group_norm_silu",
    "group_norm_nhwc",
    "KERNEL_WRAPPERS",
]
