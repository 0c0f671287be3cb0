"""Compute ops of the port, each with a hand-written CUDA kernel for Hopper
and a plain PyTorch twin:

  * :func:`attention` — softmax attention; KV > 128 goes through K1:
    bf16 with d <= 256 its TMA + wgmma body (``csrc/attention_sm90.cu``,
    :func:`attention_sm90`), bf16 with 256 < d <= 512 its wgmma body
    (``csrc/attention_bf16_wide_sm90.cu``, :func:`attention_bf16_wide_sm90`),
    f32 with d <= 160 its fused 3xTF32 body (``csrc/attention_f32_fused_sm90.cu``,
    :func:`attention_f32_fused_sm90`), f32 with 160 < d <= 512 its unfused
    3xTF32 body (``csrc/attention_f32_sm90.cu``, :func:`attention_f32_sm90`).
  * :func:`geglu_ff` — the transformer GEGLU MLP through K2, two TMA +
    wgmma GEMMs: bf16 ``csrc/geglu_ff_sm90.cu``, f32 (three TF32 products a
    product) ``csrc/geglu_ff_f32_sm90.cu``, :func:`geglu_ff_f32_sm90`.
  * :func:`group_norm` / :func:`group_norm_silu` — NHWC GroupNorm(+SiLU)
    through K3 (``csrc/groupnorm_sm90.cu``: whole groups a block by TMA, or
    statistics and apply kernels over bulk-copied pixel rows; plan
    :func:`group_norm_plan`); :func:`group_norm_silu_cat` over a virtual
    ``concat([a, b], -1)`` through K3's two-source form (the UNet's up-path
    ResBlocks: a slab of the virtual row's groups a block, or the split
    form; plan :func:`group_norm_cat_plan`).
  * :func:`conv3x3` — the 3x3 stride-1 conv through K4, for the convs
    ``models/layers.conv2d`` routes to it: Co <= 8 or C <= 16 through its
    narrow bodies (``csrc/conv3x3_narrow.cu``, :func:`conv3x3_narrow`), the
    other bf16 convs with C % 8 == 0 through its TMA + wgmma body
    (``csrc/conv3x3_sm90.cu``, :func:`conv3x3_sm90`), the other f32 convs
    with C % 4 == 0 through its 3xTF32 body (``csrc/conv3x3_f32_sm90.cu``,
    :func:`conv3x3_f32_sm90`), the rest through ``csrc/conv3x3.cu``.
  * :func:`self_attention_cm` and the kcanon route of :func:`attention` —
    attention over operands whose sequence axis is contiguous, through K5
    (wrapper :func:`attention_dmajor`): bf16 on its TMA + wgmma body
    (``csrc/attention_cm_sm90.cu``), f32 on its 3xTF32 body
    (``csrc/attention_cm_f32_sm90.cu``).
  * ``probes.winograd.wino3x3`` — the Winograd F(2x2,3x3) conv through K6,
    an opt-in probe that no layer dispatches: bf16 with C % 8 == 0 through
    its TMA + wgmma body (``csrc/winograd_sm90.cu``, ``wino3x3_sm90``), f32
    with C % 4 == 0 through its 3xTF32 body (``csrc/winograd_f32_sm90.cu``,
    ``wino3x3_f32_sm90``), any Co; the rest through ``csrc/winograd.cu``
    (``wino3x3_prior``).
  * ``probes.attention``, ``probes.groupnorm``, ``probes.stream`` — the
    probes of the TPU tuning scripts: K1's and K5's Hopper loops and the
    fused f32 body with pieces of the work removed (K7,
    ``csrc/probe_attention.cu``; its replaced loops
    ``csrc/probe_attention_prior.cu`` are ``attention_probe_prior``), K3's
    Hopper kernels in the scripts' forms (K8, ``csrc/probe_groupnorm.cu``;
    its replaced body ``csrc/probe_groupnorm_prior.cu`` is
    ``group_norm_probe_prior``) and a streaming copy
    by bulk copies (K9, ``csrc/probe_copy_sm90.cu``; its replaced body
    ``csrc/probe_copy.cu`` is ``stream_copy_prior``). No layer dispatches
    them.

A wrapper runs the plain twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises. The seven dispatch entries (``flash_attention``,
``attention_dmajor``, ``geglu_ff``, ``group_norm_nhwc``, ``group_norm_silu_cat``,
``conv3x3``, ``probes.winograd.wino3x3``) are differentiable: under grad their forward
is the kernel and their backward the VJP of the plain twin recomputed on
the saved inputs (``_build.kernel_with_plain_vjp``, the port of the JAX
package's ``custom_vjp`` rules); the backward launches no kernel. The
bodies under them, and the probes K7-K9, raise under grad mode when an
argument requires grad (``_build.refuse_grad``).
"""

from complex_prompt_diffusion_tpu_torch.ops.attention import (
    attention,
    attention_bf16_wide_sm90,
    attention_cm_f32_sm90_count,
    attention_cm_sm90_count,
    attention_dmajor,
    attention_f32_fused_sm90,
    attention_f32_sm90,
    attention_sm90,
    flash_attention,
    self_attention_cm,
)
from complex_prompt_diffusion_tpu_torch.ops.blur import gaussian_blur
from complex_prompt_diffusion_tpu_torch.ops.conv import (
    conv3x3,
    conv3x3_f32_sm90,
    conv3x3_narrow,
    conv3x3_sm90,
)
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    group_norm,
    group_norm_cat_slab_count,
    group_norm_nhwc,
    group_norm_plan,
    group_norm_silu,
    group_norm_silu_cat,
)
from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_ff, geglu_ff_f32_sm90
from complex_prompt_diffusion_tpu_torch.ops.probes.attention import attention_probe
from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import group_norm_probe
from complex_prompt_diffusion_tpu_torch.ops.probes.stream import stream_copy
from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
    wino3x3,
    wino3x3_f32_sm90,
    wino3x3_sm90,
)

# the wrapper of each kernel (or a count of its own where no wrapper function
# carries one), whose ``launches`` attribute counts launches;
# "attention" and "conv3x3" count every body of K1 and K4, "attention_sm90",
# "attention_f32_fused_sm90", "attention_f32_sm90", "attention_bf16_wide_sm90",
# "conv3x3_sm90" and "conv3x3_f32_sm90" their Hopper bodies alone; "geglu_ff"
# counts the kernels of both K2 bodies, "geglu_ff_f32_sm90" those of the f32
# one; "attention_cm" counts every K5 kernel,
# "attention_cm_sm90" those of its Hopper bodies (both dtypes),
# "attention_cm_f32_sm90" those of the f32 one (counts attention_dmajor keeps);
# "winograd" counts every K6 kernel, "winograd_sm90" and "winograd_f32_sm90"
# those of its bf16 and f32 Hopper bodies; "group_norm" counts every K3
# kernel, "group_norm_cat" those of its two-source form
KERNEL_WRAPPERS = {
    "attention": flash_attention,
    "attention_sm90": attention_sm90,
    "attention_f32_fused_sm90": attention_f32_fused_sm90,
    "attention_f32_sm90": attention_f32_sm90,
    "attention_bf16_wide_sm90": attention_bf16_wide_sm90,
    "geglu_ff": geglu_ff,
    "geglu_ff_f32_sm90": geglu_ff_f32_sm90,
    "group_norm": group_norm_nhwc,
    "group_norm_cat": group_norm_silu_cat,
    "group_norm_cat_slab": group_norm_cat_slab_count,
    "conv3x3": conv3x3,
    "conv3x3_sm90": conv3x3_sm90,
    "conv3x3_f32_sm90": conv3x3_f32_sm90,
    "conv3x3_narrow": conv3x3_narrow,
    "attention_cm": attention_dmajor,
    "attention_cm_sm90": attention_cm_sm90_count,
    "attention_cm_f32_sm90": attention_cm_f32_sm90_count,
    "winograd": wino3x3,
    "winograd_sm90": wino3x3_sm90,
    "winograd_f32_sm90": wino3x3_f32_sm90,
    "probe_attention": attention_probe,
    "probe_groupnorm": group_norm_probe,
    "probe_copy": stream_copy,
}

__all__ = [
    "attention",
    "flash_attention",
    "attention_sm90",
    "attention_f32_fused_sm90",
    "attention_f32_sm90",
    "attention_bf16_wide_sm90",
    "attention_dmajor",
    "attention_cm_sm90_count",
    "attention_cm_f32_sm90_count",
    "self_attention_cm",
    "wino3x3",
    "wino3x3_sm90",
    "wino3x3_f32_sm90",
    "attention_probe",
    "group_norm_probe",
    "stream_copy",
    "conv3x3",
    "conv3x3_sm90",
    "conv3x3_f32_sm90",
    "conv3x3_narrow",
    "geglu_ff",
    "geglu_ff_f32_sm90",
    "group_norm",
    "group_norm_silu",
    "group_norm_silu_cat",
    "group_norm_cat_slab_count",
    "group_norm_nhwc",
    "group_norm_plan",
    "gaussian_blur",
    "KERNEL_WRAPPERS",
]
